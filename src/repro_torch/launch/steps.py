"""Train / prefill / serve step builders: port of the step half of
``repro/launch/steps.py`` (``SHAPES``, ``rules_for``, ``make_train_step``,
``make_prefill_step``, ``make_serve_step``, ``applicable_shapes``).

The reference's builders return functions to jit under sharding ``rules``,
which GSPMD splits over a mesh.  The port's prefill and serve steps run
eagerly on the ranks of a ``DeviceMesh`` (``launch/mesh.py``
``run_ranks``) under ``rules_for(cfg, mesh, kind)``, or on one device with
``rules=None``.  Under the serve rules a rank passes its ``"data"`` share
of the rows, its weights from ``model.serve_params`` and its block of the
cache (the K/V by sequence over ``"model"``, the recurrent states by
channel; ``model.cache_placements``, ``convert.cache_from_numpy(...,
placements=, mesh=)``), and gets the logits whole over the vocab.  The
train step builder runs on one device (``rules`` None): training across
ranks is the ``Trainer``'s (``Trainer(cfg, tcfg, mesh=, rules=)``), and
the production meshes are ROADMAP A.17.  The shape-spec half
(``batch_specs``, ``params_specs``, ``cache_input_specs``,
``opt_state_specs``, ``input_specs``, ``step_for``) serves the dry-run
launchers and comes with them (ROADMAP A.17).
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import ShardingRules, make_rules
from repro_torch.models.layers import Ctx
from repro_torch.models.model import decode_step, prefill
from repro_torch.train.optimizer import AdamWConfig, AdamWState
from repro_torch.train.optimizer import update as adamw_update
from repro_torch.train.trainer import grads_of

# The assigned input-shape sets (LM family): seq_len x global_batch.
SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}


def rules_for(cfg: ModelConfig, mesh, kind: str) -> ShardingRules:
    """The rule table of a step ``kind`` (train | prefill | decode) on
    ``mesh``: the train rules for training, the serve rules otherwise,
    each with the config's ``sharding_overrides`` of its mode.  An
    attention-only prefill also maps ``act_seq_sp`` onto ``"model"`` (the
    reference's sequence-parallel residual at layer boundaries): between
    two layer-pattern units each rank holds its range of the sequence
    (``models/model.py``), which changes no numbers."""
    mode = "train" if kind == "train" else "serve"
    overrides = dict(cfg.sharding_overrides.get(mode, {}))
    if kind == "prefill" and cfg.ssm is None and cfg.rglru is None:
        overrides.setdefault("act_seq_sp", "model")
    return make_rules(mesh, mode, overrides)


def _no_rules(rules) -> None:
    if rules is not None:
        raise NotImplementedError(
            "sharding rules: the port's train step runs on one device; "
            "train across ranks with Trainer(mesh=, rules=), tensor-"
            "parallel over \"model\" (ROADMAP A.16d); the production "
            "meshes are ROADMAP A.17")


def _serve_ctx(cfg: ModelConfig, rules, mode: str, force: str) -> Ctx:
    """A step's context: one device without rules, else the rules' mesh."""
    if rules is None:
        return Ctx(cfg=cfg, mode=mode, force=force)
    if rules.mesh is None:
        raise ValueError("serve rules without a mesh: make them with "
                         "rules_for(cfg, mesh, kind)")
    return Ctx(cfg=cfg, mode=mode, force=force, mesh=rules.mesh,
               rules=rules)


def make_train_step(cfg: ModelConfig, rules, opt_cfg: AdamWConfig, *,
                    force: str = "auto"):
    """-> train_step(params, opt_state, batch) -> (new params, new state,
    metrics): the loss's gradient and one AdamW update, new tensors (the
    inputs are left as they were)."""
    _no_rules(rules)
    ctx = Ctx(cfg=cfg, mode="train", force=force)

    def train_step(params, opt_state: AdamWState, batch):
        loss, metrics, grads = grads_of(ctx, params, batch)
        new_params, new_opt, opt_metrics = adamw_update(opt_cfg, grads,
                                                        opt_state, params)
        return new_params, new_opt, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig, rules, *, force: str = "auto"):
    """-> prefill_step(params, batch) -> (logits (B, V) float32 of the last
    position, the cache).  With ``rules`` (``rules_for(cfg, mesh,
    "prefill")``), a rank's step: its rows, its serve weights, and the
    rank's block of the emitted cache."""
    ctx = _serve_ctx(cfg, rules, "prefill", force)

    def prefill_step(params, batch):
        return prefill(ctx, params, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig, rules, *, force: str = "auto"):
    """-> serve_step(params, cache, batch) -> (logits (B, V) float32, the
    cache, written in place).  With ``rules`` (``rules_for(cfg, mesh,
    "decode")``), a rank's step on its block of the cache."""
    ctx = _serve_ctx(cfg, rules, "decode", force)

    def serve_step(params, cache, batch):
        return decode_step(ctx, params, cache, batch)

    return serve_step


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k only for sub-quadratic archs."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out
