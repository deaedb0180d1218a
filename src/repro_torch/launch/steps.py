"""Train / prefill / serve step builders: port of the step half of
``repro/launch/steps.py`` (``SHAPES``, ``make_train_step``,
``make_prefill_step``, ``make_serve_step``, ``applicable_shapes``).

The reference's builders return functions to jit under sharding ``rules``,
which GSPMD splits over a mesh; the port's run eagerly on one device, so
``rules`` must be None.  Training across ranks is the ``Trainer``'s
(``Trainer(cfg, tcfg, mesh=, rules=)``: storage split by the rules,
compute data-parallel over ``"data"`` and tensor-parallel over
``"model"``); a prefill or serve step under the serve rules (the decode
cache split by sequence over ``"model"``) is ROADMAP queue A.16e, and the
production meshes A.17.  The shape-spec half
(``rules_for``, ``batch_specs``, ``params_specs``, ``cache_input_specs``,
``opt_state_specs``, ``input_specs``, ``step_for``) serves the dry-run
launchers and comes with them (ROADMAP A.17).
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
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


def _no_rules(rules) -> None:
    if rules is not None:
        raise NotImplementedError(
            "sharding rules: the port's step builders run on one device; "
            "train across ranks with Trainer(mesh=, rules=), tensor-"
            "parallel over \"model\" (ROADMAP A.16d); prefill and serve "
            "steps under the serve rules are ROADMAP queue A.16e, the "
            "production meshes A.17")


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
    _no_rules(rules)
    ctx = Ctx(cfg=cfg, mode="prefill", force=force)

    def prefill_step(params, batch):
        return prefill(ctx, params, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig, rules, *, force: str = "auto"):
    _no_rules(rules)
    ctx = Ctx(cfg=cfg, mode="decode", force=force)

    def serve_step(params, cache, batch):
        return decode_step(ctx, params, cache, batch)

    return serve_step


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k only for sub-quadratic archs."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out
