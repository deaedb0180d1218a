"""What each rank of the sequence-parallel training test runs (spawned by
``repro_torch.launch.mesh.run_ranks``, so importable and free of JAX): the
split ``Trainer`` under the train rules (``act_seq_sp`` onto ``"model"``)
and with ``act_seq_sp`` mapped to None, the attention-only prefill under
``rules_for`` and with the same mapping, and the gradient-accumulation and
compression cases of the split trainer, returning numpy results for the
test process to hold."""
from __future__ import annotations
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)

import dataclasses
from unittest import mock

import numpy as np
import torch
from torch_train_ranks import OPT, run_steps, smoke_f32

from repro_torch.convert import tree_to_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_prefill_step, rules_for
from repro_torch.models.model import EDGE_SAVES, model_specs, serve_params
from repro_torch.models.params import VIEW_GRADS, init_params, tree_leaves, \
    view_shape
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.collectives import COLLECTIVES
from repro_torch.sharding.rules import make_rules
from repro_torch.train import optimizer as _opt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer

NO_SP = {"act_seq_sp": None}


def _trainer(cfg, mesh, tmp: str, overrides=None, **tcfg) -> Trainer:
    rules = make_rules(mesh, "train", {**cfg.sharding_overrides.get(
        "train", {}), **(overrides or {})})
    return Trainer(cfg, TrainConfig(steps=4, ckpt_dir=tmp,
                                    opt=AdamWConfig(**OPT), **tcfg),
                   mesh=mesh, rules=rules, device="cpu")


def _residual_modes() -> dict:
    return {m: n for (k, m), n in tp.MODES.items() if k == "residual"}


def sp_run(cfg, mesh, batches, tmp: str, overrides=None) -> dict:
    """The split trainer on ``batches`` from the seeded init -> each
    step's loss and the gradient blocks AdamW got, the blocks after the
    last step, the residual modes, what remat saved at the units' edges,
    the most view-gradient bytes held at once (and the largest unit's, the
    tied table's view, all views') and the collectives by kind a step."""
    tr = _trainer(cfg, mesh, tmp, overrides)
    state = tr.init_state(torch.Generator().manual_seed(4))
    grads, update = [], _opt.update

    def spy(opt_cfg, g, *a, **kw):
        grads.append([t.clone().numpy() for t in tree_leaves(g)])
        return update(opt_cfg, g, *a, **kw)

    tp.MODES.clear()
    EDGE_SAVES.reset()
    COLLECTIVES.clear()
    peaks = []
    losses = []
    with mock.patch.object(_opt, "update", spy):
        for b in batches:
            *state, m = tr._step(*state, tr._device_batch(b))
            losses.append(float(m["loss"]))
            peaks.append((VIEW_GRADS.peak, VIEW_GRADS.largest_unit))
    kinds = {}
    for op, _, _ in COLLECTIVES:
        kinds[op] = kinds.get(op, 0) + 1

    def view_bytes(pl, lp):     # float32 configs: 4 bytes an entry
        return 4 * int(np.prod(view_shape(pl, mesh, lp.whole)))

    total = sum(view_bytes(pl, lp) for pl, lp in zip(
        tree_leaves(tr.placements), tree_leaves(tr.plan)))
    tied = view_bytes(tr.placements["embed"]["tok"],
                      tr.plan["embed"]["tok"]) if cfg.tie_embeddings else 0
    return {"loss": losses, "grads": grads,
            "params": [t.numpy().copy() for t in tree_leaves(state[0])],
            "residual": _residual_modes(), "edges": list(EDGE_SAVES.shapes),
            "view_peak": [p for p, _ in peaks],
            "largest_unit": [u for _, u in peaks], "tied_view": tied,
            "all_views": total,
            "collectives": {k: v / len(batches) for k, v in kinds.items()}}


def sp_case(case: dict, batches, tmp: str) -> dict:
    """``case`` with ``act_seq_sp`` (the train rules) and mapped to None."""
    cfg = dataclasses.replace(smoke_f32(case["arch"]), **case.get("cfg", {}))
    mesh = make_host_mesh(case["shape"])
    return {"sp": sp_run(cfg, mesh, batches, f"{tmp}/{case['name']}/sp"),
            "none": sp_run(cfg, mesh, batches, f"{tmp}/{case['name']}/none",
                           NO_SP)}


def prefill_case(arch: str, tokens, shape) -> dict:
    """The attention-only prefill under ``rules_for`` (``act_seq_sp``
    onto ``"model"``) and with ``act_seq_sp`` mapped to None, on this
    rank's serve weights from a seeded whole tree: logits, the rank's
    cache block, the residual modes."""
    cfg = smoke_f32(arch)
    mesh = make_host_mesh(shape)
    whole = init_params(model_specs(cfg, serve=True),
                        torch.Generator().manual_seed(7), "cpu")
    sp = rules_for(cfg, mesh, "prefill")
    none = make_rules(mesh, "serve", {**cfg.sharding_overrides.get(
        "serve", {}), **NO_SP})
    out = {}
    for name, rules in (("sp", sp), ("none", none)):
        tp.MODES.clear()
        with torch.no_grad():
            logits, cache = make_prefill_step(cfg, rules)(
                serve_params(cfg, whole, rules), {"tokens": torch.from_numpy(
                    tokens)})
        out[name] = {"logits": logits.numpy(), "cache": tree_to_numpy(cache),
                     "residual": _residual_modes()}
    return out


def accum_case(case: dict, batches, tmp: str) -> dict:
    """A re-anchor case: the split trainer with ``case["tcfg"]`` (grad
    accumulation, compression) from the seeded init -> losses, gradient
    norms, the whole parameters after the last step (rank 0)."""
    cfg = smoke_f32(case["arch"])
    mesh = make_host_mesh(case["shape"])
    tr = _trainer(cfg, mesh, f"{tmp}/{case['name']}", **case["tcfg"])
    state = tr.init_state(torch.Generator().manual_seed(4))
    wholes = []
    _, losses, norms = run_steps(tr, state, batches, wholes)
    out = {"loss": losses, "grad_norm": norms}
    if torch.distributed.get_rank() == 0:
        out["params"] = wholes[-1]["params"]
    return out


def world(sp_cases, sp_batches, whole_case, whole_batches, prefills,
          accum_cases, accum_batches, tmp: str) -> dict:
    """The 4-rank world: every case of both mesh shapes in turn."""
    return {"sp": {c["name"]: sp_case(c, sp_batches[c["arch"]], tmp)
                   for c in sp_cases},
            "whole": sp_run(smoke_f32(whole_case["arch"]),
                            make_host_mesh(whole_case["shape"]),
                            whole_batches, f"{tmp}/whole"),
            "prefill": {a: prefill_case(a, tokens, shape)
                        for a, (tokens, shape) in prefills.items()},
            "accum": {c["name"]: accum_case(c, accum_batches[c["arch"]], tmp)
                      for c in accum_cases}}
