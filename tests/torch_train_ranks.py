"""What each rank of a training-across-ranks test runs (spawned by
``repro_torch.launch.mesh.run_ranks``, so importable and free of JAX): the
port's ``Trainer`` over a ``("data", "model")`` mesh from numpy parameters,
``compressed_allreduce`` and the GPipe ``pipeline``, returning numpy
results for the test process to hold against the JAX reference."""
from __future__ import annotations
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)

import dataclasses

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_numpy, tree_to_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.params import block_shape, block_start, \
    gather_leaf, shard_leaf, tree_leaves, tree_map
from repro_torch.runtime.cluster import FailureInjector, elastic_remesh
from repro_torch.sharding.collectives import barrier, psum_ordered, \
    shard_index
from repro_torch.sharding.pipeline import pipeline, split_stages
from repro_torch.train import optimizer as _opt
from repro_torch.train.compression import compressed_allreduce
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import NodeFailure, TrainConfig, Trainer

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)


def smoke_f32(arch: str):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")


def trainer(cfg, mesh, ckpt_dir: str, **kw) -> Trainer:
    return Trainer(cfg, TrainConfig(steps=4, ckpt_dir=ckpt_dir,
                                    opt=AdamWConfig(**OPT), **kw),
                   mesh=mesh, device="cpu")


def state_from_numpy(tr: Trainer, params_np):
    """This rank's blocks of whole numpy parameters, zero moments (and
    zero error buffers where the trainer compresses)."""
    full = model_params_from_numpy(params_np, tr.cfg, "cpu")
    params = full if tr.mesh is None else tree_map(
        lambda t, pl: shard_leaf(t, pl, tr.mesh), full, tr.placements)
    err = tree_map(lambda p: torch.zeros_like(p), params) \
        if tr.tcfg.grad_compression else None
    return params, _opt.init(params), err


def gather(tr: Trainer, tree):
    """The whole leaves of a tree of this rank's blocks (a collective
    call); without a mesh, ``tree`` itself."""
    if tr.mesh is None:
        return tree
    return tree_map(lambda blk, pl: gather_leaf(blk, pl, tr.mesh), tree,
                    tr.placements)


def whole_state(tr: Trainer, state) -> dict:
    """The whole parameters and moments (numpy), gathered from the
    blocks: a collective call."""
    params, opt_state, _ = state
    return {"params": tree_to_numpy(gather(tr, params)),
            "mu": tree_to_numpy(gather(tr, opt_state.mu)),
            "nu": tree_to_numpy(gather(tr, opt_state.nu))}


def run_steps(tr: Trainer, state, batches, wholes=None) -> tuple:
    """``Trainer._step`` over global numpy batches -> (state, losses,
    gradient norms); ``wholes``: a list that gets the whole state after
    each step."""
    losses, norms = [], []
    for b in batches:
        *state, m = tr._step(*state, tr._device_batch(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if wholes is not None:
            wholes.append(whole_state(tr, state))
    return tuple(state), losses, norms


def blocks_of(tr: Trainer) -> dict:
    """{leaf path: (start, shape)} of this rank's block of every
    parameter leaf."""
    return {path: (block_start(pl, tr.mesh), block_shape(pl, tr.mesh))
            for path, pl in _flatten(tr.placements)}


def train_case(case: dict, params_np, batches, tmp: str) -> dict:
    """One training case on a host mesh of ``case["shape"]``: the losses,
    norms, block layout and (rank 0) the final whole state."""
    mesh = make_host_mesh(case["shape"])
    tr = trainer(smoke_f32(case["arch"]), mesh, f"{tmp}/{case['name']}",
                 **case.get("tcfg", {}))
    wholes = []
    _, losses, norms = run_steps(tr, state_from_numpy(tr, params_np),
                                 batches, wholes)
    out = {"loss": losses, "grad_norm": norms, "blocks": blocks_of(tr)}
    if torch.distributed.get_rank() == 0:
        out["whole"] = wholes
    return out


def allreduce_rows(g_np) -> np.ndarray:
    """``compressed_allreduce`` of row r of ``g_np`` on rank r, over a
    (D, 1) mesh's ``"data"``."""
    mesh = make_host_mesh((g_np.shape[0], 1))
    g = torch.from_numpy(g_np[shard_index(mesh, "data")])
    return compressed_allreduce(g, mesh).numpy()


def failure_case(params_np, batches, tmp: str) -> dict:
    """At (2, 2): the uninterrupted run of ``len(batches)`` steps (its
    whole state after step 2 and its losses), then a run from the same
    state that checkpoints every 2 steps and loses a node at step 3."""
    cfg = smoke_f32("qwen1.5-0.5b")
    mesh = make_host_mesh((2, 2))
    full = trainer(cfg, mesh, f"{tmp}/unused")
    state, losses, _ = run_steps(full, state_from_numpy(full, params_np),
                                 batches[:2])
    at2 = whole_state(full, state)
    state, more, _ = run_steps(full, state, batches[2:])
    tr = Trainer(cfg, TrainConfig(steps=4, ckpt_every=2, log_every=1,
                                  ckpt_dir=f"{tmp}/failure",
                                  opt=AdamWConfig(**OPT)),
                 mesh=mesh, device="cpu",
                 failure_injector=FailureInjector({3: "node lost"}))
    try:
        tr.run(iter(batches), state=state_from_numpy(tr, params_np))
        failed = None
    except NodeFailure as e:
        failed = str(e)
    return {"losses": losses + more, "at2": at2, "failed": failed,
            "failed_step": tr.step, "ckpt_step": tr.ckpt.latest_step()}


def survivor_restart(params_np, batches, tmp: str, n_alive: int) -> dict:
    """A new world of the survivors: the ``elastic_remesh(n_alive)`` mesh,
    the checkpoint restored onto it (its whole state) and the remaining
    steps' losses."""
    cfg = smoke_f32("qwen1.5-0.5b")
    mesh = elastic_remesh(n_alive, prefer="model")
    tr = Trainer(cfg, TrainConfig(steps=4, ckpt_every=100, log_every=1,
                                  ckpt_dir=f"{tmp}/failure",
                                  opt=AdamWConfig(**OPT)),
                 mesh=mesh, device="cpu")
    state = tr.maybe_restore(tr.init_state())
    restored = whole_state(tr, state)
    step = tr.step
    _, hist = tr.run(iter(batches[step:]), n_steps=len(batches) - step,
                     state=state)
    return {"shape": tuple(mesh.shape), "step": step, "restored": restored,
            "losses": [h["loss"] for h in hist],
            "steps": [h["step"] for h in hist]}


def gathered_init(arch: str, shape, seed: int, tmp: str) -> dict:
    """The trainer's seeded ``init_state`` on a host mesh, gathered."""
    tr = trainer(smoke_f32(arch), make_host_mesh(shape), tmp)
    params = tr.init_state(torch.Generator().manual_seed(seed))[0]
    return tree_to_numpy(gather(tr, params))


def world(params_np: dict, batches: dict, cases, g_np, tmp: str) -> dict:
    """Everything a 4-rank world of the training test runs, in order: the
    training cases (their first steps of ``batches[arch]``), the
    compressed all-reduce, the run that fails."""
    out = {"cases": {c["name"]: train_case(
        c, params_np[c["arch"]], batches[c["arch"]][:2], tmp)
        for c in cases}}
    out["allreduce"] = allreduce_rows(g_np)
    out["failure"] = failure_case(params_np["qwen1.5-0.5b"],
                                  batches["qwen1.5-0.5b"], tmp)
    return out


def ordered_sum(x_np) -> np.ndarray:
    """``psum_ordered`` of row r of ``x_np`` on rank r over a (D, 1) mesh's
    ``"data"``, after a ``barrier`` of the mesh."""
    mesh = make_host_mesh((x_np.shape[0], 1))
    barrier(mesh)
    return psum_ordered(torch.from_numpy(x_np[shard_index(mesh, "data")]),
                        mesh).numpy()


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
def layer(w, b, x):
    return torch.tanh(x @ w + b)


def stage_fn(params, x):
    ws, bs = params
    for w, b in zip(ws, bs):
        x = layer(w, b, x)
    return x


def pipeline_rank(w_np, b_np, xs_np, n_stages: int) -> np.ndarray:
    """The GPipe pipeline over a 1-D ``"stage"`` mesh of every rank: this
    rank's stage of ``split_stages`` and the microbatches -> outputs."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", list(range(n_stages)),
                      mesh_dim_names=("stage",))
    w, b = split_stages([torch.from_numpy(w_np), torch.from_numpy(b_np)],
                        n_stages)
    s = shard_index(mesh, "stage")
    fn = pipeline(stage_fn, mesh, axis="stage")
    return fn((w[s], b[s]), torch.from_numpy(xs_np)).numpy()


def cuda_rank_losses(batches, tmp: str) -> list:
    """One of the gloo ranks sharing the card: Qwen1.5-0.5B SMOKE (bf16)
    at mesh (2, 1) from the seeded init, its losses over ``batches``."""
    dev = torch.device("cuda")
    tr = Trainer(get_smoke_config("qwen1.5-0.5b"),
                 TrainConfig(steps=len(batches), ckpt_dir=tmp,
                             opt=AdamWConfig(**OPT)),
                 mesh=make_host_mesh((2, 1)), device=dev)
    state = tr.init_state(torch.Generator(dev).manual_seed(0))
    _, losses, _ = run_steps(tr, state, batches)
    return losses


def checkpoint_roundtrip(device: str, tmp: str) -> dict:
    """Qwen1.5-0.5B SMOKE at mesh (D, 1) over every rank, on ``device``:
    one step from the seeded init, its state saved three times over the
    same step (each save replaces the last), then a fresh trainer on the
    same mesh restores it -> whether every restored block equals the
    saved one bit for bit, the restored step and the manifest's ranks."""
    dev = torch.device(device)
    if dev.type == "cuda":      # this rank's card (NCCL: one rank a card)
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_smoke_config("qwen1.5-0.5b")
    mesh = make_host_mesh((dist.get_world_size(), 1))
    tcfg = TrainConfig(steps=1, ckpt_dir=tmp, opt=AdamWConfig(**OPT))
    tr = Trainer(cfg, tcfg, mesh=mesh, device=dev)
    state = tr.init_state(torch.Generator(dev).manual_seed(0))
    batch = next(iter(TokenPipeline(cfg.vocab_size, 64, 8, seed=3)))
    *state, _ = tr._step(*state, tr._device_batch(batch))
    tr.step = 1
    for _ in range(3):
        path = tr.save(state)
    back = Trainer(cfg, tcfg, mesh=mesh, device=dev)
    restored = back.maybe_restore(
        back.init_state(torch.Generator(dev).manual_seed(1)))
    leaves = lambda s: tree_leaves(s[0]) + tree_leaves(s[1].mu) + \
        tree_leaves(s[1].nu)
    same = all(torch.equal(a, b)
               for a, b in zip(leaves(state), leaves(restored)))
    with open(os.path.join(path, "manifest.json")) as f:
        ranks = json.load(f)["ranks"]
    return {"same": same, "step": back.step, "ranks": ranks}
