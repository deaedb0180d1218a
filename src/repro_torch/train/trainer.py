"""Training loop: port of ``repro/train/trainer.py`` — checkpoint/restart,
failure recovery, gradient accumulation, optional int8 error-feedback
gradient compression, on one device or across the ranks of a
``("data", "model")`` ``DeviceMesh``.

The reference jits a step that GSPMD shards over ``mesh`` and ``rules``;
the port runs the same step eagerly: autograd of
:func:`~repro_torch.models.model.loss_fn` (the attention kernel's backward
kernel on the card, remat by ``torch.utils.checkpoint``), then AdamW.  The
parameters are float32 masters (the reference's ``init_params`` dtype)
that the loss casts to the compute dtype.  The step updates the parameters
and the optimizer's moments in place, where the reference donates them to
its jitted step.

Across ranks (``mesh``; ``rules`` default to ``make_rules(mesh, "train",
cfg.sharding_overrides["train"])``):

* storage follows the rules on both mesh dims: the masters, AdamW's
  moments and the error-feedback buffers are each rank's blocks of the
  leaves (``params.shardings``), drawn whole on every rank from the seeded
  generator and cut;
* compute is data-parallel over ``"data"`` and tensor-parallel over
  ``"model"``: each layer gathers its weights over ``"data"`` just before
  it runs, in the dtype the loss reads them in (``MeshLeaf``: no step
  gathers the whole tree, at most one layer's copy is alive), and splits
  its products over ``"model"`` by heads, MLP columns, experts, SSM and
  RG-LRU channels and vocab, with rank-ordered partial sums
  (``models/model.py``, ``sharding/tensor_parallel.py``).  The forward and
  backward run on this rank's rows of the global batch (its loss is its
  share of the global loss, ``Ctx.mesh``); the gradient of each leaf's
  compute view is summed over ``"model"`` in rank order where a rank's is
  partial (a leaf read whole inside a split region, ``LeafPlan.partial``),
  then in float32 over ``"data"`` in rank order (``psum_ordered``: two
  runs of one world give the same bits), and the rank keeps its block;
  the global norm, the compression's absmax and AdamW then work on
  blocks;
* checkpoints are sharded: each rank writes its blocks, and a restore onto
  any mesh (a survivor mesh after a ``NodeFailure``) assembles each new
  block from the blocks on disk.

The prefill and serve steps under the serve rules (the decode cache split
by sequence over ``"model"``) are ``launch/steps.py``'s; the training
half's sequence-parallel residual and a gradient reduced a layer at a time
are ROADMAP queue A.16e.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.models.layers import Ctx
from repro_torch.models.model import loss_fn, model_plan, model_specs
from repro_torch.models.params import (
    MeshLeaf,
    axis_block,
    init_params,
    leaf_dtype,
    shardings,
    tree_leaves,
    tree_map,
)
from repro_torch.sharding.collectives import psum_ordered, shard_count, \
    shard_index
from repro_torch.sharding.rules import make_rules
from repro_torch.train import optimizer as _opt
from repro_torch.train.compression import ef_compress_grads
from repro_torch.train.optimizer import AdamWConfig, AdamWState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "results/ckpt"
    ckpt_keep: int = 3
    log_every: int = 10
    grad_compression: bool = False
    grad_accum: int = 1   # microbatches per step (activation-memory knob)
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    seed: int = 0


class NodeFailure(RuntimeError):
    """Raised by the failure injector to simulate a node loss mid-run."""


def grads_of(ctx: Ctx, params, batch):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``: autograd
    through detached leaves (the stored parameters need no grad flag), a
    zero gradient for a leaf the loss does not read."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(ctx, leaves, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                     allow_unused=True))

    def fill(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_map(fill, leaves)


def _default_positions(v) -> bool:
    """Host positions equal to the model's own (``arange(S)`` broadcast)."""
    if isinstance(v, torch.Tensor):
        if v.is_cuda:
            return False        # no host sync to find out
        v = v.numpy()
    v = np.asarray(v)
    return np.array_equal(v, np.broadcast_to(np.arange(v.shape[-1]),
                                             v.shape))


TRAIN_MESH_DIMS = ("data", "model")


class Trainer:
    def __init__(self, cfg, tcfg: TrainConfig, mesh=None, rules=None,
                 failure_injector=None, *, device="cuda",
                 force: str = "auto"):
        """``device`` (default ``cuda``) holds this rank's state and runs
        its steps; ``force`` pins the kernels as on every wrapper.
        ``mesh``: a ``DeviceMesh`` with dims ``("data", "model")`` to train
        across its ranks (a collective: every rank builds its trainer);
        ``rules`` without a mesh raises."""
        if mesh is not None:
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch.distributed "
                                f"DeviceMesh, got {type(mesh).__name__}")
            if tuple(mesh.mesh_dim_names or ()) != TRAIN_MESH_DIMS:
                raise ValueError(f"the trainer's mesh has dims "
                                 f"{TRAIN_MESH_DIMS}, got "
                                 f"{mesh.mesh_dim_names}")
            if rules is None:
                rules = make_rules(mesh, "train",
                                   cfg.sharding_overrides.get("train"))
        elif rules is not None:
            raise ValueError("Trainer: sharding rules need a mesh")
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.rules = rules
        self.device = resolve_device(device)
        self.ctx = Ctx(cfg=cfg, mode="train", force=force, mesh=mesh,
                       rules=rules)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.failure_injector = failure_injector
        self.specs = model_specs(cfg)
        self.placements = self.plan = None
        if mesh is not None:
            self.placements = shardings(self.specs, mesh, rules)
            for pl in tree_leaves(self.placements):
                if any(len(axes) > 1 for axes in pl.dims):
                    raise ValueError(f"a leaf of {pl.shape} has a dim split "
                                     f"by several mesh dims: {pl.dims}")
            self.plan = model_plan(cfg, rules)
        self.step = 0

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None):
        """-> (float32 parameters drawn from ``generator`` (a generator on
        the trainer's device; default seeded with ``tcfg.seed``), AdamW
        state, error-feedback buffers (zeros; None without compression)),
        each leaf this rank's block on a mesh."""
        gen = generator if generator is not None else \
            torch.Generator(self.device).manual_seed(self.tcfg.seed)
        params = init_params(self.specs, gen, self.device,
                             placements=self.placements, mesh=self.mesh)
        err = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params) if self.tcfg.grad_compression else None
        return params, _opt.init(params), err

    def _grads(self, params, batch):
        """(loss, metrics, grads) of this rank's loss share: on one device
        :func:`grads_of`; on a mesh the gradient of each leaf's compute
        view (its ``"model"`` block, or the whole leaf where its plan reads
        it whole, whole over ``"data"``), in the dtype the loss reads it
        in, each layer gathered inside the forward (``MeshLeaf``)."""
        if self.mesh is None:
            return grads_of(self.ctx, params, batch)
        dt = self.ctx.compute_dtype
        leaves = tree_map(lambda spec, blk, pl, lp: MeshLeaf.new(
            blk, pl, self.mesh, leaf_dtype(spec, dt), lp.whole),
            self.specs, params, self.placements, self.plan)
        loss, metrics = loss_fn(self.ctx, leaves, batch)
        sinks = [leaf.sink for leaf in tree_leaves(leaves)]
        grads = iter(torch.autograd.grad(loss, sinks, materialize_grads=True))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            tree_map(lambda _: next(grads), leaves)

    def _reduce(self, grads, loss, metrics):
        """The rank's gradients of its loss share -> its blocks of the
        global gradient: a partial gradient summed over ``"model"`` (in
        rank order, each part cut to the rank's ``"model"`` block), a whole
        one cut to it, then the float32 sum over ``"data"`` in rank order
        cut to the rank's block; the loss and metrics summed over
        ``"data"``."""
        mesh = self.mesh

        def reduce(g, pl, lp):
            g = g.float()
            if lp.partial:
                g = psum_ordered(g, mesh, "model", take=lambda t: axis_block(
                    t, pl, mesh, "model"))
            elif lp.whole:
                g = axis_block(g, pl, mesh, "model")
            return psum_ordered(g, mesh, "data", take=lambda t: axis_block(
                t, pl, mesh, "data"))

        grads = tree_map(reduce, grads, self.placements, self.plan)
        return (grads, psum_ordered(loss, mesh, "data"),
                {k: psum_ordered(v, mesh, "data")
                 for k, v in metrics.items()})

    def _step(self, params, opt_state: AdamWState, err, batch: dict):
        """One update -> (params, opt_state, err, metrics): the batch's
        gradient (the mean over ``grad_accum`` microbatches of its leading
        dim, summed in float32 in order), compressed with error feedback
        if asked, then AdamW in place.  On a mesh ``batch`` is this rank's
        rows (:meth:`_device_batch`) and every tree holds its blocks."""
        tcfg = self.tcfg
        if tcfg.grad_accum > 1:
            m = tcfg.grad_accum
            b = next(iter(batch.values())).shape[0]
            if b % m:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"grad_accum {m}")
            gsum, loss_sum = None, 0.0
            for i in range(m):
                micro = {k: v[i * (b // m):(i + 1) * (b // m)]
                         for k, v in batch.items()}
                loss, _, g = self._grads(params, micro)
                gsum = tree_map(torch.Tensor.float, g) if gsum is None \
                    else tree_map(torch.add, gsum, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / m, gsum)
            loss, metrics = loss_sum / m, {}
        else:
            loss, metrics, grads = self._grads(params, batch)
        if self.mesh is not None:
            grads, loss, metrics = self._reduce(grads, loss, metrics)
        if tcfg.grad_compression:
            grads, err = ef_compress_grads(grads, err, self.placements,
                                           self.mesh)
        params, opt_state, om = _opt.update(
            tcfg.opt, grads, opt_state, params, inplace=True,
            placements=self.placements, mesh=self.mesh)
        return params, opt_state, err, dict(metrics, loss=loss, **om)

    def _rank_rows(self, v):
        """This rank's rows of a global batch array: with ``grad_accum`` =
        m and D data shards, microbatch j's rows j·b/m + [r·b/(m·D),
        (r+1)·b/(m·D)), the m of them in order (the reference's reshape to
        (m, b/m) sharded over ``"data"``)."""
        m, d = self.tcfg.grad_accum, shard_count(self.mesh, "data")
        r = shard_index(self.mesh, "data")
        b = v.shape[0]
        if b % (m * d):
            raise ValueError(f"batch {b} does not split into grad_accum {m} "
                             f"× {d} data shards")
        n = b // (m * d)
        rows = np.concatenate([np.arange(j * (b // m) + r * n,
                                         j * (b // m) + (r + 1) * n)
                               for j in range(m)])
        return torch.as_tensor(v)[torch.from_numpy(rows)]

    def _device_batch(self, batch: dict) -> dict:
        """Host arrays -> tensors on the device (on a mesh, this rank's
        rows, :meth:`_rank_rows`).  Positions equal to the model's own are
        dropped: ``forward`` builds the same ones, and the attention
        kernels then mask causality by index and skip the key tiles above
        the diagonal, which runtime positions make them visit."""
        if self.mesh is not None:
            batch = {k: self._rank_rows(v) for k, v in batch.items()}
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()
                if not (k == "positions" and _default_positions(v))}

    # ------------------------------------------------------------------
    def _ckpt_placements(self):
        pl = self.placements
        return None if pl is None else {"params": pl, "mu": pl, "nu": pl}

    def maybe_restore(self, state):
        """The newest checkpoint's parameters and moments (and its step)
        onto the trainer's device, or ``state`` when there is none.  On a
        mesh each rank reads its blocks, whatever mesh wrote them."""
        params, opt_state, err = state
        tree = {"params": params, "mu": opt_state.mu, "nu": opt_state.nu}
        restored, extra = self.ckpt.restore_latest(
            tree, device=self.device, placements=self._ckpt_placements(),
            mesh=self.mesh)
        if restored is None:
            return state
        self.step = int(extra.get("step", 0))
        opt_state = AdamWState(
            step=torch.tensor(self.step, dtype=torch.int32,
                              device=self.device),
            mu=restored["mu"], nu=restored["nu"])
        return restored["params"], opt_state, err

    def save(self, state) -> str:
        """Checkpoint the parameters and moments at ``self.step`` (on a
        mesh, each rank its blocks: a collective call)."""
        params, opt_state, _ = state
        tree = {"params": params, "mu": opt_state.mu, "nu": opt_state.nu}
        return self.ckpt.save(self.step, tree,
                              placements=self._ckpt_placements(),
                              mesh=self.mesh)

    # ------------------------------------------------------------------
    def run(self, data: Iterator[dict], n_steps: Optional[int] = None,
            state=None):
        """Returns (state, history).  Raises NodeFailure mid-run if
        injected.  On a mesh every rank reads the same ``data`` (the
        global batches) and takes its rows."""
        if state is None:
            state = self.maybe_restore(self.init_state())
        params, opt_state, err = state
        history = []
        target = self.step + (n_steps or self.tcfg.steps)
        while self.step < target:
            if self.failure_injector is not None:
                self.failure_injector(self.step)
            batch = self._device_batch(next(data))
            params, opt_state, err, metrics = self._step(
                params, opt_state, err, batch)
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or self.step == target:
                history.append({"step": self.step,
                                "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"])})
            if self.step % self.tcfg.ckpt_every == 0:
                self.save((params, opt_state, err))
        return (params, opt_state, err), history
