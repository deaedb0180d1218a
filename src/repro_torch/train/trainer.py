"""Training loop: port of ``repro/train/trainer.py`` on one device —
checkpoint/restart, failure recovery, gradient accumulation and optional
int8 error-feedback gradient compression.

The reference jits a sharded step (``pjit`` over ``mesh`` and ``rules``);
the port runs the same step eagerly on one device: autograd of
:func:`~repro_torch.models.model.loss_fn` (the attention kernel's backward
kernel on the card, remat by ``torch.utils.checkpoint``), then AdamW.  The
parameters are float32 masters (the reference's ``init_params`` dtype)
that the loss casts to the compute dtype.  The step updates the parameters
and the optimizer's moments in place, where the reference donates them to
its jitted step.  Training across ranks (``mesh``, ``rules``) is ROADMAP
queue A.16c: the port's ``Trainer`` raises if either is given.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.models.layers import Ctx
from repro_torch.models.model import loss_fn, model_specs
from repro_torch.models.params import init_params, tree_leaves, tree_map
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


class Trainer:
    def __init__(self, cfg, tcfg: TrainConfig, mesh=None, rules=None,
                 failure_injector=None, *, device="cuda",
                 force: str = "auto"):
        """``device`` (default ``cuda``) holds the state and runs the
        steps; ``force`` pins the kernels as on every wrapper."""
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "Trainer: training across ranks (mesh, rules) is ROADMAP "
                "queue A.16c; the port trains on one device")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.ctx = Ctx(cfg=cfg, mode="train", force=force)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.failure_injector = failure_injector
        self.specs = model_specs(cfg)
        self.step = 0

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None):
        """-> (float32 parameters drawn from ``generator`` (a generator on
        the trainer's device; default seeded with ``tcfg.seed``), AdamW
        state, error-feedback buffers (zeros; None without compression))."""
        gen = generator if generator is not None else \
            torch.Generator(self.device).manual_seed(self.tcfg.seed)
        params = init_params(self.specs, gen, self.device)
        err = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params) if self.tcfg.grad_compression else None
        return params, _opt.init(params), err

    def _step(self, params, opt_state: AdamWState, err, batch: dict):
        """One update -> (params, opt_state, err, metrics): the batch's
        gradient (the mean over ``grad_accum`` microbatches of its leading
        dim, summed in float32 in order), compressed with error feedback
        if asked, then AdamW in place."""
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
                loss, _, g = grads_of(self.ctx, params, micro)
                gsum = tree_map(torch.Tensor.float, g) if gsum is None \
                    else tree_map(torch.add, gsum, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / m, gsum)
            loss, metrics = loss_sum / m, {}
        else:
            loss, metrics, grads = grads_of(self.ctx, params, batch)
        if tcfg.grad_compression:
            grads, err = ef_compress_grads(grads, err)
        params, opt_state, om = _opt.update(tcfg.opt, grads, opt_state,
                                            params, inplace=True)
        return params, opt_state, err, dict(metrics, loss=loss, **om)

    def _device_batch(self, batch: dict) -> dict:
        """Host arrays -> tensors on the device.  Positions equal to the
        model's own are dropped: ``forward`` builds the same ones, and the
        attention kernels then mask causality by index and skip the key
        tiles above the diagonal, which runtime positions make them
        visit."""
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()
                if not (k == "positions" and _default_positions(v))}

    # ------------------------------------------------------------------
    def maybe_restore(self, state):
        """The newest checkpoint's parameters and moments (and its step)
        onto the trainer's device, or ``state`` when there is none."""
        params, opt_state, err = state
        tree = {"params": params, "mu": opt_state.mu, "nu": opt_state.nu}
        restored, extra = self.ckpt.restore_latest(tree, device=self.device)
        if restored is None:
            return state
        self.step = int(extra.get("step", 0))
        opt_state = AdamWState(
            step=torch.tensor(self.step, dtype=torch.int32,
                              device=self.device),
            mu=restored["mu"], nu=restored["nu"])
        return restored["params"], opt_state, err

    def save(self, state) -> str:
        params, opt_state, _ = state
        tree = {"params": params, "mu": opt_state.mu, "nu": opt_state.nu}
        return self.ckpt.save(self.step, tree)

    # ------------------------------------------------------------------
    def run(self, data: Iterator[dict], n_steps: Optional[int] = None,
            state=None):
        """Returns (state, history).  Raises NodeFailure mid-run if
        injected."""
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
