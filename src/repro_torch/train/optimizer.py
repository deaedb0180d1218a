"""AdamW with decoupled weight decay, global-norm clipping and a warm-up +
cosine learning-rate schedule: port of ``repro/train/optimizer.py``.

Plain tensor operations over the parameter tree (nested dicts and lists),
in the reference's order: clip every gradient by ``min(1, grad_clip /
max(‖g‖, 1e-12))``, bias-corrected moments, ``mhat / (sqrt(vhat) + eps) +
weight_decay · p``, then ``p - lr · delta``.  ``torch.optim.AdamW`` clips,
schedules and orders these operations otherwise, so it is not used.  The
moments ``mu`` and ``nu`` are float32; the new parameter is computed in
float32 and cast back to the parameter's dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding.collectives import psum_ordered


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 0-d: updates taken
    mu: Any                 # float32 first moments, the parameters' tree
    nu: Any                 # float32 second moments


def lr_at(cfg: AdamWConfig, step):
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to ``lr · min_lr_ratio`` at ``total_steps`` (float32 0-d; ``step`` an
    integer or a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> AdamWState:
    """Zero float32 moments beside every parameter, step 0."""
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree, placements=None, mesh=None):
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.
    With ``placements`` and ``mesh`` the leaves are this rank's blocks:
    each block's sum is summed over the mesh dims that split its leaf, in
    rank order (one ``psum_ordered`` for all the leaves split by the same
    dims), so every element counts once, and a leaf held whole on several
    ranks once."""
    sums = [torch.sum(torch.square(t.float())) for t in tree_leaves(tree)]
    if placements is not None:
        split = [p.split_axes for p in tree_leaves(placements)]
        for axes in sorted(set(split)):
            if not axes:
                continue
            idx = [i for i, a in enumerate(split) if a == axes]
            part = torch.stack([sums[i] for i in idx])
            for axis in axes:
                part = psum_ordered(part, mesh, axis)
            for i, v in zip(idx, part.unbind(0)):
                sums[i] = v
    return torch.sqrt(sum(sums))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params, *,
           inplace: bool = False, placements=None, mesh=None):
    """One AdamW step -> (new params, new state, {"grad_norm", "lr"}).
    With ``placements`` and ``mesh`` every tree holds this rank's blocks:
    the clip reads the whole gradient's norm (:func:`global_norm`), and the
    update is elementwise.

    ``inplace``: write the new parameters and moments into ``params`` and
    ``state``'s tensors (returned as the new ones) instead of new tensors,
    so a step holds one copy of the optimizer's state (the reference
    donates its buffers to the jitted step to the same end); the numbers
    are the same."""
    gnorm = global_norm(grads, placements, mesh)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(g, m, v, p):
        g = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p_new = (p.float() - lr * delta).to(p.dtype)
        if not inplace:
            return p_new, m_new, v_new
        return p.copy_(p_new), m.copy_(m_new), v.copy_(v_new)

    out = tree_map(upd, grads, state.mu, state.nu, params)
    pick = lambda i: tree_map(lambda _, t: t[i], grads, out)
    return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2)), {
        "grad_norm": gnorm, "lr": lr}
