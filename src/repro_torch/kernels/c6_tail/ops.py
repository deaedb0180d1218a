"""Dispatching wrappers of the C6 repair tail and of the whole C6 repair:
the CUDA kernels (``csrc/c6_tail.cu``) for CUDA tensors, the plain versions
for CPU tensors (``force=`` pins either)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.c6_tail.ref import (
    c6_repair_ref,
    c6_tail_ref,
    repair_rounds,
)

BLOCK_M = 256     # tasks per CUDA block (one thread each)
REPAIR_CAP = 16384  # tasks the one-block repair holds in shared memory
CLUSTER_BLOCKS = 16  # the largest cluster the repair launches (non-portable)
CLUSTER_CAP = REPAIR_CAP * CLUSTER_BLOCKS  # tasks the cluster repair holds


def repair_path(m: int) -> str:
    """Which launch ``c6_repair`` makes on CUDA for M tasks: ``"block"``
    (one block, every round), ``"cluster"`` (one thread block cluster of
    16 blocks, every round) or ``"per_round"`` (a
    ``c6_tail`` launch a round and the selection in torch)."""
    if m <= REPAIR_CAP:
        return "block"
    return "cluster" if m <= CLUSTER_CAP else "per_round"


def c6_tail(bw_panel, r, p, v, route, z, acc_thr, rn, pn, *, n_fps: int,
            force: str = "auto"):
    """Fused C6 repair tail -> (bw, gain, can_p) for one demotion round.

    bw_panel: (M, N·Z) float32; r/p/v/route: (M,) int32 for the kernel;
    z/acc_thr: (M,) float32; rn/pn: (N,)/(Z,).  M is padded up to the block
    with lanes at r = p = 0 (no demotion possible, gain -BIG), sliced off on
    return.
    """
    if not _build.dispatch("c6_tail", force, bw_panel.device):
        return c6_tail_ref(bw_panel, r, p, v, route, z, acc_thr, rn, pn,
                           n_fps)
    _build.refuse_grad("c6_tail", bw_panel, z, acc_thr, rn, pn)
    m, nz_flat = bw_panel.shape
    n, zn = rn.shape[0], pn.shape[0]
    if nz_flat != n * n_fps or zn != n_fps \
            or any(t.shape != (m,) for t in (r, p, v, route, z, acc_thr)):
        raise ValueError("c6_tail kernel: inconsistent shapes")
    pad = (-m) % BLOCK_M
    ints = [_build.pad_rows(t, pad) for t in (r, p, v, route)]
    panel = _build.pad_rows(bw_panel, pad)
    zz = _build.pad_rows(z, pad)
    thr = _build.pad_rows(acc_thr, pad)
    _build.check_cuda("c6_tail", panel, *ints, zz, thr, rn, pn)
    _build.check_dtype("c6_tail", torch.int32, r=ints[0], p=ints[1],
                       v=ints[2], route=ints[3])
    _build.check_dtype("c6_tail", torch.float32, bw_panel=panel, z=zz,
                       acc_thr=thr, rn=rn, pn=pn)
    mp = m + pad
    dev = bw_panel.device
    bw = torch.empty((mp,), dtype=torch.float32, device=dev)
    gain = torch.empty((mp,), dtype=torch.float32, device=dev)
    can_p = torch.empty((mp,), dtype=torch.int32, device=dev)
    lib = _build.library()
    code = lib.c6_tail_launch(
        panel.data_ptr(), *[t.data_ptr() for t in ints], zz.data_ptr(),
        thr.data_ptr(), rn.data_ptr(), pn.data_ptr(), bw.data_ptr(),
        gain.data_ptr(), can_p.data_ptr(), mp, n, zn, _build.stream_ptr(dev))
    _build.check(code, "c6_tail")
    _build.LAUNCHES["c6_tail"] += 1
    return bw[:m], gain[:m], can_p[:m] > 0


def _tail_kernel(*args, n_fps: int):
    return c6_tail(*args, n_fps=n_fps, force="kernel")


def c6_repair(bw_panel, r, p, v, route, z, acc_thr, rn, pn, budget, *,
              n_fps: int, rounds: int, force: str = "auto", task_mask=None):
    """The whole C6 repair -> (r, p, bw_history (rounds,)).

    bw_panel: (M, N·Z) float32 route-indexed bandwidth panel; r/p/v/route:
    (M,) integer decisions; z/acc_thr: (M,) float32; rn/pn: (N,)/(Z,);
    budget: a float or a 0-d float32 tensor on the panel's device (read
    there, never copied to the host).  (r, p) come back in the given r's and
    p's dtype.  On CUDA the path is chosen by M (``repair_path``): up to
    ``REPAIR_CAP`` (16,384) one launch of the one-block kernel for every
    round; up to ``CLUSTER_CAP`` (262,144) one launch of the cluster
    kernel (16 blocks that read each other's shared memory); above it
    the per-round path, the ``c6_tail`` kernel for each round's tail and
    the selection in torch.  A refused cluster launch raises.  The kernels
    sum the draw and the prefix gains in their own order, not torch's: a
    task whose cumulative gain lies within that rounding of the excess may
    be demoted on one side only.  ``task_mask``: optional (M,)
    bool alive mask (slot-pool churn): a dead lane adds 0 to the draw and
    is never demoted, on both paths; None is every lane alive.
    """
    if not _build.dispatch("c6_repair", force, bw_panel.device):
        return c6_repair_ref(bw_panel, r, p, v, route, z, acc_thr, rn, pn,
                             budget, n_fps, rounds, task_mask)
    _build.refuse_grad("c6_repair", bw_panel, z, acc_thr, rn, pn, budget)
    m, nz_flat = bw_panel.shape
    n = rn.shape[0]
    if nz_flat != n * n_fps or pn.shape[0] != n_fps or rounds < 0 \
            or any(t.shape != (m,) for t in (r, p, v, route, z, acc_thr)) \
            or task_mask is not None and task_mask.shape != (m,):
        raise ValueError("c6_repair kernel: inconsistent shapes")
    if task_mask is not None:
        _build.check_dtype("c6_repair", torch.bool, task_mask=task_mask)
    if repair_path(m) == "per_round":
        return repair_rounds(_tail_kernel, bw_panel, r, p, v, route, z,
                             acc_thr, rn, pn, budget, n_fps, rounds,
                             task_mask)
    ints = [t.long() for t in (r, p, v, route)]
    budget_t = budget if isinstance(budget, torch.Tensor) else None
    floats = dict(bw_panel=bw_panel, z=z, acc_thr=acc_thr, rn=rn, pn=pn)
    if budget_t is not None:
        if budget_t.numel() != 1:
            raise ValueError("c6_repair kernel: budget must be one value")
        floats["budget"] = budget_t
    masks = () if task_mask is None else (task_mask,)
    _build.check_cuda("c6_repair", *floats.values(), *ints, *masks)
    _build.check_dtype("c6_repair", torch.float32, **floats)
    dev = bw_panel.device
    r_out = torch.empty((m,), dtype=torch.int64, device=dev)
    p_out = torch.empty((m,), dtype=torch.int64, device=dev)
    hist = torch.empty((rounds,), dtype=torch.float32, device=dev)
    lib = _build.library()
    code = lib.c6_repair_launch(
        bw_panel.data_ptr(), *[t.data_ptr() for t in ints], z.data_ptr(),
        acc_thr.data_ptr(), rn.data_ptr(), pn.data_ptr(),
        None if budget_t is None else budget_t.data_ptr(),
        None if task_mask is None else task_mask.data_ptr(), r_out.data_ptr(),
        p_out.data_ptr(), hist.data_ptr(), m, n, n_fps, rounds,
        0.0 if budget_t is not None else float(budget),
        _build.stream_ptr(dev))
    _build.check(code, "c6_repair")
    _build.LAUNCHES["c6_repair"] += 1
    return r_out.to(r.dtype), p_out.to(p.dtype), hist
