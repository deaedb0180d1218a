"""Dispatching wrapper of the C6 repair tail: the CUDA kernel
(``csrc/c6_tail.cu``) for CUDA tensors, the plain version for CPU tensors
(``force=`` pins either)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.c6_tail.ref import c6_tail_ref

BLOCK_M = 256     # tasks per CUDA block (one thread each)


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
