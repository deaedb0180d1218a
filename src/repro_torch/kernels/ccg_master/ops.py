"""Dispatching wrapper of the CCG master step: the CUDA kernel
(``csrc/ccg_master.cu``) for CUDA tensors, the plain version for CPU tensors
(``force=`` pins either)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ccg_master.ref import ccg_master_ref


def ccg_master(rec_all, scen_mask, fs_ok, c1, *, force: str = "auto"):
    """Masked CCG master step -> (y_star (M,) int32, o_down (M,) float32).

    rec_all: (M, P, F) float32; scen_mask: (M, P) float32 0/1; fs_ok:
    (M, F) bool; c1: (F,) float32.  The kernel takes P <= 64 and any M, F.
    """
    if not _build.dispatch("ccg_master", force, rec_all.device):
        return ccg_master_ref(rec_all, scen_mask, fs_ok, c1)
    m, p, f = rec_all.shape
    if scen_mask.shape != (m, p) or fs_ok.shape != (m, f) \
            or c1.shape != (f,) or p > 64:
        raise ValueError("ccg_master kernel: inconsistent shapes or P > 64")
    _build.check_cuda("ccg_master", rec_all, scen_mask, fs_ok, c1)
    _build.check_dtype("ccg_master", torch.float32, rec_all=rec_all,
                       scen_mask=scen_mask, c1=c1)
    _build.check_dtype("ccg_master", torch.bool, fs_ok=fs_ok)
    dev = rec_all.device
    y_star = torch.empty((m,), dtype=torch.int32, device=dev)
    o_down = torch.empty((m,), dtype=torch.float32, device=dev)
    err = _build.library().ccg_master_launch(
        rec_all.data_ptr(), scen_mask.data_ptr(), fs_ok.data_ptr(),
        c1.data_ptr(), y_star.data_ptr(), o_down.data_ptr(), m, p, f,
        _build.stream_ptr(dev))
    _build.check(err, "ccg_master")
    _build.LAUNCHES["ccg_master"] += 1
    return y_star, o_down
