"""Dispatching wrapper of the RG-LRU scan: the CUDA kernel
(``csrc/rglru_scan.cu``) for CUDA tensors, the plain version for CPU
tensors (``force=`` pins either)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import rglru_scan_ref


def rglru_scan(x, rgate, igate, log_a_base, h0=None, *, h_out=None,
               force: str = "auto"):
    """RG-LRU scan -> (y (B, S, W) float32, h (B, W) float32).

    x: (B, S, W) float32 or bfloat16; rgate, igate: (B, S, W), log_a_base:
    (W,), h0: (B, W) or None (zeros), all float32 and contiguous.
    ``h_out`` (B, W) float32, if given, receives the final state and is
    returned as ``h``; it may be ``h0`` itself (a decode step updating its
    cache in place).
    """
    if not _build.dispatch("rglru_scan", force, x.device):
        y, h = rglru_scan_ref(x, rgate, igate, log_a_base, h0)
        if h_out is not None:
            h = h_out.copy_(h)
        return y, h
    _build.refuse_grad("rglru_scan", x, rgate, igate, log_a_base, h0)
    b, s, w = x.shape
    if tuple(rgate.shape) != (b, s, w) or tuple(igate.shape) != (b, s, w) \
            or tuple(log_a_base.shape) != (w,) or any(
                t is not None and tuple(t.shape) != (b, w)
                for t in (h0, h_out)):
        raise ValueError(f"rglru_scan kernel: shapes x {tuple(x.shape)} r "
                         f"{tuple(rgate.shape)} i {tuple(igate.shape)} la "
                         f"{tuple(log_a_base.shape)}")
    if min(b, s, w) == 0:
        raise ValueError("rglru_scan kernel: empty operands")
    code = _build.DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"rglru_scan: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if h_out is None:
        h_out = torch.empty((b, w), dtype=torch.float32, device=x.device)
    state = [h_out] if h0 is None else [h0, h_out]
    _build.check_dtype("rglru_scan", torch.float32, rgate=rgate, igate=igate,
                       log_a_base=log_a_base, h_out=h_out, h0=state[0])
    _build.check_cuda("rglru_scan", x, rgate, igate, log_a_base, *state)
    y = torch.empty((b, s, w), dtype=torch.float32, device=x.device)
    lib = _build.library()
    rc = lib.rglru_scan_launch(
        x.data_ptr(), rgate.data_ptr(), igate.data_ptr(),
        log_a_base.data_ptr(), None if h0 is None else h0.data_ptr(),
        h_out.data_ptr(), y.data_ptr(), b, s, w, code,
        _build.stream_ptr(x.device))
    _build.check(rc, "rglru_scan")
    _build.LAUNCHES["rglru_scan"] += 1
    return y, h_out
