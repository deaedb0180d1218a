"""Dispatching wrapper of the selective scan: the CUDA kernel
(``csrc/mamba_scan.cu``) for CUDA tensors, the plain version for CPU
tensors (``force=`` pins either)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

MAX_STATE = 16    # state values per channel held in registers


def selective_scan(x, dt, B, C, A, D, h0=None, *, h_out=None,
                   force: str = "auto"):
    """Mamba-1 selective scan -> (y (b, S, Di) float32, h (b, Di, N)
    float32).

    x: (b, S, Di) and B, C: (b, S, N), all float32 or all bfloat16; dt:
    (b, S, Di), A: (Di, N), D: (Di,), h0: (b, Di, N) or None (zeros), all
    float32.  The kernel reads x, dt, B and C by their strides (the last
    dimension contiguous), so column slices of a projection are not copied.
    ``h_out`` (b, Di, N) float32, if given, receives the final state and is
    returned as ``h``; it may be ``h0`` itself (a decode step updating its
    cache in place).
    """
    if not _build.dispatch("mamba_scan", force, x.device):
        y, h = selective_scan_ref(x, dt, B, C, A, D, h0)
        if h_out is not None:
            h = h_out.copy_(h)
        return y, h
    _build.refuse_grad("mamba_scan", x, dt, B, C, A, D, h0)
    b, s, di = x.shape
    n = A.shape[-1]
    if tuple(dt.shape) != (b, s, di) or tuple(A.shape) != (di, n) \
            or tuple(D.shape) != (di,) or tuple(B.shape) != (b, s, n) \
            or tuple(C.shape) != (b, s, n) or any(
                t is not None and tuple(t.shape) != (b, di, n)
                for t in (h0, h_out)):
        raise ValueError(f"mamba_scan kernel: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)} A {tuple(A.shape)} D "
                         f"{tuple(D.shape)}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"mamba_scan kernel: at most {MAX_STATE} state "
                         f"values per channel, got N={n}")
    if min(b, s, di) == 0:
        raise ValueError("mamba_scan kernel: empty operands")
    code = _build.DTYPE_CODES.get(x.dtype)
    if code is None or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"mamba_scan: x, B and C must share float32 or "
                        f"bfloat16, got {x.dtype}, {B.dtype}, {C.dtype}")
    if h_out is None:
        h_out = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    state = [h_out] if h0 is None else [h0, h_out]
    _build.check_dtype("mamba_scan", torch.float32, dt=dt, A=A, D=D,
                       h_out=h_out, h0=state[0])
    _build.check_cuda("mamba_scan", A, D, *state)
    for t in (x, dt, B, C):
        if t.device != A.device:
            raise ValueError("mamba_scan: every operand must be on one "
                             "CUDA device")
        if t.stride(-1) != 1:
            raise ValueError("mamba_scan: x, dt, B and C need a contiguous "
                             "last dimension")
    y = torch.empty((b, s, di), dtype=torch.float32, device=x.device)
    lib = _build.library()
    rc = lib.mamba_scan_launch(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
        h_out.data_ptr(), y.data_ptr(), *x.stride()[:2], *dt.stride()[:2],
        *B.stride()[:2], *C.stride()[:2], b, s, di, n, code,
        _build.stream_ptr(x.device))
    _build.check(rc, "mamba_scan")
    _build.LAUNCHES["mamba_scan"] += 1
    return y, h_out
