"""Dispatching wrappers of the RG-LRU scan and of its backward: the CUDA
kernels (``csrc/rglru_scan.cu``, ``csrc/rglru_scan_bwd.cu``) for CUDA
tensors, the plain versions for CPU tensors (``force=`` pins either), and
:class:`RGLRUScanFn`, the scan as an autograd function whose backward is
the backward kernel on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import rglru_scan_ref, rglru_scan_vjp_ref


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


def rglru_scan_bwd(x, rgate, igate, log_a_base, h0, y, dy, dh=None, *,
                   force: str = "auto"):
    """The vector-Jacobian product of :func:`rglru_scan` -> (dx (B, S, W) in
    x's dtype, dr, di (B, S, W), dla (W,), dh0 (B, W)), all but dx float32.

    ``y`` (B, S, W) float32 are the forward's states; ``dy`` (B, S, W) and
    ``dh`` (B, W) or None (zeros) the cotangents of y and of the final
    state; the other operands as :func:`rglru_scan` takes them.  ``dy`` in
    a layout the kernel cannot read (stride 0 from ``y.sum()``) is copied
    contiguous."""
    if not _build.dispatch("rglru_scan_bwd", force, x.device):
        return rglru_scan_vjp_ref(x, rgate, igate, log_a_base, h0, y, dy, dh)
    b, s, w = x.shape
    if any(tuple(t.shape) != (b, s, w) for t in (rgate, igate, y, dy)) \
            or tuple(log_a_base.shape) != (w,) or any(
                t is not None and tuple(t.shape) != (b, w) for t in (h0, dh)):
        raise ValueError(f"rglru_scan_bwd kernel: shapes x {tuple(x.shape)} "
                         f"r {tuple(rgate.shape)} i {tuple(igate.shape)} y "
                         f"{tuple(y.shape)} dy {tuple(dy.shape)} la "
                         f"{tuple(log_a_base.shape)}")
    if min(b, s, w) == 0:
        raise ValueError("rglru_scan_bwd kernel: empty operands")
    code = _build.DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"rglru_scan_bwd: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    dy = dy.contiguous()
    dh = None if dh is None else dh.contiguous()
    given = {k: t for k, t in (("h0", h0), ("dh", dh)) if t is not None}
    _build.check_dtype("rglru_scan_bwd", torch.float32, rgate=rgate,
                       igate=igate, log_a_base=log_a_base, y=y, dy=dy,
                       **given)
    _build.check_cuda("rglru_scan_bwd", x, rgate, igate, log_a_base, y, dy,
                      *given.values())
    dx = torch.empty_like(x)
    dr, di = (torch.empty((b, s, w), dtype=torch.float32, device=x.device)
              for _ in range(2))
    dla = torch.empty((w,), dtype=torch.float32, device=x.device)
    dh0, part = (torch.empty((b, w), dtype=torch.float32, device=x.device)
                 for _ in range(2))
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _build.library().rglru_scan_bwd_launch(
        x.data_ptr(), rgate.data_ptr(), igate.data_ptr(),
        log_a_base.data_ptr(), ptr(h0), y.data_ptr(), dy.data_ptr(), ptr(dh),
        dx.data_ptr(), dr.data_ptr(), di.data_ptr(), part.data_ptr(),
        dla.data_ptr(), dh0.data_ptr(), b, s, w, code,
        _build.stream_ptr(x.device))
    _build.check(rc, "rglru_scan_bwd")
    _build.LAUNCHES["rglru_scan_bwd"] += 1
    return dx, dr, di, dla, dh0


class RGLRUScanFn(torch.autograd.Function):
    """:func:`rglru_scan` as an autograd function: the forward is the scan
    (the kernel on the card), the backward :func:`rglru_scan_bwd` (the
    backward kernel on the card; never autograd of the plain loop there).
    It saves the states y it returns (under remat, those of the forward
    that ``torch.utils.checkpoint`` reruns).  ``apply(x, rgate, igate,
    log_a_base, h0, force)`` -> (y, h)."""

    @staticmethod
    def forward(ctx, x, rgate, igate, log_a_base, h0, force):
        ctx.set_materialize_grads(False)
        y, h = rglru_scan(x, rgate, igate, log_a_base, h0, force=force)
        ctx.save_for_backward(x, rgate, igate, log_a_base, h0, y)
        ctx.force = force
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, rgate, igate, log_a_base, h0, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        dx, dr, di, dla, dh0 = rglru_scan_bwd(
            x, rgate, igate, log_a_base, h0, y, dy, dh, force=ctx.force)
        return dx, dr, di, dla, None if h0 is None else dh0, None


def rglru_scan_autograd(x, rgate, igate, log_a_base, h0=None, *,
                        force: str = "auto"):
    """:func:`rglru_scan` through :class:`RGLRUScanFn`, differentiable in
    x, rgate, igate, log_a_base and h0."""
    return RGLRUScanFn.apply(x, rgate, igate, log_a_base, h0, force)
