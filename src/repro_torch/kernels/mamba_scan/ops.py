"""Dispatching wrappers of the selective scan and of its backward: the CUDA
kernels (``csrc/mamba_scan.cu``, ``csrc/mamba_scan_bwd.cu``) for CUDA
tensors, the plain versions for CPU tensors (``force=`` pins either), and
:class:`SelectiveScanFn`, the scan as an autograd function whose backward
is the backward kernel on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import (
    selective_scan_ref,
    selective_scan_vjp_ref,
)

MAX_STATE = 16    # state values per channel held in registers
TILE_STEPS = 32   # the training launch stores the state every TILE_STEPS
CHANNELS = 64     # channels of a backward block (its dB/dC partials)


def selective_scan(x, dt, B, C, A, D, h0=None, *, h_out=None,
                   force: str = "auto", return_tiles: bool = False):
    """Mamba-1 selective scan -> (y (b, S, Di) float32, h (b, Di, N)
    float32), and with ``return_tiles`` a third value: the state entering
    each ``TILE_STEPS``-step tile, (b, ⌈S/32⌉, Di, N) float32, which the
    backward kernel recomputes from (None from the plain version).

    x: (b, S, Di) and B, C: (b, S, N), all float32 or all bfloat16; dt:
    (b, S, Di), A: (Di, N), D: (Di,), h0: (b, Di, N) or None (zeros), all
    float32.  The kernel reads x, dt, B and C by their strides (the last
    dimension contiguous), so column slices of a projection are not copied.
    ``h_out`` (b, Di, N) float32, if given, receives the final state and is
    returned as ``h``; it may be ``h0`` itself (a decode step updating its
    cache in place).  ``return_tiles`` takes the kernel's training launch,
    whose y and h are the serving launch's bits.
    """
    if not _build.dispatch("mamba_scan", force, x.device):
        y, h = selective_scan_ref(x, dt, B, C, A, D, h0)
        if h_out is not None:
            h = h_out.copy_(h)
        return (y, h, None) if return_tiles else (y, h)
    _build.refuse_grad("mamba_scan", x, dt, B, C, A, D, h0)
    b, s, di = x.shape
    n = A.shape[-1]
    code = _check_operands("mamba_scan", x, dt, B, C, A, D, h0, h_out)
    if h_out is None:
        h_out = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    state = [h_out] if h0 is None else [h0, h_out]
    _build.check_dtype("mamba_scan", torch.float32, A=A, D=D, h_out=h_out,
                       h0=state[0])
    _build.check_cuda("mamba_scan", A, D, *state)
    y = torch.empty((b, s, di), dtype=torch.float32, device=x.device)
    h_tiles = torch.empty((b, -(-s // TILE_STEPS), di, n),
                          dtype=torch.float32,
                          device=x.device) if return_tiles else None
    rc = _build.library().mamba_scan_launch(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
        h_out.data_ptr(), y.data_ptr(),
        None if h_tiles is None else h_tiles.data_ptr(),
        *x.stride()[:2], *dt.stride()[:2], *B.stride()[:2], *C.stride()[:2],
        b, s, di, n, code, _build.stream_ptr(x.device))
    _build.check(rc, "mamba_scan")
    _build.LAUNCHES["mamba_scan"] += 1
    return (y, h_out, h_tiles) if return_tiles else (y, h_out)


def _check_operands(name, x, dt, B, C, A, D, *states):
    """The shapes of the scan's operands (``states``: (b, Di, N) or None);
    x, B and C share float32 or bfloat16; dt is float32; the four lie on
    A's CUDA device with a contiguous last dimension.  Returns x's dtype
    code."""
    b, s, di = x.shape
    n = A.shape[-1]
    if tuple(dt.shape) != (b, s, di) or tuple(A.shape) != (di, n) \
            or tuple(D.shape) != (di,) or tuple(B.shape) != (b, s, n) \
            or tuple(C.shape) != (b, s, n) or any(
                t is not None and tuple(t.shape) != (b, di, n)
                for t in states):
        raise ValueError(f"{name} kernel: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)} A {tuple(A.shape)} D "
                         f"{tuple(D.shape)}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"{name} kernel: at most {MAX_STATE} state "
                         f"values per channel, got N={n}")
    if min(b, s, di) == 0:
        raise ValueError(f"{name} kernel: empty operands")
    code = _build.DTYPE_CODES.get(x.dtype)
    if code is None or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"{name}: x, B and C must share float32 or "
                        f"bfloat16, got {x.dtype}, {B.dtype}, {C.dtype}")
    _build.check_dtype(name, torch.float32, dt=dt)
    for t in (x, dt, B, C):
        if t.device != A.device:
            raise ValueError(f"{name}: every operand must be on one "
                             "CUDA device")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: x, dt, B and C need a contiguous "
                             "last dimension")
    return code


def selective_scan_bwd(x, dt, B, C, A, D, h0, dy, dh=None, *, h_tiles,
                       h_last=None, force: str = "auto"):
    """The vector-Jacobian product of :func:`selective_scan` -> (dx in x's
    dtype, ddt (b, S, Di), dB, dC (b, S, N) in B's dtype, dA (Di, N), dD
    (Di,), dh0 (b, Di, N)), the rest float32.

    ``dy`` (b, S, Di) and ``dh`` (b, Di, N) or None (zeros) are the
    cotangents of y and of the final state; the other operands as
    :func:`selective_scan` takes them.  ``h_tiles``: the training launch's
    states (``selective_scan(..., return_tiles=True)``; the plain version
    recomputes its states and ignores them, so None will do there).
    ``h_last`` (b, Di, N) float32, if given, receives the kernel's
    recomputed state of the last step (the forward's h, bit for bit).
    ``dy`` in a layout the kernel cannot read (stride 0 from ``y.sum()``)
    is copied contiguous."""
    if not _build.dispatch("mamba_scan_bwd", force, x.device):
        return selective_scan_vjp_ref(x, dt, B, C, A, D, h0, dy, dh)
    b, s, di = x.shape
    n = A.shape[-1]
    if h_tiles is None:
        raise ValueError("mamba_scan_bwd kernel: h_tiles from "
                         "selective_scan(..., return_tiles=True) required")
    dy = dy.contiguous()
    dh = None if dh is None else dh.contiguous()
    code = _check_operands("mamba_scan_bwd", x, dt, B, C, A, D, h0, dh,
                           h_last)
    if tuple(dy.shape) != (b, s, di) or tuple(h_tiles.shape) != (
            b, -(-s // TILE_STEPS), di, n):
        raise ValueError(f"mamba_scan_bwd kernel: shapes x {tuple(x.shape)} "
                         f"dy {tuple(dy.shape)} h_tiles "
                         f"{tuple(h_tiles.shape)}")
    given = {k: t for k, t in (("dh", dh), ("h_last", h_last))
             if t is not None}
    _build.check_dtype("mamba_scan_bwd", torch.float32, A=A, D=D,
                       h_tiles=h_tiles, dy=dy, **given)
    _build.check_cuda("mamba_scan_bwd", A, D, h_tiles, dy, *given.values())
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((b, s, di), dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, s, di), **f32)
    db, dc = (torch.empty((b, s, n), dtype=B.dtype, device=x.device)
              for _ in range(2))
    dad = torch.empty((di * n + di,), **f32)
    dh0 = torch.empty((b, di, n), **f32)
    part_bc = torch.empty((-(-di // CHANNELS), b, s, 2 * n), **f32)
    part_ad = torch.empty((b, di * n + di), **f32)
    rc = _build.library().mamba_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), h_tiles.data_ptr(), dy.data_ptr(),
        None if dh is None else dh.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        db.data_ptr(), dc.data_ptr(), part_bc.data_ptr(), part_ad.data_ptr(),
        dad.data_ptr(), dh0.data_ptr(),
        None if h_last is None else h_last.data_ptr(),
        *x.stride()[:2], *dt.stride()[:2], *B.stride()[:2], *C.stride()[:2],
        b, s, di, n, code, _build.stream_ptr(x.device))
    _build.check(rc, "mamba_scan_bwd")
    _build.LAUNCHES["mamba_scan_bwd"] += 1
    return dx, ddt, db, dc, dad[:di * n].view(di, n), dad[di * n:], dh0


class SelectiveScanFn(torch.autograd.Function):
    """:func:`selective_scan` as an autograd function: the forward is the
    scan's training launch on the card (it also keeps the state entering
    each 32-step tile; under remat, those of the forward that
    ``torch.utils.checkpoint`` reruns), the backward
    :func:`selective_scan_bwd` (the backward kernel on the card, which
    recomputes each tile from them; never autograd of the plain loop
    there).  ``apply(x, dt, B, C, A, D, h0, force)`` -> (y, h)."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, D, h0, force):
        ctx.set_materialize_grads(False)
        y, h, h_tiles = selective_scan(x, dt, B, C, A, D, h0, force=force,
                                       return_tiles=True)
        ctx.save_for_backward(x, dt, B, C, A, D, h0, h_tiles)
        ctx.force = force
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, B, C, A, D, h0, h_tiles = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, db, dc, d_a, d_d, dh0 = selective_scan_bwd(
            x, dt, B, C, A, D, h0, dy, dh, h_tiles=h_tiles, force=ctx.force)
        return (dx, ddt, db, dc, d_a, d_d, None if h0 is None else dh0,
                None)


def selective_scan_autograd(x, dt, B, C, A, D, h0=None, *,
                            force: str = "auto"):
    """:func:`selective_scan` through :class:`SelectiveScanFn`,
    differentiable in every operand."""
    return SelectiveScanFn.apply(x, dt, B, C, A, D, h0, force)
