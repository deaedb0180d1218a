"""Dispatching wrappers of the fused gating cell and of its backward: the
CUDA kernels (``csrc/temporal_gate.cu``, ``csrc/temporal_gate_bwd.cu``)
for CUDA tensors, the plain versions for CPU tensors (``force=`` pins
either), and :class:`GateCellFn`, the cell as an autograd function whose
backward is the backward kernel on the card."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.temporal_gate.ref import (
    PARAM_NAMES,
    gate_cell_ref,
    gate_cell_vjp_ref,
    pack_weights,
)


def gate_cell(dx, h, vol, p, *, force: str = "auto"):
    """Fused gating cell for a (B, d) stream batch -> (h_new, tau, g_mean).

    The kernel takes m = 32 hidden units and d <= 64 features in float32,
    any B (the last tile of streams is masked in the kernel).
    """
    if not _build.dispatch("gate_cell", force, dx.device):
        return gate_cell_ref(dx, h, vol, p)
    b, d = dx.shape
    m = h.shape[1]
    if m != 32 or not 1 <= d <= 64 or h.shape[0] != b or vol.shape != (b,):
        raise ValueError(f"gate_cell kernel: need dx (B, d<=64), h (B, 32), "
                         f"vol (B,); got {tuple(dx.shape)}, {tuple(h.shape)}, "
                         f"{tuple(vol.shape)}")
    w_x, u_gr = pack_weights(p)
    weights = [w_x, u_gr, p["b_g"], p["alpha"].reshape(1), p["b_r"], p["u_h"],
               p["b_h"], p["w_o"], p["b_o"]]
    if w_x.shape != (d, 3 * m) or p["u_h"].shape != (m, m) \
            or p["w_o"].shape != (m, 1):
        raise ValueError("gate_cell kernel: weight shapes do not match dx/h")
    ins = [dx, h, vol] + [w.contiguous() for w in weights]
    _build.check_cuda("gate_cell", *ins)
    _build.check_dtype("gate_cell", torch.float32,
                       **{f"operand{i}": t for i, t in enumerate(ins)})
    h_new = torch.empty((b, m), dtype=torch.float32, device=dx.device)
    tau = torch.empty((b,), dtype=torch.float32, device=dx.device)
    g_mean = torch.empty((b,), dtype=torch.float32, device=dx.device)
    lib = _build.library()
    code = lib.gate_cell_launch(
        *[t.data_ptr() for t in ins], h_new.data_ptr(), tau.data_ptr(),
        g_mean.data_ptr(), b, d, m, _build.stream_ptr(dx.device))
    _build.check(code, "gate_cell")
    _build.LAUNCHES["gate_cell"] += 1
    return h_new, tau, g_mean


def gate_cell_vjp(dx, h, vol, p, dh_new=None, dtau=None, dg_mean=None, *,
                  need_dh: bool = True, force: str = "auto"):
    """The cell's vector-Jacobian product -> ``(grads, dh)``, as
    :func:`~repro_torch.kernels.temporal_gate.ref.gate_cell_vjp_ref`: the
    gradient of each parameter (a dict, each of its parameter's shape; the
    views of one flat tensor on the card) and ``dh (B, m)`` or None unless
    ``need_dh``.  ``dh_new (B, m)``, ``dtau (B,)`` and ``dg_mean (B,)``:
    the incoming gradients, None for zero.

    The kernel takes what the forward kernel takes (m = 32, d <= 64,
    float32, any B); it recomputes the forward and sums the weight
    gradients over B in a fixed order, so two launches give the same bits.
    """
    if not _build.dispatch("gate_cell_bwd", force, dx.device):
        return gate_cell_vjp_ref(dx, h, vol, p, dh_new, dtau, dg_mean,
                                 need_dh=need_dh)
    b, d = dx.shape
    m = h.shape[1]
    if m != 32 or not 1 <= d <= 64 or h.shape[0] != b or vol.shape != (b,):
        raise ValueError(f"gate_cell_bwd kernel: need dx (B, d<=64), h (B, "
                         f"32), vol (B,); got {tuple(dx.shape)}, "
                         f"{tuple(h.shape)}, {tuple(vol.shape)}")
    shapes = {"w_g": (d, m), "u_g": (m, m), "b_g": (m,), "alpha": (),
              "w_r": (d, m), "u_r": (m, m), "b_r": (m,), "w_h": (d, m),
              "u_h": (m, m), "b_h": (m,), "w_o": (m, 1), "b_o": (1,)}
    if any(tuple(p[k].shape) != shapes[k] for k in PARAM_NAMES):
        raise ValueError("gate_cell_bwd kernel: weight shapes do not match "
                         "dx/h")
    grads_in = {"dh_new": (dh_new, (b, m)), "dtau": (dtau, (b,)),
                "dg_mean": (dg_mean, (b,))}
    for key, (t, shape) in grads_in.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"gate_cell_bwd kernel: {key} must be "
                             f"{shape}, got {tuple(t.shape)}")
    ins = [dx, h, vol] + [p[k].contiguous() for k in PARAM_NAMES]
    dh_new, dtau, dg_mean = (None if t is None else t.contiguous()
                             for t, _ in grads_in.values())
    given = [t for t in (dh_new, dtau, dg_mean) if t is not None]
    _build.check_cuda("gate_cell_bwd", *ins, *given)
    _build.check_dtype("gate_cell_bwd", torch.float32,
                       **{f"operand{i}": t
                          for i, t in enumerate(ins + given)})
    sizes = [math.prod(shapes[k]) for k in PARAM_NAMES]
    # a row of the weight gradients per block of the kernel (32 streams);
    # the kernel refuses a buffer with fewer rows than its blocks
    partial = torch.empty(((b + 31) // 32, sum(sizes)), dtype=torch.float32,
                          device=dx.device)
    flat = torch.empty((sum(sizes),), dtype=torch.float32, device=dx.device)
    dh = torch.empty((b, m), dtype=torch.float32, device=dx.device) \
        if need_dh else None
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.library()
    code = lib.gate_cell_bwd_launch(
        *[t.data_ptr() for t in ins], ptr(dh_new), ptr(dtau), ptr(dg_mean),
        ptr(dh), partial.data_ptr(), partial.shape[0], flat.data_ptr(), b,
        d, m, _build.stream_ptr(dx.device))
    _build.check(code, "gate_cell_bwd")
    _build.LAUNCHES["gate_cell_bwd"] += 1
    grads = {k: g.view(shapes[k]) for k, g in
             zip(PARAM_NAMES, flat.split(sizes))}
    return grads, dh


class GateCellFn(torch.autograd.Function):
    """:func:`gate_cell` as an autograd function: the forward is the cell
    (the forward kernel on the card), the backward :func:`gate_cell_vjp`
    (the backward kernel on the card; never autograd of the plain cell
    there).  ``apply(dx, h, vol, force, *params)`` with the parameters in
    ``PARAM_NAMES`` order; ``dx`` and ``vol`` get no gradient."""

    @staticmethod
    def forward(ctx, dx, h, vol, force, *params):
        p = dict(zip(PARAM_NAMES, params))
        ctx.save_for_backward(dx, h, vol, *params)
        ctx.force = force
        return gate_cell(dx, h, vol, p, force=force)

    @staticmethod
    def backward(ctx, dh_new, dtau, dg_mean):
        dx, h, vol, *params = ctx.saved_tensors
        p = dict(zip(PARAM_NAMES, params))
        grads, dh = gate_cell_vjp(
            dx, h, vol, p, dh_new, dtau, dg_mean,
            need_dh=ctx.needs_input_grad[1], force=ctx.force)
        return (None, dh, None, None, *(grads[k] for k in PARAM_NAMES))


def gate_cell_autograd(dx, h, vol, p, *, force: str = "auto"):
    """:func:`gate_cell` through :class:`GateCellFn` -> (h_new, tau,
    g_mean), differentiable in ``h`` and the parameters."""
    return GateCellFn.apply(dx, h, vol, force, *(p[k] for k in PARAM_NAMES))
