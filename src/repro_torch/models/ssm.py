"""Mamba-1 selective SSM mixer (Falcon-Mamba-7B): port of
``repro/models/ssm.py`` (specs and ``ssm_forward``) on the ``mamba_scan``
kernel.

The scan runs ``kernels/mamba_scan`` (the CUDA kernel for CUDA tensors, its
plain version — the reference model's jnp scan — for CPU tensors;
``ctx.force`` pins either).  Training goes through ``SelectiveScanFn``:
the kernel's training launch and the backward kernel on the card, the
plain scan and its plain VJP elsewhere.  A decode step writes its new
convolution state and SSM state into the cache's layer views in place (the
reference returns them); the slab is the caller's and every later step
reads it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx, causal_conv, needs_grad, softplus
from repro_torch.models.params import ParamSpec


def ssm_specs(cfg: ModelConfig) -> dict:
    """A_log, D and dt_bias are float32 leaves: the reference reads them in
    float32."""
    d, di, r = cfg.d_model, cfg.d_inner, cfg.dt_rank
    st, cw = cfg.ssm.d_state, cfg.ssm.d_conv
    return {
        "in_proj": ParamSpec((d, 2 * di), axes=("embed", "inner"),
                             stddev=d ** -0.5),
        "conv_w": ParamSpec((cw, di), axes=("conv", "inner"),
                            stddev=cw ** -0.5),
        "conv_b": ParamSpec((di,), axes=("inner",), init="zeros"),
        "x_proj": ParamSpec((di, r + 2 * st), axes=("inner", None),
                            stddev=di ** -0.5),
        "dt_proj": ParamSpec((r, di), axes=("dt_rank", "inner"),
                             stddev=r ** -0.5),
        "dt_bias": ParamSpec((di,), axes=("inner",), dtype="float32",
                             init="zeros"),
        "A_log": ParamSpec((di, st), axes=("inner", "state"),
                           dtype="float32", init="zeros"),
        "D": ParamSpec((di,), axes=("inner",), dtype="float32", init="ones"),
        "out_proj": ParamSpec((di, d), axes=("inner", "embed"),
                              stddev=di ** -0.5
                              / math.sqrt(2 * cfg.num_layers)),
    }


def ssm_forward(ctx: Ctx, p, x, *, cache=None, emit_cache: bool = False):
    """x: (B, S, d) -> (out (B, S, d), cache or None).  Decode: ``cache`` =
    {conv: (B, K-1, Di), h: (B, Di, N) float32}, both written in place and
    returned; prefill with ``emit_cache``: a fresh {conv, h}.

    The scan takes the serving launch, or, in ``train`` mode or wherever an
    operand needs a gradient, ``SelectiveScanFn`` on every device (on the
    card the training launch, which keeps the states that the backward
    kernel recomputes from)."""
    cfg = ctx.cfg
    di, r, n = cfg.d_inner, cfg.dt_rank, cfg.ssm.d_state

    xz = x @ p["in_proj"]
    xs, z = xz[..., :di], xz[..., di:]
    xs, new_conv = causal_conv(xs, p["conv_w"], p["conv_b"],
                               cache["conv"] if cache is not None else None)
    xs = F.silu(xs)
    proj = xs @ p["x_proj"]
    dt_full = softplus((proj[..., :r] @ p["dt_proj"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    operands = (xs, dt_full, proj[..., r:r + n], proj[..., r + n:], A,
                p["D"])
    if cache is None and needs_grad(ctx, *operands):
        y, h = scan_ops.selective_scan_autograd(*operands, force=ctx.force)
    else:
        h0 = cache["h"] if cache is not None else None    # updated in place
        y, h = scan_ops.selective_scan(*operands, h0, h_out=h0,
                                       force=ctx.force)
    y = y.to(xs.dtype) * F.silu(z)
    out = y @ p["out_proj"]

    if cache is not None:
        cache["conv"].copy_(new_conv)
        return out, {"conv": cache["conv"], "h": h}
    return out, ({"conv": new_conv, "h": h} if emit_cache else None)
