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

Split over ``"model"`` (training on a mesh, :func:`ssm_tp`): the conv,
``dt_proj``, ``dt_bias``, ``A_log`` and ``D`` are the rank's ``inner``
channels, and so is the scan (the kernel's training launch and its
backward on ``d_inner/T`` channels); ``x_proj`` is row-parallel, its
product summed over ``"model"`` before dt, B and C are split off, and
``out_proj`` row-parallel, summed likewise.  ``in_proj``'s columns hold x
then z, so the rank's ``"model"`` block of it is not its channels of
either: it is read whole and each rank takes its channels' columns of
both halves (a partial gradient).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx, causal_conv, needs_grad, softplus
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import tensor_parallel as tp


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


def ssm_tp(cfg: ModelConfig, rules) -> tp.Plan:
    """``"split"`` where ``"model"`` splits every ``inner`` leaf but
    ``in_proj`` along ``inner`` (``in_proj`` then read whole: a partial
    gradient), else ``"whole"``."""
    specs = ssm_specs(cfg)
    want = {"conv_w": 1, "conv_b": 0, "x_proj": 0, "dt_proj": 1,
            "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0}
    if tp.rules_size(rules) > 1:
        dims = tp.split_dims(specs, rules)
        if all(dims[k] == v for k, v in want.items()):
            return tp.plan_of(specs, "split", blocks=tuple(want),
                              partial=("in_proj",))
    return tp.whole_plan(specs)


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
    split = tp.layer_mode(ctx, "ssm", ssm_tp) == "split"

    w_in = p["in_proj"]
    if split:       # this rank's channels of x and of z
        x = tp.copy_to_model(x, ctx.mesh)
        c0 = tp.rank(ctx.mesh) * p["D"].shape[0]
        di = p["D"].shape[0]
        w_in = torch.cat([w_in[:, c0:c0 + di],
                          w_in[:, cfg.d_inner + c0:cfg.d_inner + c0 + di]],
                         dim=1)
    xz = x @ w_in
    xs, z = xz[..., :di], xz[..., di:]
    xs, new_conv = causal_conv(xs, p["conv_w"], p["conv_b"],
                               cache["conv"] if cache is not None else None)
    xs = F.silu(xs)
    proj = xs @ p["x_proj"]
    if split:
        proj = tp.copy_to_model(tp.reduce_from_model(proj, ctx.mesh),
                                ctx.mesh)
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
    if split:
        out = tp.reduce_from_model(out, ctx.mesh)

    if cache is not None:
        cache["conv"].copy_(new_conv)
        return out, {"conv": cache["conv"], "h": h}
    return out, ({"conv": new_conv, "h": h} if emit_cache else None)
