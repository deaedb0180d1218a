"""RG-LRU recurrent mixer (RecurrentGemma / Griffin recurrent block): port
of ``repro/models/rglru.py`` (specs and ``rglru_forward``) on the
``rglru_scan`` kernel.

  x -> [linear -> temporal conv -> RG-LRU]  (recurrent branch)
    -> [linear -> GeLU]                      (gate branch)
  out = W_out (branch_rec * branch_gate)

The scan runs ``kernels/rglru`` (the CUDA kernel for CUDA tensors, its
plain version — the reference model's jnp scan — for CPU tensors;
``ctx.force`` pins either).  Training goes through ``RGLRUScanFn``: the
kernel and the backward kernel on the card, the plain scan and its plain
VJP elsewhere.  A decode step writes its new convolution state and
recurrent state into the cache's layer views in place.

Split over ``"model"`` (training on a mesh, :func:`rglru_tp`): the input
projections, the conv, ``b_a``, ``b_x`` and ``lambda_p`` are the rank's
``rglru_width`` slice, and so is the scan; ``w_a``/``w_x`` (rows over the
width) are row-parallel, their products summed over ``"model"`` and the
rank's slice of the gates taken; ``w_out`` is row-parallel, summed
likewise.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import ops as scan_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx, causal_conv, needs_grad, softplus
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import tensor_parallel as tp

_C = 8.0  # RG-LRU decay temperature (Griffin)


def rglru_specs(cfg: ModelConfig) -> dict:
    """b_a, b_x and lambda_p are float32 leaves: the reference reads them in
    float32."""
    d, w, cw = cfg.d_model, cfg.lru_width, cfg.rglru.conv_width
    return {
        "w_rec_in": ParamSpec((d, w), axes=("embed", "rglru_width"),
                              stddev=d ** -0.5),
        "w_gate_in": ParamSpec((d, w), axes=("embed", "rglru_width"),
                               stddev=d ** -0.5),
        "conv_w": ParamSpec((cw, w), axes=("conv", "rglru_width"),
                            stddev=cw ** -0.5),
        "conv_b": ParamSpec((w,), axes=("rglru_width",), init="zeros"),
        "w_a": ParamSpec((w, w), axes=("rglru_width", None),
                         stddev=w ** -0.5),
        "b_a": ParamSpec((w,), axes=("rglru_width",), dtype="float32",
                         init="zeros"),
        "w_x": ParamSpec((w, w), axes=("rglru_width", None),
                         stddev=w ** -0.5),
        "b_x": ParamSpec((w,), axes=("rglru_width",), dtype="float32",
                         init="zeros"),
        "lambda_p": ParamSpec((w,), axes=("rglru_width",),
                              dtype="float32", init="ones"),
        "w_out": ParamSpec((w, d), axes=("rglru_width", "embed"),
                           stddev=w ** -0.5
                           / math.sqrt(2 * cfg.num_layers)),
    }


def rglru_tp(cfg: ModelConfig, rules) -> tp.Plan:
    """``"split"`` where ``"model"`` splits every leaf along
    ``rglru_width``, else ``"whole"``."""
    specs = rglru_specs(cfg)
    want = {"w_rec_in": 1, "w_gate_in": 1, "conv_w": 1, "conv_b": 0,
            "w_a": 0, "b_a": 0, "w_x": 0, "b_x": 0, "lambda_p": 0,
            "w_out": 0}
    if tp.rules_size(rules) > 1 and tp.split_dims(specs, rules) == want:
        return tp.plan_of(specs, "split", blocks=tuple(want))
    return tp.whole_plan(specs)


def rglru_forward(ctx: Ctx, p, x, *, cache=None, emit_cache: bool = False):
    """x: (B, S, d) -> (out (B, S, d), cache or None).  Decode: ``cache`` =
    {conv: (B, K-1, W), h: (B, W) float32}, both written in place and
    returned; prefill with ``emit_cache``: a fresh {conv, h}.

    The scan takes the kernel's launch, or, in ``train`` mode or wherever an
    operand needs a gradient, ``RGLRUScanFn`` on every device (on the card
    the same launch, then the backward kernel)."""
    split = tp.layer_mode(ctx, "rglru", rglru_tp) == "split"
    if split:
        x = tp.copy_to_model(x, ctx.mesh)
    rec = x @ p["w_rec_in"]
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu(x @ p["w_gate_in"], approximate="tanh")
    rec, new_conv = causal_conv(rec, p["conv_w"], p["conv_b"],
                                cache["conv"] if cache is not None else None)

    def gate_in(w):     # row-parallel: summed, then this rank's slice
        out = rec @ w
        if split:
            out = tp.scatter_to_model(tp.reduce_from_model(out, ctx.mesh),
                                      ctx.mesh)
        return out.float()

    rgate = torch.sigmoid(gate_in(p["w_a"]) + p["b_a"])
    igate = torch.sigmoid(gate_in(p["w_x"]) + p["b_x"])
    log_a_base = -_C * softplus(p["lambda_p"])
    if cache is None and needs_grad(ctx, rec, rgate, igate, log_a_base):
        y, h = scan_ops.rglru_scan_autograd(rec, rgate, igate, log_a_base,
                                            force=ctx.force)
    else:
        h0 = cache["h"] if cache is not None else None    # updated in place
        y, h = scan_ops.rglru_scan(rec, rgate, igate, log_a_base, h0,
                                   h_out=h0, force=ctx.force)
    y = y.to(rec.dtype) * gate
    out = y @ p["w_out"]
    if split:
        out = tp.reduce_from_model(out, ctx.mesh)

    if cache is not None:
        cache["conv"].copy_(new_conv)
        return out, {"conv": cache["conv"], "h": h}
    return out, ({"conv": new_conv, "h": h} if emit_cache else None)
