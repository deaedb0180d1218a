"""Shared layers: port of ``repro/models/layers.py`` (norms, embeddings,
RoPE, the forward context).  The reference's ``Ctx.constrain`` (a GSPMD
placement hint that leaves the numbers as they are) has no counterpart:
the port places each tensor explicitly (``models/params.py``) and splits
each layer's compute over ``"model"`` by hand
(``sharding/tensor_parallel.py``)."""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, leaf_view
from repro_torch.sharding import tensor_parallel as tp


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Forward context: the config, the mode (train | prefill | decode;
    ``train``, the reference's default, runs a prefill-shaped forward with
    each layer under activation checkpointing where ``cfg.remat``, and the
    attention kernel through its autograd function), the kernels' pin
    (``force``: auto | ref | kernel, as on every kernel wrapper) and what
    the forward needs to know about the ranks: ``mesh``, a ``DeviceMesh``
    whose ``"data"`` dim splits the batch, or None (the whole batch is
    here).  With a mesh, :func:`~repro_torch.models.model.loss_fn` returns
    this rank's share of the loss over the global batch (the mask count
    and the MoE load statistics summed over ``"data"``), so the shares and
    their gradients sum over ``"data"`` to the global loss and its
    gradient.  ``rules`` (with a mesh whose ``"model"`` dim is above 1):
    the train rules that placed the leaves, from which each layer reads
    whether ``"model"`` splits each of its leaves and so the mode it runs
    (``sharding/tensor_parallel.py``); the forward then takes
    :class:`~repro_torch.models.params.MeshLeaf` leaves."""
    cfg: ModelConfig
    mode: str = "train"
    force: str = "auto"
    mesh: object = None
    rules: object = None

    @functools.cached_property
    def tp_modes(self) -> dict:
        """{layer kind: the mode it runs over ``"model"``}, each read from
        its plan once (:func:`~repro_torch.sharding.tensor_parallel.layer_mode`)."""
        return {}

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)


def rmsnorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), axes=("act_embed",), dtype="float32",
                               init="ones")}


def rmsnorm(p, x, eps: float):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def embed_specs(cfg: ModelConfig) -> dict:
    """The token table (none where the front end feeds embeddings:
    ``cfg.embed_inputs=False``) and the output head unless tied."""
    out = {}
    if cfg.embed_inputs:
        out["tok"] = ParamSpec((cfg.vocab_size, cfg.d_model),
                               axes=("vocab", "embed"), stddev=1.0)
    if not cfg.tie_embeddings:
        out["out"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                               axes=("embed", "vocab"),
                               stddev=cfg.d_model ** -0.5)
    return out


def embed_tp(cfg: ModelConfig, rules) -> tp.Plan:
    """``"vocab"`` where ``"model"`` splits the token table and the head
    by vocab rows (each rank's vocab range), else ``"whole"``."""
    specs = embed_specs(cfg)
    if tp.rules_size(rules) == 1 or not specs:
        return tp.whole_plan(specs)
    dims = tp.split_dims(specs, rules)
    if all(dims[k] == {"tok": 0, "out": 1}[k] for k in specs):
        return tp.plan_of(specs, "vocab", blocks=tuple(specs))
    return tp.whole_plan(specs)


def embed_tokens(ctx: Ctx, p, tokens):
    """Rows of the embedding table (stored in the compute dtype).  Split
    over ``"model"`` by vocab: the rows in this rank's range, zeros
    elsewhere, summed over ``"model"`` (one term nonzero: exact)."""
    tok = leaf_view(p["tok"], "embed")
    if tp.layer_mode(ctx, "embed", embed_tp) == "whole":
        return tok[tokens]
    n = tok.shape[0]
    local = tokens - tp.rank(ctx.mesh) * n
    inside = (local >= 0) & (local < n)
    rows = torch.where(inside[..., None], tok[local.clamp(0, n - 1)], 0)
    return tp.reduce_from_model(rows, ctx.mesh)


def output_weights(cfg: ModelConfig, embed_params):
    """The head (d, vocab), or this rank's vocab columns of it."""
    if cfg.tie_embeddings:
        return leaf_view(embed_params["tok"], "head").T      # (d, vocab)
    return leaf_view(embed_params["out"], "head")


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (half,)
    angles = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    return _rotate(x, angles)


def _rotate(x, angles):
    """x (..., S, H, D) rotated by ``angles`` (..., S, D/2), in float32."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's softplus returns x
    above its threshold instead)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def needs_grad(ctx: Ctx, *tensors) -> bool:
    """A recurrent mixer's scan goes through its autograd function (whose
    backward is the backward kernel on the card) in ``train`` mode, or
    wherever grad is enabled and an operand requires it, as the
    attention's training path does."""
    return ctx.mode == "train" or torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)


def causal_conv(x, w, b, state=None):
    """Depthwise causal convolution of the recurrent mixers (both
    reference models' ``_causal_conv``).  x: (B, S, C); w: (K, C); b: (C,);
    state: (B, K-1, C), the previous K-1 inputs, or None (zeros).  Returns
    (out (B, S, C), the last K-1 inputs (B, K-1, C)), the taps summed in
    order as the reference's ``sum``."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        x_pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(x_pad[:, i:i + s] * w[i] for i in range(k))
    return out + b, x_pad[:, s:]


def mrope_positions(n_text: int, grid: tuple[int, int, int], n_after: int,
                    batch: int = 1, device=None):
    """(batch, 3, S) int32 M-RoPE position ids in Qwen2-VL's layout:
    ``n_text`` text tokens at t = h = w = i; a (frames, rows, cols) patch
    grid at (s0 + frame, s0 + row, s0 + col) with s0 = ``n_text``; then
    ``n_after`` text tokens resuming at the largest id + 1.  The temporal
    stream repeats within a frame, so its causal mask is not the index's."""
    ar = torch.arange
    text = ar(n_text).expand(3, n_text)
    grids = torch.meshgrid(*(ar(n) for n in grid), indexing="ij")
    patches = torch.stack(grids).reshape(3, -1) + n_text
    start = int(patches.max()) + 1 if patches.numel() else n_text
    after = (start + ar(n_after)).expand(3, n_after)
    pos = torch.cat([text, patches, after], dim=1).to(torch.int32)
    return pos.expand(batch, 3, pos.shape[1]).contiguous().to(device)


def apply_mrope(x, positions3, theta: float, sections):
    """M-RoPE (Qwen2-VL): frequency channels split over the (t, h, w)
    position streams, ``sections`` channels each (summing to D/2).

    x: (B, S, H, D); positions3: (B, 3, S).  Each channel's angle is its
    stream's position times its frequency; the reference picks the stream
    by a one-hot sum (the other terms exact zeros), the port by an index:
    the same numbers."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"head_dim/2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (half,)
    stream = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)
    pos = positions3.to(torch.float32)[:, stream]               # (B, half, S)
    return _rotate(x, pos.transpose(1, 2) * freqs)
