"""Shared layers: port of ``repro/models/layers.py`` (norms, embeddings,
RoPE, the forward context) without sharding constraints."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Forward context: the config, the mode (prefill | decode) and the
    attention kernels' pin (``force``: auto | ref | kernel, as on every
    kernel wrapper)."""
    cfg: ModelConfig
    mode: str = "prefill"
    force: str = "auto"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)


def rmsnorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), dtype="float32", init="ones")}


def rmsnorm(p, x, eps: float):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def embed_specs(cfg: ModelConfig) -> dict:
    out = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), stddev=1.0)}
    if not cfg.tie_embeddings:
        out["out"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                               stddev=cfg.d_model ** -0.5)
    return out


def embed_tokens(ctx: Ctx, p, tokens):
    """Rows of the embedding table (stored in the compute dtype)."""
    return p["tok"][tokens]


def output_weights(cfg: ModelConfig, embed_params):
    if cfg.tie_embeddings:
        return embed_params["tok"].T      # (d, vocab)
    return embed_params["out"]


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S) integers."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (half,)
    angles = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's softplus returns x
    above its threshold instead)."""
    return torch.logaddexp(x, torch.zeros_like(x))


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


def apply_mrope(x, positions3, theta: float, sections):
    raise NotImplementedError("M-RoPE (qwen2-vl) is ROADMAP queue A.14")
