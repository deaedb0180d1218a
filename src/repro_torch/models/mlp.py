"""Gated MLP (SwiGLU / GeGLU): port of ``repro/models/mlp.py``."""
from __future__ import annotations

import math

import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.params import ParamSpec


def mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s_in = d ** -0.5
    s_out = f ** -0.5 / math.sqrt(2 * cfg.num_layers)
    return {
        "w_gate": ParamSpec((d, f), axes=("embed", "mlp"), stddev=s_in),
        "w_up": ParamSpec((d, f), axes=("embed", "mlp"), stddev=s_in),
        "w_down": ParamSpec((f, d), axes=("mlp", "embed"), stddev=s_out),
    }


def mlp_forward(ctx: Ctx, p, x, activation: str = "silu"):
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    # jax.nn.gelu's default is the tanh approximation
    h = (F.gelu(g, approximate="tanh") if activation == "gelu"
         else F.silu(g)) * u
    return h @ p["w_down"]
