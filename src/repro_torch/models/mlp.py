"""Gated MLP (SwiGLU / GeGLU): port of ``repro/models/mlp.py``.  Split over
``"model"`` (:func:`mlp_tp`): ``w_gate``/``w_up`` column-parallel and
``w_down`` row-parallel over ``mlp``, its product summed over
``"model"``."""
from __future__ import annotations

import math

import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import tensor_parallel as tp


def mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s_in = d ** -0.5
    s_out = f ** -0.5 / math.sqrt(2 * cfg.num_layers)
    return {
        "w_gate": ParamSpec((d, f), axes=("embed", "mlp"), stddev=s_in),
        "w_up": ParamSpec((d, f), axes=("embed", "mlp"), stddev=s_in),
        "w_down": ParamSpec((f, d), axes=("mlp", "embed"), stddev=s_out),
    }


def mlp_tp(cfg: ModelConfig, rules) -> tp.Plan:
    """``"split"`` where ``"model"`` splits the three weights by ``mlp``,
    else ``"whole"``."""
    specs = mlp_specs(cfg)
    if tp.rules_size(rules) > 1 and tp.split_dims(specs, rules) == {
            "w_gate": 1, "w_up": 1, "w_down": 0}:
        return tp.plan_of(specs, "split", blocks=tuple(specs))
    return tp.whole_plan(specs)


def mlp_forward(ctx: Ctx, p, x, activation: str = "silu"):
    split = tp.layer_mode(ctx, "mlp", mlp_tp) == "split"
    if split:
        x = tp.copy_to_model(x, ctx.mesh)
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    # jax.nn.gelu's default is the tanh approximation
    h = (F.gelu(g, approximate="tanh") if activation == "gelu"
         else F.silu(g)) * u
    y = h @ p["w_down"]
    return tp.reduce_from_model(y, ctx.mesh) if split else y
