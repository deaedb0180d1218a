"""Token-choice top-k MoE with capacity-bounded gather dispatch: port of
``repro/models/moe.py``.

The reference's algorithm, on one device (one dispatch group):

  1. router logits (float32) -> top-k expert ids and a softmax over the k;
  2. each slot's position in its expert by a cumulative sum over the
     flattened (token · k) slot order;
  3. slots at or above the capacity ``cap = min(max(ceil(t·k/E ·
     capacity_factor), min_capacity), t·k)`` are dropped;
  4. an (E, cap) table of token rows (empty entries point at a zero row),
     the gather to (E, cap, d), three grouped products against the (E, d,
     f) expert weights, the gather back per slot and the weighted sum over k.

Capacity is per call, as in the reference: a decode step over a slab of n
slots routes n tokens, a prefill every row of its bucket (padding rows
included).  The grouped products are batched matrix products
(``torch.bmm``), which the reference leaves to XLA outside any Pallas
kernel; routing and dispatch are tensor ops with no host sync.

Across ranks (``ctx.mesh``, training): each rank holding its rows of the
batch is one of the reference's dispatch groups (its groups are the
data-shard count of contiguous batch rows, capacity per group), so the
dispatch above runs on the rank's tokens alone.  The load-balancing loss is
the reference's over every group's tokens: the first-choice counts are
summed over ``"data"`` and the rank returns its share
E · Σ_e density_e · (Σ of its tokens' router probabilities of e) / T, T
the global token count, whose sum over ``"data"`` is the global loss.

Split over ``"model"`` (training on a mesh, :func:`moe_tp`): routing,
capacity and the dispatch table are computed whole on every rank (cheap,
and they must equal the reference's); each rank runs the grouped products
of its ``E/T`` experts' rows of the (E, cap) table (``"experts"``), or,
where the rules split each expert's MLP dim instead (Mixtral's
``sharding_overrides``), every expert on its ``f/T`` columns
(``"expert_mlp"``).  The combine is the rank's partial sum over its slots,
summed over ``"model"`` in rank order: its order of summation differs
from one device's sum over k.  The combine weights enter the split region
through ``copy_to_model``, so the router's gradient is whole on every
rank; the load-balancing loss stays as above.

Top-k ties: ``jax.lax.top_k`` returns the lower expert index first among
equal logits, which fixes the capacity order and the order of the sum over
k; ``torch.topk`` promises no order among ties, so the port takes the first
k columns of a stable descending sort.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.collectives import psum_ordered, shard_count

_EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")
_IN = ("experts", "expert_in", "expert_mlp")     # (E, d, f)
_OUT = ("experts", "expert_mlp", "expert_in")    # (E, f, d)


def moe_specs(cfg: ModelConfig, quantized: bool = False) -> dict:
    """Router (d, E) and stacked expert weights; ``quantized``: int8 expert
    weights with a float32 (E, 1, 1) scale each (the serve-time layout of
    ``cfg.quant_experts_serve``)."""
    e = cfg.moe
    d, f = cfg.d_model, e.d_expert
    s_in = d ** -0.5
    s_out = f ** -0.5 / math.sqrt(2 * cfg.num_layers)
    wdt = "int8" if quantized else None
    specs = {
        "router": ParamSpec((d, e.num_experts), axes=("embed", None),
                            stddev=s_in),
        "w_gate": ParamSpec((e.num_experts, d, f), axes=_IN,
                            dtype=wdt, stddev=s_in),
        "w_up": ParamSpec((e.num_experts, d, f), axes=_IN,
                          dtype=wdt, stddev=s_in),
        "w_down": ParamSpec((e.num_experts, f, d), axes=_OUT,
                            dtype=wdt, stddev=s_out),
    }
    if quantized:
        for name in _EXPERT_WEIGHTS:
            specs[name + "_scale"] = ParamSpec(
                (e.num_experts, 1, 1), axes=("experts", None, None),
                dtype="float32", init="ones")
    return specs


def quantize_expert_params(p: dict) -> dict:
    """Float expert weights -> int8 + per-expert absmax scales (float32),
    over the last two axes (a layer's (E, d, f) leaves, or stacked ones)."""
    out = dict(p)
    for name in _EXPERT_WEIGHTS:
        w = p[name].float()
        scale = w.abs().amax(dim=(-2, -1), keepdim=True) / 127.0
        scale = torch.clamp_min(scale, 1e-12)
        out[name] = torch.clamp(torch.round(w / scale), -127, 127).to(
            torch.int8)
        out[name + "_scale"] = scale
    return out


def _expert_w(p: dict, name: str, dt: torch.dtype):
    w = p[name]
    if w.dtype == torch.int8:
        return w.to(dt) * p[name + "_scale"].to(dt)
    return w.to(dt)


def top_k_first(logits, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, the lower index first among equal values."""
    values, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def route(cfg: ModelConfig, logits):
    """Routing of t tokens (``logits``: (t, E) float32) -> (ids (t·k,),
    weights (t·k,), position in expert (t·k,), keep (t·k,), cap, ids
    (t, k)) in the flattened (token · k) slot order."""
    e = cfg.moe
    t, k, n_exp = logits.shape[0], e.top_k, e.num_experts
    cap = int(math.ceil(t * k / n_exp * e.capacity_factor))
    cap = min(max(cap, e.min_capacity), t * k)
    weights, ids = top_k_first(logits, k)
    weights = torch.softmax(weights, dim=-1)
    flat_ids, flat_w = ids.reshape(t * k), weights.reshape(t * k)
    # the reference's cumulative sum of the (slot, expert) one-hot over the
    # slots, taken along the last axis of its transpose: a scan down the
    # slot axis of a (t·k, E) tensor is a slow outer-axis scan on the card
    # (34 of the 78 ms of device time of a Moonshot 8 × 80 prefill on an
    # H100)
    onehot = (flat_ids[None, :] == torch.arange(
        n_exp, device=logits.device)[:, None]).to(torch.int32)    # (E, t·k)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32).gather(
        0, flat_ids[None])[0].long() - 1
    return flat_ids, flat_w, pos, pos < cap, cap, ids


def moe_tp(cfg: ModelConfig, rules) -> tp.Plan:
    """``"experts"`` where ``"model"`` splits the expert weights by
    expert, ``"expert_mlp"`` where it splits each expert's MLP dim, else
    ``"whole"``.  The router is read whole outside the split region."""
    specs = moe_specs(cfg)
    if tp.rules_size(rules) > 1:
        dims = tp.split_dims(specs, rules)
        experts = [n for n in specs if n != "router"]
        for mode, want in (("experts", {"w_gate": 0, "w_up": 0,
                                        "w_down": 0}),
                           ("expert_mlp", {"w_gate": 2, "w_up": 2,
                                           "w_down": 1})):
            if all(dims[n] == want[n] for n in want):
                return tp.plan_of(specs, mode, blocks=experts)
    return tp.whole_plan(specs)


def moe_forward(ctx: Ctx, p, x):
    """x: (B, S, d) -> (y (B, S, d), the load-balancing loss (float32
    scalar))."""
    cfg = ctx.cfg
    dt = ctx.compute_dtype
    b, s, d = x.shape
    t, k, n_exp = b * s, cfg.moe.top_k, cfg.moe.num_experts
    mode = tp.layer_mode(ctx, "moe", moe_tp)
    xt = x.reshape(t, d)
    logits = (xt @ p["router"].to(dt)).float()
    flat_ids, flat_w, pos, keep, cap, ids = route(cfg, logits)

    # (E, cap) table of token rows, row t (zeros) where no slot landed;
    # dropped slots write to one spare entry past the table
    slot = torch.where(keep, flat_ids * cap + pos, n_exp * cap)
    tokens = torch.arange(t, device=x.device).repeat_interleave(k)
    table = torch.full((n_exp * cap + 1,), t, dtype=torch.long,
                       device=x.device)
    table.scatter_(0, slot, tokens)
    table = table[:-1].view(n_exp, cap)
    first, mine = 0, keep
    if mode != "whole":
        xt = tp.copy_to_model(xt, ctx.mesh)
        flat_w = tp.copy_to_model(flat_w, ctx.mesh)
    if mode == "experts":           # this rank's experts' rows of the table
        n = p["w_gate"].shape[0]
        first = tp.rank(ctx.mesh) * n
        table = table[first:first + n]
        mine = keep & (flat_ids >= first) & (flat_ids < first + n)
    x_pad = torch.cat([xt, xt.new_zeros((1, d))])
    x_exp = x_pad[table]                                        # (E, cap, d)

    g = torch.bmm(x_exp, _expert_w(p, "w_gate", dt))
    u = torch.bmm(x_exp, _expert_w(p, "w_up", dt))
    y_exp = torch.bmm(F.silu(g) * u, _expert_w(p, "w_down", dt))

    # the gather back per slot and the weighted sum over k
    y_slots = y_exp[torch.where(mine, flat_ids - first, 0),
                    torch.clamp(pos, 0, cap - 1)]               # (t·k, d)
    y_slots = torch.where(mine[:, None], y_slots, 0)
    y = (y_slots * flat_w[:, None].to(dt)).reshape(t, k, d).sum(dim=1)
    if mode != "whole":
        y = tp.reduce_from_model(y, ctx.mesh)
    return y.reshape(b, s, d), _load_balance_loss(logits, ids, n_exp,
                                                  ctx.mesh)


def _load_balance_loss(logits, ids, num_experts: int, mesh=None):
    """Switch-style auxiliary loss: E · Σ_e (share of tokens whose first
    choice is e) · (mean router probability of e), over the tokens of every
    rank along ``mesh``'s ``"data"`` dim; with a mesh, this rank's share
    (its own tokens' probabilities over the global count)."""
    probs = torch.softmax(logits, dim=-1)
    counts = F.one_hot(ids[:, 0], num_experts).float().sum(dim=0)
    n = probs.shape[0]
    if mesh is not None:
        counts = psum_ordered(counts, mesh, "data")
        n *= shard_count(mesh, "data")
    return num_experts * torch.sum(counts / n * (probs.sum(dim=0) / n))
