"""Carry weights and state across from the JAX reference as numpy arrays.

The reference's gate parameters are a dict of arrays (its
``init_params(gate_specs(cfg), key)``), its per-stream gate state a
``GateState``, its router carry a ``RouterState``
with a ``GateBatchState``, its baselines' and τ-proxy carries the named
tuples ``RDAPState``, ``SniperState`` and ``HistoryState``, its model
parameters and caches (K/V, convolution and recurrent states) nested dicts
and lists of arrays, and its optimizer state an ``AdamWState`` of such
trees; ``np.asarray`` of either side's leaves is all these
functions need, so nothing here imports JAX.  Indices become int64 in the
port; bfloat16 leaves cross as float32 (exact both ways).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gating import GateBatchState, GateState
from repro_torch.core.router import RouterState
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import cache_specs, model_specs
from repro_torch.models.params import leaf_dtype, shard_leaf, tree_map
from repro_torch.serving.policy import HistoryState, RDAPState, SniperState
from repro_torch.train.optimizer import AdamWState

_GATE_FIELDS = ("h", "var_buf", "var_idx", "var_sum", "var_sumsq")


def gate_params_from_numpy(params, device="cuda") -> dict:
    """{name: array} gate parameters -> {name: float32 tensor} on device."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in params.items()}


def gate_params_to_numpy(params) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def gate_state_from_numpy(state, device="cuda") -> GateState:
    """A reference ``GateState`` (one stream's or a batch's; or a dict with
    ``h``, ``var_buf`` and ``var_idx``) -> the port's :class:`GateState`
    on device (the step count as int64)."""
    dev = resolve_device(device)
    get = state.get if isinstance(state, dict) else \
        lambda k: getattr(state, k)
    return GateState(**{
        k: torch.from_numpy(np.array(get(k))).to(
            device=dev, dtype=torch.int64 if k == "var_idx" else
            torch.float32)
        for k in ("h", "var_buf", "var_idx")})


def gate_state_to_numpy(state: GateState) -> dict:
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in ("h", "var_buf", "var_idx")}


def router_state_from_numpy(state, device="cuda") -> RouterState:
    """A reference ``RouterState`` (or anything with ``prev_route``,
    ``prev_tau`` and ``gate.{h, var_buf, var_idx, var_sum, var_sumsq}``)
    -> the port's :class:`RouterState` on device (indices as int64)."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.from_numpy(np.array(x)).to(device=dev, dtype=dtype)

    gate = GateBatchState(**{
        k: t(getattr(state.gate, k),
             torch.int64 if k == "var_idx" else torch.float32)
        for k in _GATE_FIELDS})
    return RouterState(prev_route=t(state.prev_route, torch.int64),
                       prev_tau=t(state.prev_tau, torch.float32), gate=gate)


def router_state_to_numpy(state: RouterState) -> dict:
    """Flat dict of numpy arrays: prev_route, prev_tau, gate.<field>."""
    out = {"prev_route": state.prev_route.cpu().numpy(),
           "prev_tau": state.prev_tau.cpu().numpy()}
    for k in _GATE_FIELDS:
        out[f"gate.{k}"] = getattr(state.gate, k).cpu().numpy()
    return out


# field dtypes of the policy carries in the port
_CARRIES = {
    RDAPState: {"z_ema": torch.float32, "has": torch.bool},
    SniperState: {"key": torch.float32, "route": torch.int64,
                  "r": torch.int64, "p": torch.int64, "v": torch.int64,
                  "has": torch.bool, "warmup": torch.bool},
    HistoryState: {"prev_route": torch.int64, "prev_tau": torch.float32},
}


def policy_state_from_numpy(kind, state, device="cuda"):
    """A reference ``RDAPState``, ``SniperState`` or ``HistoryState`` (or
    anything with the same fields) -> the port's ``kind`` on device."""
    dev = resolve_device(device)
    return kind(**{
        k: torch.from_numpy(np.array(getattr(state, k))).to(device=dev,
                                                            dtype=dt)
        for k, dt in _CARRIES[kind].items()})


def policy_state_to_numpy(state) -> dict:
    """A port policy carry -> {field: numpy array}."""
    return {k: getattr(state, k).cpu().numpy() for k in state._fields}


def _f32(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def model_params_from_numpy(params, cfg: ModelConfig, device="cuda",
                            serve: bool = False):
    """A reference parameter tree (``init_params(model_specs(cfg, serve),
    key)``) -> the port's: each leaf in its spec's dtype (the compute dtype;
    float32 for the norm scales and the int8 experts' scales; int8 for
    serve-time quantized expert weights, exact through float32) on
    ``device``."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.compute_dtype)
    return tree_map(
        lambda spec, x: torch.from_numpy(_f32(x)).to(
            device=dev, dtype=leaf_dtype(spec, dt)),
        model_specs(cfg, serve=serve), params)


def opt_state_from_numpy(state, device="cuda") -> AdamWState:
    """A reference ``AdamWState`` (or anything with ``step``, ``mu`` and
    ``nu``) -> the port's on ``device``: the step int32, the moments
    float32 in the parameters' tree."""
    dev = resolve_device(device)
    moments = lambda tree: tree_map(lambda x: torch.from_numpy(_f32(x)).to(
        dev), tree)
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        mu=moments(state.mu), nu=moments(state.nu))


def opt_state_to_numpy(state: AdamWState) -> dict:
    """{"step": int, "mu": tree, "nu": tree} of numpy float32 copies."""
    return {"step": int(state.step), "mu": tree_to_numpy(state.mu),
            "nu": tree_to_numpy(state.nu)}


def cache_from_numpy(cache, cfg: ModelConfig, device="cuda", *,
                     placements=None, mesh=None) -> dict:
    """A reference cache or slab ({length, segments}) -> the port's: each
    leaf in its cache spec's dtype (K/V and convolution states in the
    compute dtype, recurrent states ``h`` in float32), ``length`` (scalar
    or (B,)) int32.  With ``placements`` (``model.cache_placements`` of the
    whole cache's shapes) and ``mesh``: this rank's block of each leaf, and
    ``"cache_len"`` the whole attention cache's length, as a prefill under
    the serve rules emits them."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.compute_dtype)
    specs = cache_specs(cfg, 1, 1)["segments"]     # dtypes, not shapes

    def leaf(spec, x, pl=None):
        t = torch.from_numpy(_f32(x)).to(dtype=leaf_dtype(spec, dt))
        return (t if pl is None else shard_leaf(t, pl, mesh)).to(dev)

    more = () if placements is None else (placements["segments"],)
    out = {
        "length": torch.from_numpy(np.array(cache["length"], np.int32)).to(dev),
        "segments": tree_map(leaf, specs, cache["segments"], *more),
    }
    k_shapes = [layer["k"].shape for seg in (placements or {}).get(
        "segments", ()) for layer in seg.values() if "k" in layer]
    if k_shapes:        # a stacked K: (layers, B, C, KV, D)
        out["cache_len"] = k_shapes[0][2]
    return out


def tree_to_numpy(tree):
    """Port tensors -> numpy copies (floating leaves as float32, integer
    leaves such as int8 expert weights in their own dtype), which
    later in-place writes of the port (a decode step into its slab) leave
    unchanged."""
    return tree_map(lambda t: t if not isinstance(t, torch.Tensor) else
                    np.array((t.float() if t.is_floating_point()
                              else t).cpu()), tree)
