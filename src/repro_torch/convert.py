"""Carry weights and state across from the JAX reference as numpy arrays.

The reference's gate parameters are a dict of arrays (its
``init_params(gate_specs(cfg), key)``) and its router carry a
``RouterState`` with a ``GateBatchState``; ``np.asarray`` of either side's
leaves is all these functions need, so nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gating import GateBatchState
from repro_torch.core.router import RouterState
from repro_torch.device import resolve_device

_GATE_FIELDS = ("h", "var_buf", "var_idx", "var_sum", "var_sumsq")


def gate_params_from_numpy(params, device="cuda") -> dict:
    """{name: array} gate parameters -> {name: float32 tensor} on device."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in params.items()}


def gate_params_to_numpy(params) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


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
