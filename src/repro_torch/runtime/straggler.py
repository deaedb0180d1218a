"""Straggler mitigation: hedged dispatch and tail latency — port of
``repro/runtime/straggler.py`` (``hedged_dispatch_jnp``, ``p99``).

A segment goes to its primary replica; if the primary's latency exceeds
the hedge deadline (the q-th quantile of the round's primary draws,
linearly interpolated as ``jnp.quantile``'s default), a backup copy is
dispatched and the first finisher wins.
"""
from __future__ import annotations

import torch


def hedged_dispatch(latencies, *, hedge_quantile: float = 0.9,
                    hedge_cost: float = 0.05):
    """latencies: (..., n_tasks, n_replicas) latency draws per task per
    replica -> (..., n_tasks) realized latency with hedging: the primary
    draw unless it exceeds the hedge deadline (the ``hedge_quantile`` of
    the primary draws along the task axis), where the task also runs on a
    backup and takes min(primary, deadline + backup + cost).  A pool of
    one replica returns the primary draws."""
    lat = torch.as_tensor(latencies, dtype=torch.float32)
    primary = lat[..., 0]
    if lat.shape[-1] < 2:
        return primary
    deadline = torch.quantile(primary, hedge_quantile, dim=-1, keepdim=True)
    backup = lat[..., 1] + deadline + hedge_cost
    return torch.where(primary > deadline, torch.minimum(primary, backup),
                       primary)


def quantile(samples, q: float) -> float:
    """The ``q``-quantile of the samples, linearly interpolated (as
    ``jnp.quantile``'s default), in float32."""
    t = torch.as_tensor(samples, dtype=torch.float32).flatten()
    return float(torch.quantile(t, q))


def p99(samples) -> float:
    return quantile(samples, 0.99)
