"""Tail latency of serving samples: port of ``p99`` from
``repro/runtime/straggler.py`` (the interpolated quantile of the reference's
``p99_jnp``).  Hedged dispatch is ROADMAP queue A.9."""
from __future__ import annotations

import torch


def quantile(samples, q: float) -> float:
    """The ``q``-quantile of the samples, linearly interpolated (as
    ``jnp.quantile``'s default), in float32."""
    t = torch.as_tensor(samples, dtype=torch.float32).flatten()
    return float(torch.quantile(t, q))


def p99(samples) -> float:
    return quantile(samples, 0.99)
