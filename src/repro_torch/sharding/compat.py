"""Batch padding for stream sharding — port of ``repro/sharding/compat.py``
(``pad_leading`` :15).  ``shard_map`` has no counterpart: every rank runs
the same program on its own slice (``torch.distributed``'s SPMD idiom)."""
from __future__ import annotations

import torch


def pad_leading(x: torch.Tensor, pad: int, value=0, axis: int = 0):
    """``x`` with ``pad`` rows of ``value`` appended along ``axis``.

    The idiom behind sharding M streams over any number of ranks: pad with
    inert dummies, shard, slice the real batch back out.  ``pad == 0``
    returns ``x`` itself."""
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=axis)
