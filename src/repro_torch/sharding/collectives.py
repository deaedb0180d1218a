"""The collectives of the sharded serving round, over a ``DeviceMesh``'s
group along one named dim (``"data"``): the reference spells them
``jax.lax.all_gather`` (tiled, along the leading axis), ``jax.lax.psum``
and ``jax.lax.axis_index`` inside ``shard_map``.

On NCCL they run on the device, and a captured round holds them.  On gloo
a CUDA tensor is staged through the host explicitly (copied to the CPU,
exchanged, copied back): the backend follows the caller's choice of
process group, never a fallback.  Only calls present in every supported
torch release are used (``all_gather`` into a list, ``all_reduce``).

Every exchange appends ``(op, elements, inside_round)`` to
:data:`COLLECTIVES`, as the kernel wrappers count their launches:
``elements`` is the size of this rank's operand (the reference audit's
measure), ``inside_round`` whether it ran within :func:`in_round` (the
body of a serving round).  A replayed round graph appends its capture's
records once a replay (``serving/graphs.py``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

COLLECTIVES: list = []          # (op, elements, inside_round), in order
_ROUND = [False]                # whether a serving round is running


@contextlib.contextmanager
def in_round():
    """Mark the collectives made inside as a serving round's."""
    outer = _ROUND[0]
    _ROUND[0] = True
    try:
        yield
    finally:
        _ROUND[0] = outer


def _record(op: str, x: torch.Tensor) -> None:
    COLLECTIVES.append((op, x.numel(), _ROUND[0]))


def _staged(group, x: torch.Tensor) -> bool:
    """Whether ``x`` must go through the host: a CUDA tensor on a group
    whose backend cannot take it on the device (gloo)."""
    return x.device.type == "cuda" and dist.get_backend(group) != "nccl"


def shard_index(mesh, axis: str = "data") -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def shard_count(mesh, axis: str = "data") -> int:
    """The number of shards along ``axis``."""
    return dist.get_world_size(mesh.get_group(axis))


def all_gather(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order along
    ``axis`` (``jax.lax.all_gather(..., tiled=True)``).  Every rank gives
    the same shape and dtype."""
    group = mesh.get_group(axis)
    _record("all_gather", x)
    staged = _staged(group, x)
    # bool travels as uint8: the backends' reductions and copies know it
    y = x.contiguous().view(torch.uint8) if x.dtype == torch.bool \
        else x.contiguous()
    if staged:
        y = y.cpu()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    out = torch.cat(parts, dim=0)
    if staged:
        out = out.to(x.device)
    return out.view(torch.bool) if x.dtype == torch.bool else out


def psum(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` (``jax.lax.psum``); ``x``
    is not written."""
    group = mesh.get_group(axis)
    _record("psum", x)
    staged = _staged(group, x)
    y = x.cpu() if staged else x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device) if staged else y
