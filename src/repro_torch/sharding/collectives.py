"""The collectives of the sharded serving round and of training across
ranks, over a ``DeviceMesh``'s group along one named dim: the reference
spells them ``jax.lax.all_gather``, ``jax.lax.psum``, ``jax.lax.pmax``,
``jax.lax.ppermute`` and ``jax.lax.axis_index`` inside ``shard_map`` (and
GSPMD inserts them for the sharded training step).

On NCCL they run on the device, and a captured round holds them.  On gloo
a CUDA tensor is staged through the host explicitly (copied to the CPU,
exchanged, copied back): the backend follows the caller's choice of
process group, never a fallback.  Only calls present in every supported
torch release are used (``all_gather`` into a list, ``all_reduce``,
``isend``/``irecv``).  :func:`psum` and :func:`pmax` are the backends'
``all_reduce``, whose order of summation depends on the backend's
algorithm, chunking and message size; training's float sums use
:func:`psum_ordered` instead, which gathers every rank's operand and adds
them in rank order, so two runs of one world give the same bits on any
backend (on gloo the sum is taken on the host: as many bytes through it
as an ``all_reduce`` where the caller keeps the whole sum, fewer where it
keeps a block).

Every exchange appends ``(op, elements, inside_round)`` to
:data:`COLLECTIVES`, as the kernel wrappers count their launches:
``elements`` is the size of this rank's operand (the reference audit's
measure), ``inside_round`` whether it ran within :func:`in_round` (the
body of a serving round).  A replayed round graph appends its capture's
records once a replay (``serving/graphs.py``).  :data:`TRAFFIC` sums the
host's wall time inside the calls (on gloo the exchange itself; on NCCL
the enqueue) and the bytes staged through the host (both directions).
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

COLLECTIVES: list = []          # (op, elements, inside_round), in order
TRAFFIC = {"seconds": 0.0, "host_bytes": 0}
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


@contextlib.contextmanager
def _timed():
    t0 = time.perf_counter()
    try:
        yield
    finally:
        TRAFFIC["seconds"] += time.perf_counter() - t0


def _to_host(x: torch.Tensor, staged: bool) -> torch.Tensor:
    if not staged:
        return x
    TRAFFIC["host_bytes"] += x.numel() * x.element_size()
    return x.cpu()


def _from_host(y: torch.Tensor, device, staged: bool) -> torch.Tensor:
    if not staged:
        return y
    TRAFFIC["host_bytes"] += y.numel() * y.element_size()
    return y.to(device)


def all_gather(x: torch.Tensor, mesh, axis: str = "data",
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order along
    ``axis`` (``jax.lax.all_gather(..., axis=dim, tiled=True)``).  Every
    rank gives the same shape and dtype."""
    group = mesh.get_group(axis)
    _record("all_gather", x)
    staged = _staged(group, x)
    with _timed():
        # bool travels as uint8: the backends' reductions and copies know it
        y = x.contiguous().view(torch.uint8) if x.dtype == torch.bool \
            else x.contiguous()
        y = _to_host(y, staged)
        parts = [torch.empty_like(y)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group)
        out = _from_host(torch.cat(parts, dim=dim), x.device, staged)
    return out.view(torch.bool) if x.dtype == torch.bool else out


def _all_reduce(op: str, reduce_op, x: torch.Tensor, mesh,
                axis: str) -> torch.Tensor:
    group = mesh.get_group(axis)
    _record(op, x)
    staged = _staged(group, x)
    with _timed():
        y = _to_host(x, staged) if staged else x.clone()
        dist.all_reduce(y, op=reduce_op, group=group)
        return _from_host(y, x.device, staged)


def psum(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` (``jax.lax.psum``); ``x``
    is not written."""
    return _all_reduce("psum", dist.ReduceOp.SUM, x, mesh, axis)


def psum_ordered(x: torch.Tensor, mesh, axis: str = "data",
                 take=None) -> torch.Tensor:
    """``jax.lax.psum`` summed in rank order along ``axis``, no float
    atomics: every rank's ``x`` gathered, then ``x_0 + x_1 + ... + x_{D-1}``
    added one after the other; ``x`` is not written.  ``take`` (a view,
    such as this rank's block of a leaf) is applied to every rank's
    operand before the sum, which then reads only what the caller keeps:
    the sum of the slices is the slice of the sum, bit for bit.  Staged
    through the host, the sum is taken there (IEEE float addition, the
    device's bits) and only its result comes back.  A group of one sums
    nothing: the caller's part is copied where it lies."""
    group = mesh.get_group(axis)
    _record("psum_ordered", x)
    if dist.get_world_size(group) == 1:
        out = x if take is None else take(x)
        return out.clone(memory_format=torch.contiguous_format)
    staged = _staged(group, x)
    with _timed():
        y = _to_host(x.contiguous(), staged)
        parts = [torch.empty_like(y)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group)
        if take is not None:
            parts = [take(p) for p in parts]
        out = parts[0] + parts[1] if len(parts) > 1 else \
            parts[0].clone(memory_format=torch.contiguous_format)
        for p in parts[2:]:
            out = out + p
        return _from_host(out, x.device, staged)


def pmax(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The elementwise maximum of every rank's ``x`` (``jax.lax.pmax``);
    ``x`` is not written."""
    return _all_reduce("pmax", dist.ReduceOp.MAX, x, mesh, axis)


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: ``perm`` lists ``(source, destination)``
    coordinates along ``axis``; this rank sends ``x`` to its destination
    and returns what its source sent (zeros where no rank sends to it).
    Every rank gives the same shape and dtype."""
    group = mesh.get_group(axis)
    me = shard_index(mesh, axis)
    dst = [d for s_, d in perm if s_ == me]
    src = [s_ for s_, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    _record("ppermute", x)
    staged = _staged(group, x)
    with _timed():
        y = _to_host(x.contiguous(), staged)
        out = torch.zeros_like(y)
        reqs = []
        if dst:
            reqs.append(dist.isend(y, dist.get_global_rank(group, dst[0]),
                                   group=group))
        if src:
            reqs.append(dist.irecv(out, dist.get_global_rank(group, src[0]),
                                   group=group))
        for r in reqs:
            r.wait()
        return _from_host(out, x.device, staged)


def barrier(mesh) -> None:
    """Block this host until every rank of ``mesh`` gets here: a
    one-element count along each of its dims in turn, read back on the
    host (on NCCL ``all_reduce`` only queues the sum on the device's
    stream, so the read is what waits for the other ranks)."""
    dev = "cuda" if mesh.device_type == "cuda" else "cpu"
    for axis in mesh.mesh_dim_names:
        n = int(psum(torch.ones(1, device=dev), mesh, axis).item())
        if n != shard_count(mesh, axis):
            raise RuntimeError(f"barrier along {axis!r} counted {n} ranks")
