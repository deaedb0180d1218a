"""GPipe-style pipeline parallelism over a mesh dim (``"stage"``): port of
``repro/sharding/pipeline.py`` (``split_stages``, ``pipeline``,
``bubble_fraction``).

The layer stack is split into S contiguous stages (stage s holds the
stacked parameters of its layers); microbatches stream through with
``ppermute`` moving activations from stage to stage.  The schedule is the
classic GPipe fill-drain: step t runs microbatch t − s on stage s when
0 <= t − s < M, so the wall clock is M + S − 1 stage steps and the bubble
fraction (S − 1)/(M + S − 1).

Where the reference runs the body under ``shard_map`` on every device of
the mesh, each rank here runs it for its own stage.  A stage outside its
window (the bubble) computes nothing and sends zeros, where the
reference's stage computes on inputs whose results are never kept; the
kept outputs are the same.  The last stage's outputs reach every stage by
a sum over the stage dim (zeros elsewhere), as in the reference.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.params import tree_map
from repro_torch.sharding.collectives import ppermute, psum_ordered, \
    shard_count, shard_index


def split_stages(layer_params, n_stages: int):
    """Stacked per-layer parameters (leading layer dim L) -> (S, L/S, ...)
    each (views)."""

    def re(x):
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             f"stages")
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])

    return tree_map(re, layer_params)


def pipeline(stage_fn: Callable, mesh, *, axis: str = "stage"):
    """Build a pipelined apply ``(stage_params, microbatches) -> outputs``.

    ``stage_fn(params, x)`` applies ONE stage's layers to activations x.
    ``stage_params``: this rank's stage (the reference's stage slice
    ``params[s]``, e.g. ``split_stages(...)[s]``); ``microbatches`` (M,
    ...) activations, fed to stage 0 (every rank gives them).  Returns the
    (M, ...) outputs of the final stage on every rank.  A collective call
    along ``axis``."""
    s_count = shard_count(mesh, axis)
    ring = [(i, (i + 1) % s_count) for i in range(s_count)]

    def apply(params, xs):
        sidx = shard_index(mesh, axis)
        m = xs.shape[0]
        state = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(m + s_count - 1):
            if 0 <= t - sidx < m:
                y = stage_fn(params, xs[t] if sidx == 0 else state)
                if sidx == s_count - 1:
                    outs[t - sidx] = y
            else:
                y = torch.zeros_like(state)
            state = ppermute(y, mesh, axis, ring)
        if sidx != s_count - 1:
            outs.zero_()
        return psum_ordered(outs, mesh, axis)

    return apply


def bubble_fraction(n_microbatches: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
