"""Parameter specs and their materialisation: port of
``repro/models/params.py`` without the sharding half (ROADMAP A.15).

A model is a tree (nested dicts and lists) of :class:`ParamSpec` leaves.
:func:`init_params` draws each normal leaf in float32 from an explicit
``torch.Generator`` on the target device and casts it, one tensor at a
time, so a large model never holds more than one float32 leaf beside its
weights.  A leaf of more than ``CHUNKED_DRAW_ELEMENTS`` (2^32) elements —
Moonshot's stacked experts, 8.9e9 each — is drawn one slice of its leading
axis at a time straight into a tensor of its own dtype, so its float32
temporary is one slice; every smaller leaf keeps its whole draw.

Serving weights are stored once in the compute dtype (``dtype`` of
:func:`init_params`) instead of being cast on every use: the reference casts
each weight to the compute dtype inside every einsum (``.astype(dt)``),
which gives the same numbers.  The norm scales, which the reference reads in
float32, are specs with ``dtype="float32"`` and stay float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: Optional[str] = None   # None: the dtype given to init_params
    init: str = "normal"          # normal | zeros | ones
    stddev: float = 0.02


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists (``rest``: trees
    of the same structure, mapped alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def leaf_dtype(spec: ParamSpec, dtype: torch.dtype) -> torch.dtype:
    return dtype if spec.dtype is None else getattr(torch, spec.dtype)


CHUNKED_DRAW_ELEMENTS = 2 ** 32


def init_params(specs, generator: torch.Generator, device="cuda",
                dtype: torch.dtype = torch.float32):
    """Materialise a spec tree: zeros, ones, or normal draws at each spec's
    ``stddev`` (float32 on ``device`` from ``generator``, which must live on
    that device, then cast to the leaf's dtype; a leaf of more than
    ``CHUNKED_DRAW_ELEMENTS`` elements one slice of its leading axis at a
    time).  An integer leaf (int8 expert weights) gets the cast's
    truncation toward zero, as the reference's ``astype``."""
    dev = resolve_device(device)

    def draw(shape, stddev, dt):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(stddev).to(dt)

    def make(spec: ParamSpec):
        dt = leaf_dtype(spec, dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        if math.prod(spec.shape) <= CHUNKED_DRAW_ELEMENTS:
            return draw(spec.shape, spec.stddev, dt)
        out = torch.empty(spec.shape, dtype=dt, device=dev)
        for i in range(spec.shape[0]):
            out[i] = draw(spec.shape[1:], spec.stddev, dt)
        return out

    return tree_map(make, specs)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))
