"""Parameter specs and their materialisation: port of
``repro/models/params.py`` without the sharding half (ROADMAP A.15).

A model is a tree (nested dicts and lists) of :class:`ParamSpec` leaves.
:func:`init_params` draws each normal leaf in float32 from an explicit
``torch.Generator`` on the target device and casts it, one tensor at a
time, so a large model never holds more than one float32 leaf beside its
weights.

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


def init_params(specs, generator: torch.Generator, device="cuda",
                dtype: torch.dtype = torch.float32):
    """Materialise a spec tree: zeros, ones, or normal draws at each spec's
    ``stddev`` (float32 on ``device`` from ``generator``, which must live on
    that device, then cast to the leaf's dtype)."""
    dev = resolve_device(device)

    def make(spec: ParamSpec):
        dt = leaf_dtype(spec, dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(spec.stddev).to(dt)

    return tree_map(make, specs)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))
