"""Logical-axis -> mesh-axis sharding rules: port of
``repro/sharding/rules.py`` (``TRAIN_BASE``, ``SERVE_BASE``,
``ShardingRules``, ``make_rules``, ``logical_spec``), pure Python.

Every parameter dimension carries a *logical* axis name (``ParamSpec.axes``);
a :class:`ShardingRules` table maps logical names onto the dims of a
``torch.distributed`` ``DeviceMesh`` by name.  A spec is a tuple with one
entry a tensor dim: ``None`` (whole), a mesh dim's name, or a tuple of
names (the dim split over their product, the first name major), as the
reference's ``PartitionSpec``.  The reference's rules hold: no mesh dim
appears twice in one spec, and :meth:`ShardingRules.fitted_spec` drops
mesh dims that do not divide a tensor dim, from the right.

Where the reference turns a spec into a ``NamedSharding`` for GSPMD, the
port turns it into a :class:`Placement`: which mesh dims split which
tensor dim, the mesh dims of size 1 left out (they split nothing).
``models/params.py`` cuts and gathers blocks by it.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Union

Axis = Union[str, Sequence[str], None]
Spec = tuple        # one entry a dim: None, a mesh dim's name, or a tuple

# "data" is the FSDP/DP axis; "model" the TP/EP axis.  On a multi-pod mesh
# "pod" is put before every entry that holds "data".
TRAIN_BASE: dict[str, Axis] = {
    # activations
    "batch": "data",
    "act_seq": None,          # sequence dim inside blocks
    "act_seq_sp": "model",    # sequence-parallel residual saves at layer edges
    "act_embed": None,
    # weights
    "embed": "data",          # FSDP shard of the d_model dim of weights
    "vocab": "model",
    "heads": "model",
    "heads_flat": "model",    # fused H*head_dim weight dim
    "kv_heads": "model",
    "head_dim": None,
    "qk": None,
    "mlp": "model",
    "experts": "model",
    "expert_in": "data",      # FSDP dim of expert weights
    "expert_mlp": None,
    "layers": None,           # the stacked layer dim
    # ssm / rglru
    "inner": "model",
    "state": None,
    "conv": None,
    "dt_rank": None,
    "rglru_width": "model",
    # kv cache
    "cache_batch": "data",
    "cache_seq": "model",
    "cache_kv": None,
    "cache_dim": None,
}

SERVE_BASE: dict[str, Axis] = dict(
    TRAIN_BASE,
    **{
        "embed": None,        # no FSDP at serve time by default
        "act_seq_sp": None,
        "expert_in": None,
        "cache_seq": "model",
        "cache_kv": None,
    },
)


def _names(entry) -> tuple:
    """A spec entry as a tuple of mesh dim names (``()`` for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes: tuple):
    """The spec entry of a tuple of names: None, a name, or the tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf's blocks lie on a mesh: ``dims[i]`` the mesh dims
    (names, the first major) that split tensor dim ``i``, ``()`` where the
    dim is whole; ``shape`` the whole leaf's.  Mesh dims named nowhere
    hold the leaf replicated."""
    shape: tuple
    dims: tuple

    @property
    def split_axes(self) -> tuple:
        """Every mesh dim that splits the leaf, in tensor-dim order."""
        return tuple(a for axes in self.dims for a in axes)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mapping: Mapping[str, Axis]
    mesh_axes: tuple
    mesh_sizes: Mapping[str, int] = dataclasses.field(default_factory=dict)

    def axis(self, name: Optional[str]) -> Axis:
        if name is None:
            return None
        if name not in self.mapping:
            raise KeyError(f"unknown logical axis {name!r}")
        return self.mapping[name]

    def spec(self, logical_axes: Sequence[Optional[str]]) -> Spec:
        """The mesh dims of each logical axis, each mesh dim at most once
        (the first logical axis to name it keeps it)."""
        used: set = set()
        parts = []
        for name in logical_axes:
            axes = tuple(a for a in _names(self.axis(name))
                         if a in self.mesh_axes and a not in used)
            used.update(axes)
            parts.append(_entry(axes))
        return tuple(parts)

    def fitted_spec(self, logical_axes: Sequence[Optional[str]],
                    shape: Sequence[int],
                    sizes: Optional[Mapping[str, int]] = None) -> Spec:
        """``spec`` with the mesh dims that do not divide a tensor dim
        dropped, from the right."""
        sizes = sizes or self.mesh_sizes
        spec = self.spec(logical_axes)
        spec = spec + (None,) * (len(shape) - len(spec))
        parts = []
        for dim, entry in zip(shape, spec):
            axes = _names(entry)
            while axes:
                total = 1
                for a in axes:
                    total *= sizes.get(a, 1)
                if dim % total == 0:
                    break
                axes = axes[:-1]
            parts.append(_entry(axes))
        return tuple(parts)

    def placement(self, logical_axes: Sequence[Optional[str]],
                  shape: Sequence[int]) -> Placement:
        """The counterpart of the reference's ``fitted_sharding``: the
        fitted spec as a :class:`Placement`, mesh dims of size 1 left
        out."""
        spec = self.fitted_spec(logical_axes, shape)
        return Placement(tuple(shape), tuple(
            tuple(a for a in _names(e) if self.mesh_sizes.get(a, 1) > 1)
            for e in spec))


def mesh_sizes(mesh) -> dict:
    """{dim name: size} of a ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and ``shape``)."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims need names (mesh_dim_names)")
    return dict(zip(names, tuple(mesh.shape)))


def make_rules(mesh, mode: str = "train",
               overrides: Optional[Mapping[str, Axis]] = None
               ) -> ShardingRules:
    """A rule table adapted to ``mesh`` (a ``DeviceMesh``; its dim names
    and shape are all it reads): mesh dims it lacks are dropped from every
    entry, and on a mesh with a ``"pod"`` dim, ``"pod"`` goes before every
    entry that holds ``"data"``."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
    base = dict(TRAIN_BASE if mode == "train" else SERVE_BASE)
    if overrides:
        base.update(overrides)
    sizes = mesh_sizes(mesh)
    mesh_axes = tuple(sizes)
    multi_pod = "pod" in mesh_axes

    def adapt(ax: Axis) -> Axis:
        axes = tuple(a for a in _names(ax) if a in mesh_axes)
        if multi_pod and "data" in axes and "pod" not in axes:
            axes = ("pod",) + axes
        return _entry(axes)

    return ShardingRules({k: adapt(v) for k, v in base.items()}, mesh_axes,
                         sizes)


def logical_spec(rules: ShardingRules, *logical_axes: Optional[str]) -> Spec:
    return rules.spec(logical_axes)
