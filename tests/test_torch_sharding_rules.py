"""The port's sharding rules against the live JAX ``repro.sharding.rules``
and ``repro.models.params.shardings``.

* Every logical axis's ``spec`` and ``fitted_spec`` against the reference's
  ``make_rules`` for train and serve, with and without a pod dim and with
  Mixtral's overrides (``make_rules`` reads only a mesh's dim names and
  shape: stand-ins here); hypothesis shapes as ``tests/test_sharding.py``
  draws them.
* Every registry config's per-leaf placement (full and SMOKE, train and
  serve rules with the config's overrides) against the spec of the
  reference's ``params.shardings`` on 4 host devices at (data, model) =
  (4, 1), (2, 2) and (1, 4), from one JAX subprocess.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

pytest.importorskip("hypothesis")
import hypothesis.strategies as st
from hypothesis import given, settings

from repro.sharding.rules import SERVE_BASE as J_SERVE_BASE
from repro.sharding.rules import TRAIN_BASE as J_TRAIN_BASE
from repro.sharding.rules import make_rules as j_make_rules
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.model import model_specs
from repro_torch.models.params import shardings
from repro_torch.sharding.rules import (
    SERVE_BASE,
    TRAIN_BASE,
    Placement,
    logical_spec,
    make_rules,
)

MESHES = {"dm": (("data", "model"), (2, 4)),
          "dm_odd": (("data", "model"), (3, 16)),
          "pod": (("pod", "data", "model"), (2, 2, 4)),
          "data": (("data",), (4,))}
MIXTRAL = get_config("mixtral-8x22b").sharding_overrides


def _meshes(key):
    names, shape = MESHES[key]
    return (types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(shape)),
            types.SimpleNamespace(mesh_dim_names=names, shape=shape))


def _jspec(p) -> tuple:
    return tuple(p)


def test_rule_tables_are_the_reference_tables():
    assert TRAIN_BASE == J_TRAIN_BASE
    assert SERVE_BASE == J_SERVE_BASE
    assert MIXTRAL == {"train": {"experts": None, "expert_mlp": "model"},
                       "serve": {"experts": None, "expert_mlp": "model"}}


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("overrides", [None, "mixtral"])
def test_every_logical_axis_matches_make_rules(mode, mesh, overrides):
    jm, tm = _meshes(mesh)
    ov = None if overrides is None else MIXTRAL[mode]
    jr, tr = j_make_rules(jm, mode, ov), make_rules(tm, mode, ov)
    assert dict(tr.mapping) == dict(jr.mapping)
    assert tr.mesh_axes == tuple(jr.mesh_axes)
    assert dict(tr.mesh_sizes) == dict(jr.mesh_sizes)
    names = sorted(TRAIN_BASE)
    for name in names:
        assert tr.spec((name,)) == _jspec(jr.spec((name,))), name
        for dim in (1, 2, 3, 6, 8, 16, 48, 96):
            assert tr.fitted_spec((name,), (dim,)) == _jspec(
                jr.fitted_spec((name,), (dim,))), (name, dim)
    # pairs of axes: no mesh dim twice in one spec
    for a in names:
        for b in names:
            assert tr.spec((a, b)) == _jspec(jr.spec((a, b))), (a, b)
            assert logical_spec(tr, a, b) == tr.spec((a, b))


def test_unknown_logical_axis_and_mode_raise():
    _, tm = _meshes("dm")
    with pytest.raises(KeyError, match="unknown logical axis"):
        make_rules(tm).spec(("nope",))
    with pytest.raises(ValueError, match="mode"):
        make_rules(tm, "decode")


AXES = ["batch", "embed", "vocab", "mlp", "experts", "heads_flat",
        "expert_in", "inner", None]


@settings(max_examples=60, deadline=None)
@given(dims=st.lists(st.integers(1, 64), min_size=1, max_size=4),
       axes=st.lists(st.sampled_from(AXES), min_size=1, max_size=4),
       mesh=st.sampled_from(sorted(MESHES)),
       mode=st.sampled_from(["train", "serve"]))
def test_fitted_spec_matches_and_divides(dims, axes, mesh, mode):
    n = min(len(dims), len(axes))
    dims, axes = tuple(dims[:n]), tuple(axes[:n])
    jm, tm = _meshes(mesh)
    tr = make_rules(tm, mode)
    got = tr.fitted_spec(axes, dims)
    assert got == _jspec(j_make_rules(jm, mode).fitted_spec(axes, dims))
    sizes = dict(zip(*MESHES[mesh]))
    pl = tr.placement(axes, dims)
    assert isinstance(pl, Placement) and pl.shape == dims
    for dim, entry, split in zip(dims, got, pl.dims):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        assert dim % int(np.prod([sizes[a] for a in names])) == 0
        assert split == tuple(a for a in names if sizes[a] > 1)


JAX_SCRIPT = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
from jax.sharding import AxisType
from repro.configs import ARCH_IDS, get_config, get_smoke_config
from repro.models import model_specs
from repro.models.params import shardings
from repro.sharding.rules import make_rules

out = {}
for shape in ((4, 1), (2, 2), (1, 4)):
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    for arch in ARCH_IDS:
        for size, cfg in (("full", get_config(arch)),
                          ("smoke", get_smoke_config(arch))):
            for mode in ("train", "serve"):
                rules = make_rules(mesh, mode,
                                   cfg.sharding_overrides.get(mode))
                sh = shardings(model_specs(cfg, serve=mode == "serve"),
                               mesh, rules)
                paths, _ = jax.tree_util.tree_flatten_with_path(sh)
                out[shape, arch, size, mode] = {
                    "/" + "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                                  k)))
                                   for k in kp): tuple(s.spec)
                    for kp, s in paths}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_shardings(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_rules") / "ref.pkl"
    done = subprocess.run(
        [sys.executable, "-c", torch_threads.child_script(JAX_SCRIPT),
         str(path)], capture_output=True, text=True, timeout=300,
        env=torch_threads.subprocess_env(JAX_PLATFORMS="cpu"))
    assert done.returncode == 0, done.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_places_each_leaf_as_jax(jax_shardings, arch):
    for shape in ((4, 1), (2, 2), (1, 4)):
        mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                     shape=shape)
        for size, cfg in (("full", get_config(arch)),
                          ("smoke", get_smoke_config(arch))):
            for mode in ("train", "serve"):
                rules = make_rules(mesh, mode,
                                   cfg.sharding_overrides.get(mode))
                specs = model_specs(cfg, serve=mode == "serve")
                want = jax_shardings[shape, arch, size, mode]
                got = dict(_flatten(shardings(specs, mesh, rules)))
                spec_of = dict(_flatten(specs))
                assert sorted(got) == sorted(want)
                sizes = dict(zip(("data", "model"), shape))
                for path, pl in got.items():
                    spec = _pad(want[path], len(pl.shape))
                    split = tuple(
                        tuple(a for a in ((e,) if isinstance(e, str)
                                          else (e or ())) if sizes[a] > 1)
                        for e in spec)
                    assert pl.dims == split, (shape, size, mode, path)
                    assert rules.fitted_spec(
                        spec_of[path].axes or (None,) * len(pl.shape),
                        pl.shape) == spec, (shape, size, mode, path)
