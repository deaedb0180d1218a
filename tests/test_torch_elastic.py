"""Elastic serving in the port against the JAX package: ``ClusterSim`` and
``elastic_remesh``'s rules case by case, and ``ServeSession.run_elastic``
over survivor meshes of gloo ranks.

``{3: [3, 2]}`` (4 → 2 ranks at M = 64) is held to the live JAX
``run_elastic`` on 4 host devices; ``{2: [3], 5: [2]}`` (4 → 3 → 2: 64
streams on 3 ranks, which the JAX sharded run cannot slice back) to the
JAX dense run.  Decisions exact, metrics within 1e-5 relative, the final
carry equal; ranks that sat a segment out return the same outputs.  The
JAX references run in one subprocess with 4 host devices.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_sharded_ranks import elastic_ranks, obs_from_numpy, policy

from repro.runtime.cluster import ClusterSim as JClusterSim
from repro.runtime.cluster import elastic_remesh as j_elastic_remesh
from repro_torch.launch.mesh import run_ranks, single_rank_group
from repro_torch.runtime.cluster import ClusterSim, elastic_remesh
from repro_torch.serving.session import ServeSession

PLANS = [{3: [3, 2]}, {2: [3], 5: [2]}]
MESH_CASES = ((4, "model", 1), (4, "data", 1), (3, "data", 1),
              (2, "model", 2), (4, "data", 2))
DEC_KEYS = ("route", "r", "p", "v")

JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro.core.cost_model import SystemConfig
from repro.runtime.cluster import elastic_remesh
from repro.serving.policy import make_policy
from repro.serving.session import ServeSession
from repro.serving.simulator import SimConfig, Simulator

out = {}
sys_ = SystemConfig()
simc = SimConfig(n_tasks=64, n_rounds=8, seed=11, bw_fluctuation=0.2)
stream = Simulator(sys_, simc).sample_stream(8)
for k in ("z", "aq", "bw_mult", "u"):
    out[f"stream/{k}"] = np.asarray(getattr(stream, k))
for n, prefer, min_model in %(cases)r:
    mesh = elastic_remesh(n, prefer=prefer, min_model=min_model)
    out[f"mesh/{n}/{prefer}/{min_model}"] = np.asarray(mesh.devices.shape)
runs = {"dense": None, "elastic": {3: [3, 2]}}
for label, failures in runs.items():
    sess = ServeSession(make_policy("r2evid", sys_), 64, sim=simc)
    mets = (sess.run(stream) if failures is None
            else sess.run_elastic(stream, failures))
    for k, v in mets.items():
        out[f"{label}/{k}"] = np.asarray(v)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(sess.state)):
        out[f"{label}_state/{i}"] = np.asarray(leaf)
    if failures is not None:
        out["elastic_sizes"] = np.asarray(
            [m.shape["data"] for _, m in sess.mesh_history])
np.savez(sys.argv[1], **out)
"""


def _prefixed(ref, prefix):
    n = len(prefix) + 1
    return {k[n:]: ref[k] for k in ref if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_elastic") / "ref.npz"
    script = JAX_SCRIPT % {"cases": MESH_CASES}
    done = subprocess.run(
        [sys.executable, "-c", torch_threads.child_script(script), str(path)],
        capture_output=True, text=True, timeout=300,
        env=torch_threads.subprocess_env(JAX_PLATFORMS="cpu"))
    assert done.returncode == 0, done.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def ranks(jax_ref):
    return run_ranks(elastic_ranks, 4, backend="gloo", timeout=120,
                     args=(_prefixed(jax_ref, "stream"), PLANS))


# ---------------------------------------------------------------------------
# the cluster's rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", range(4))
def test_cluster_sim_matches_reference(case):
    """The same heartbeats, kills and clock on both: the same nodes
    declared dead at each tick and the same survivor counts."""
    rng = np.random.default_rng(case)
    n = int(rng.integers(2, 9))
    timeout = float(rng.choice([1.0, 2.5, 3.0]))
    a, b = ClusterSim(n, timeout), JClusterSim(n, timeout)
    for _ in range(12):
        if rng.random() < 0.2:
            node = int(rng.integers(n))
            a.kill(node)
            b.kill(node)
        beats = None if rng.random() < 0.3 else {
            int(i) for i in np.nonzero(rng.random(n) < 0.7)[0]}
        dt = float(rng.choice([0.5, 1.0, 2.0]))
        assert a.tick(dt, beats) == b.tick(dt, beats)
        assert a.alive == b.alive and a.dead == b.dead
        assert a.last_seen == b.last_seen


def test_cluster_tick_detects_silent_nodes():
    c = ClusterSim(2, heartbeat_timeout=1.0)
    assert c.tick(dt=1.0, heartbeats={0}) == set()
    assert c.tick(dt=1.0, heartbeats={0}) == {1}
    assert c.alive == 1


@pytest.mark.parametrize("kw,match", [
    (dict(n_devices=0), "at least one surviving device"),
    (dict(n_devices=-2), "at least one surviving device"),
    (dict(n_devices=1, prefer="diagonal"), "prefer"),
    (dict(n_devices=1, prefer="data", min_model=2), "not divisible")])
def test_elastic_remesh_refusals_match_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        j_elastic_remesh(**kw)
    with single_rank_group("gloo"), pytest.raises(ValueError, match=match):
        elastic_remesh(**kw)


def test_elastic_remesh_single_rank():
    with single_rank_group("gloo"):
        mesh = elastic_remesh(1, prefer="data")
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(elastic_remesh(None).mesh.shape) == (1, 1)


@pytest.mark.parametrize("case", MESH_CASES)
def test_elastic_remesh_shapes_match_reference(jax_ref, ranks, case):
    """Survivor meshes on 4 ranks: the reference's (data, model) shape for
    each count, ``prefer`` and ``min_model``, over ranks 0..n-1."""
    n, prefer, min_model = case
    want = tuple(jax_ref[f"mesh/{n}/{prefer}/{min_model}"])
    for res in ranks:
        shape, inside = res["meshes"][case]
        assert shape == want
    assert [res["meshes"][case][1] for res in ranks] == \
        [r < n for r in range(4)]


# ---------------------------------------------------------------------------
# run_elastic
# ---------------------------------------------------------------------------
def _assert_run(got, want, state_got, state_want):
    assert set(got) == set(want)
    for k in DEC_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in set(want) - set(DEC_KEYS):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert len(state_got) == len(state_want)
    for i, leaf in enumerate(state_got):
        np.testing.assert_allclose(leaf, state_want[str(i)], rtol=1e-5,
                                   atol=1e-6)


def test_run_elastic_matches_live_jax(jax_ref, ranks):
    """{3: [3, 2]}: 4 ranks for rounds 0-2, the survivor mesh of 2 for
    3-7, against the live JAX run_elastic on 4 host devices."""
    run = ranks[0]["runs"][0]
    assert run["sizes"] == list(jax_ref["elastic_sizes"]) == [4, 2]
    _assert_run(run["out"], _prefixed(jax_ref, "elastic"), run["state"],
                _prefixed(jax_ref, "elastic_state"))


def test_run_elastic_on_uneven_survivors_matches_jax_dense(jax_ref, ranks):
    """{2: [3], 5: [2]}: 4 → 3 → 2 ranks, 64 streams on 3 ranks padded to
    66, against the JAX dense run."""
    run = ranks[0]["runs"][1]
    assert run["sizes"] == [4, 3, 2]
    _assert_run(run["out"], _prefixed(jax_ref, "dense"), run["state"],
                _prefixed(jax_ref, "dense_state"))


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_ranks_that_sat_out_return_the_same_run(ranks, plan):
    want = ranks[0]["runs"][plan]
    for res in ranks[1:]:
        got = res["runs"][plan]
        assert got["sizes"] == want["sizes"]
        for k in want["out"]:
            np.testing.assert_array_equal(got["out"][k], want["out"][k])
        for a, b in zip(got["state"], want["state"], strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("failures,match", [
    ({0: [1]}, "round 0"), ({8: [1]}, "1..7"), ({2: [99]}, "unknown node 99"),
    ({2.0: [1]}, "outside the valid boundary")])
def test_run_elastic_rejects_malformed_failures(failures, match):
    """The reference's plan validation (tests/test_churn.py:299)."""
    stream = obs_from_numpy({
        "z": np.full((8, 4), 0.5, np.float32),
        "aq": np.full((8, 4), 0.6, np.float32),
        "bw_mult": np.ones((8, 2), np.float32),
        "u": np.zeros((8, 5), np.float32)})
    with single_rank_group("gloo"):
        sess = ServeSession(policy("r2evid"), 4, device="cpu")
        with pytest.raises(ValueError, match=match):
            sess.run_elastic(stream, failures, n_nodes=4)
        assert not hasattr(sess, "mesh_history")


def test_run_elastic_with_all_nodes_dead_raises():
    stream = obs_from_numpy({
        "z": np.full((4, 4), 0.5, np.float32),
        "aq": np.full((4, 4), 0.6, np.float32),
        "bw_mult": np.ones((4, 2), np.float32),
        "u": np.zeros((4, 5), np.float32)})
    with single_rank_group("gloo"):
        sess = ServeSession(policy("rdap"), 4, device="cpu")
        with pytest.raises(RuntimeError, match="all 1 nodes dead"):
            sess.run_elastic(stream, {2: [0]})
        assert torch.is_tensor(sess.state.z_ema)
