"""The sharding pieces of the port against the JAX package: ``pad_leading``,
the C6 sub-budget algebra (``subbudget_from_stats`` against the live JAX
function and its four properties), and over gloo ranks
``shard_bandwidth_target``, ``solve_ccg_sharded`` and R2E-VID's
``repair_local``.

``solve_ccg_sharded`` at M = 64 on 4 ranks is held to the live JAX
``solve_ccg_sharded`` on 4 host devices (a subprocess: the device count is
fixed when JAX starts), exactly; at M = 13, where JAX's own sharded solve
fails to slice its padded result back, to JAX's ``solve_ccg``.
``repair_local`` of max-fidelity solutions (the reference's ``_inflated``)
at D = 2, 4 and 8 is held to the reference's host-loop oracle (live JAX
``subbudget_from_stats`` and ``enforce_bandwidth`` per shard): r and p
exact, and the oracle's invariants.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_kernel_orders import compare_runs
from torch_sharded_ranks import sharding_ranks

from repro.core import cost_model as jcm
from repro.core.robust import RobustProblem as JProblem
from repro.core.robust import solve_ccg as j_solve_ccg
from repro.core.router import enforce_bandwidth as j_enforce
from repro.core.router import subbudget_from_stats as j_subbudget
from repro.sharding.compat import pad_leading as j_pad_leading
from repro_torch.core import cost_model as tcm
from repro_torch.core.lattice import DecisionLattice as TLat
from repro_torch.core.router import enforce_bandwidth, subbudget_from_stats
from repro_torch.launch.mesh import host_mesh, run_ranks, single_rank_group
from repro_torch.sharding.audit import (
    collective_footprint,
    round_footprint,
    round_records,
)
from repro_torch.sharding.collectives import all_gather, in_round, psum
from repro_torch.sharding.compat import pad_leading

JSYS = jcm.SystemConfig()
JLAT = JProblem.build(JSYS).lat
TSYS = tcm.SystemConfig()
TLAT = TLat.build(TSYS, "cpu")
DEC_KEYS = ("route", "r", "p", "v")


# ---------------------------------------------------------------------------
# pad_leading
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,pad,value,axis", [
    ((5,), 3, 0, 0), ((5,), 0, 0, 0), ((4, 3), 2, -1, 0), ((2, 5, 3), 3, 7, 1),
    ((3, 2), 1, 1.5, 1)])
def test_pad_leading_matches_reference(shape, pad, value, axis):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = pad_leading(torch.from_numpy(x), pad, value=value, axis=axis)
    want = np.asarray(j_pad_leading(jnp.asarray(x), pad, value=value,
                                    axis=axis))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_leading_keeps_dtype_and_returns_input_unpadded():
    x = torch.tensor([1, 2], dtype=torch.int64)
    assert pad_leading(x, 0) is x
    y = pad_leading(x, 2, value=-1)
    assert y.dtype == torch.int64 and y.tolist() == [1, 2, -1, -1]
    b = pad_leading(torch.ones(2, dtype=torch.bool), 1)
    assert b.tolist() == [True, True, False]


# ---------------------------------------------------------------------------
# the C6 sub-budget algebra
# ---------------------------------------------------------------------------
def _random_stats(n, rng):
    bw = rng.uniform(0.0, 100.0, n).astype(np.float32)
    w = rng.integers(1, 9, n).astype(np.float32)
    return bw, w, float(rng.uniform(10.0, 500.0))


SHARD_COUNTS = (1, 2, 3, 4, 8)


@pytest.mark.parametrize("n", SHARD_COUNTS)
def test_subbudget_matches_live_jax(n):
    """The reference's random cases (tests/test_hierarchical.py:39):
    every target within an ulp of the live JAX function's (the sums over
    D shards may take another order), and the targets conserve the
    budget: Σ target = min(Σ bw, B)."""
    rng = np.random.default_rng(0)
    for prev in SHARD_COUNTS[:SHARD_COUNTS.index(n)]:
        for _ in range(8):           # the reference's draws, in its order
            _random_stats(prev, rng)
    for _ in range(8):
        bw, w, budget = _random_stats(n, rng)
        got = subbudget_from_stats(torch.from_numpy(bw),
                                   torch.from_numpy(w), budget).numpy()
        want = np.asarray(j_subbudget(jnp.asarray(bw), jnp.asarray(w),
                                      budget))
        np.testing.assert_allclose(got, want, rtol=2 ** -22, atol=1e-5)
        np.testing.assert_allclose(got.astype(np.float64).sum(),
                                   min(bw.astype(np.float64).sum(), budget),
                                   rtol=1e-5)


def test_subbudget_noop_under_budget():
    bw = torch.tensor([10.0, 25.0, 5.0])
    t = subbudget_from_stats(bw, torch.tensor([4.0, 4.0, 2.0]), 100.0)
    assert torch.equal(t, bw)


def test_subbudget_only_excess_shards_demote():
    t = subbudget_from_stats(torch.tensor([10.0, 90.0]),
                             torch.tensor([1.0, 1.0]), 80.0)
    np.testing.assert_allclose(t.numpy(), [10.0, 70.0], rtol=1e-6)


def test_subbudget_single_shard_degenerates_to_dense():
    for bw, b in ((50.0, 80.0), (120.0, 80.0)):
        t = float(subbudget_from_stats(torch.tensor([bw]),
                                       torch.tensor([7.0]), b)[0])
        assert abs(t - min(bw, b)) < 1e-5


def test_subbudget_takes_a_device_scalar_budget():
    bw, w = torch.tensor([30.0, 90.0]), torch.tensor([2.0, 2.0])
    a = subbudget_from_stats(bw, w, 80.0)
    b = subbudget_from_stats(bw, w, torch.tensor(80.0))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------
def test_round_footprint_reads_the_in_round_records():
    records = [("all_gather", 2, True), ("psum", 2, True),
               ("all_gather", 64, False), ("all_gather", 2, True),
               ("psum", 2, True)]
    assert round_records(records) == [("all_gather", 2), ("psum", 2),
                                      ("all_gather", 2), ("psum", 2)]
    assert round_footprint(records, 2) == {
        "collectives_per_round": 2.0, "elements_per_round": 4.0,
        "max_elements": 2, "outside_rounds": 1,
        "elements_outside_rounds": 64}
    # the reference's max_loop_collective_elems is 0 with no in-round op
    assert round_footprint(records[2:3], 1)["max_elements"] == 0


def test_collective_footprint_records_what_a_call_exchanged():
    def call(mesh):
        all_gather(torch.ones(3, 2), mesh)
        with in_round():
            psum(torch.ones(2, dtype=torch.int32), mesh)

    with single_rank_group("gloo"):
        foot = collective_footprint(call, host_mesh())
    assert foot == [("all_gather", 6, False), ("psum", 2, True)]


# ---------------------------------------------------------------------------
# over gloo ranks
# ---------------------------------------------------------------------------
JAX_SOLVE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro.core.cost_model import SystemConfig
from repro.core.robust import RobustProblem, solve_ccg_sharded

z, aq = np.load(sys.argv[1] + ".in.npy")
sol = solve_ccg_sharded(RobustProblem.build(SystemConfig()), jnp.asarray(z),
                        jnp.asarray(aq), jax.make_mesh((4,), ("data",)))
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in sol.items()})
"""


def _tasks(m, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, m).astype(np.float32),
            rng.uniform(0.5, 0.75, m).astype(np.float32))


def _inflated(m=32, seed=5):
    """The reference's max-fidelity solutions with loose requirements
    (tests/test_hierarchical.py:86): real demotion slack."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.1, 0.6, m).astype(np.float32)
    aq = rng.uniform(0.5, 0.6, m).astype(np.float32)
    sol = {"route": np.zeros(m, np.int64),
           "r": np.full(m, JSYS.n_res - 1, np.int64),
           "p": np.full(m, JSYS.n_fps - 1, np.int64),
           "v": np.full(m, JSYS.num_versions - 1, np.int64)}
    return z, aq, sol


def _repair_case():
    """The inflated solutions and a binding budget (half the start draw),
    as the bandwidth scale the session hands ``repair_local`` and the
    float32 budget it makes of it."""
    z, aq, sol = _inflated()
    start = float(np.asarray(JLAT.solution_bandwidth(
        {k: jnp.asarray(v, jnp.int32) for k, v in sol.items()})).sum())
    scale = np.float32(0.5 * start / JSYS.total_bw_mbps)
    return z, aq, sol, scale, float(scale * np.float32(JSYS.total_bw_mbps))


def _target_cases(d):
    rng = np.random.default_rng(d)
    return [_random_stats(d, rng) for _ in range(3)] + [
        (np.full(d, 20.0, np.float32), np.ones(d, np.float32), 1000.0)]


@pytest.fixture(scope="module")
def jax_solve(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("jax_solve") / "sol")
    np.save(base + ".in.npy", np.stack(_tasks(64, 42)))
    done = subprocess.run(
        [sys.executable, "-c", torch_threads.child_script(JAX_SOLVE), base],
        capture_output=True, text=True, timeout=300,
        env=torch_threads.subprocess_env(JAX_PLATFORMS="cpu"))
    assert done.returncode == 0, done.stderr[-3000:]
    with np.load(base + ".npz") as f:
        return dict(f)


@pytest.fixture(scope="module")
def ranks():
    """One start of 2, 4 and 8 gloo ranks: {D: each rank's results}."""
    z, aq, sol, scale, _ = _repair_case()
    out = {}
    for d in (2, 4, 8):
        cases = {"targets": _target_cases(d),
                 "repair": (z, aq, sol, scale)}
        if d == 4:
            cases["solve"] = {64: _tasks(64, 42), 13: _tasks(13, 42)}
        out[d] = run_ranks(sharding_ranks, d, backend="gloo", args=(cases,),
                           timeout=120)
    return out


@pytest.mark.parametrize("d", [2, 4, 8])
def test_shard_bandwidth_target_is_this_ranks_subbudget(ranks, d):
    """One (2,)-gather a shard: rank i's target is entry i of the live JAX
    sub-budget of the gathered stats."""
    for c, (bw, w, budget) in enumerate(_target_cases(d)):
        want = np.asarray(j_subbudget(jnp.asarray(bw), jnp.asarray(w),
                                      budget))
        got = np.array([res["targets"][c] for res in ranks[d]])
        np.testing.assert_allclose(got, want, rtol=2 ** -22, atol=1e-5)
        if budget == 1000.0:              # slack: every shard keeps its draw
            np.testing.assert_array_equal(got, bw)


def test_solve_ccg_sharded_matches_live_jax_sharded(ranks, jax_solve):
    for res in ranks[4]:
        got = res["solve"][64]
        assert set(got) == set(jax_solve)
        for k in got:
            np.testing.assert_array_equal(got[k], jax_solve[k], err_msg=k)


def test_solve_ccg_sharded_uneven_m_matches_jax_solve(ranks):
    z, aq = _tasks(13, 42)
    want = j_solve_ccg(JProblem.build(JSYS), jnp.asarray(z), jnp.asarray(aq))
    for res in ranks[4]:
        got = res["solve"][13]
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)


def _demotion_depth(sol):
    return ((JSYS.n_res - 1 - np.asarray(sol["r"]))
            + (JSYS.n_fps - 1 - np.asarray(sol["p"]))
            + (JSYS.num_versions - 1 - np.asarray(sol["v"])))


@pytest.mark.parametrize("d", [2, 4, 8])
def test_repair_local_matches_the_host_loop_oracle(ranks, d):
    """The hierarchical C6 program spelled as the reference's host loop
    over shards: per-shard stats, the live JAX sub-budget split, then each
    shard repaired against its target (64 rounds).  ``repair_local`` on the
    ranks equals the port's plain repair of each shard bit for bit, and
    that equals the live JAX repair of the shard outside c6_repair's
    boundary exemption (a task whose demotion lies within the rounding of
    torch's and XLA's float32 sums of the draw; the case's budget is
    exactly half the max-fidelity draw, which the demotions reach).  Then
    the reference's contract: the global draw meets the budget, each
    shard meets its target, no task is more than one demotion level from
    the dense repair, every task stays feasible."""
    z, aq, sol, _, budget = _repair_case()
    m = z.shape[0]
    ml = m // d
    jsol = {k: jnp.asarray(v, jnp.int32) for k, v in sol.items()}
    bw = np.asarray(JLAT.solution_bandwidth(jsol))
    bwd = jnp.asarray([bw[i * ml:(i + 1) * ml].sum() for i in range(d)],
                      jnp.float32)
    targets = np.asarray(j_subbudget(bwd, jnp.full((d,), ml, jnp.float32),
                                     budget))
    got = {k: np.concatenate([res["repair"][k] for res in ranks[d]])
           for k in DEC_KEYS}
    np.testing.assert_allclose([res["repair_target"] for res in ranks[d]],
                               targets, rtol=2 ** -22)
    for i in range(d):
        sl = slice(i * ml, (i + 1) * ml)
        t = {k: torch.from_numpy(v[sl]) for k, v in sol.items()}
        zt, aqt = torch.from_numpy(z[sl]), torch.from_numpy(aq[sl])

        def run_t(k):
            fix, hist = enforce_bandwidth(TLAT, t, zt, aqt,
                                          total_budget=float(targets[i]),
                                          rounds=k)
            return fix["r"], fix["p"], hist

        def run_j(k):
            fix, hist = j_enforce(JSYS, {n: v[sl] for n, v in jsol.items()},
                                  jnp.asarray(z[sl]), jnp.asarray(aq[sl]),
                                  total_budget=float(targets[i]), rounds=k)
            return tuple(torch.from_numpy(np.array(x)) for x in
                         (np.asarray(fix["r"]).astype(np.int64),
                          np.asarray(fix["p"]).astype(np.int64), hist))

        r, p, _ = run_t(64)
        np.testing.assert_array_equal(got["r"][sl], r.numpy())
        np.testing.assert_array_equal(got["p"][sl], p.numpy())
        panel = torch.movedim(TLAT.bw, -1, 0)[t["route"]].reshape(ml, -1)
        args = (panel, t["r"], t["p"], t["v"], t["route"], zt,
                aqt + JSYS.acc_margin_robust, tcm.res_norm(TSYS, "cpu"),
                tcm.fps_norm(TSYS, "cpu"))
        compare_runs(run_t, run_j, 64, args, float(targets[i]))
        sbw = float(np.asarray(JLAT.solution_bandwidth(
            {k: jnp.asarray(got[k][sl], jnp.int32) for k in DEC_KEYS})).sum())
        assert sbw <= targets[i] + 1e-4, (i, sbw, targets[i])
    hier = {k: jnp.asarray(v, jnp.int32) for k, v in got.items()}
    assert float(np.asarray(JLAT.solution_bandwidth(hier)).sum()) \
        <= budget + 1e-4
    dense, _ = j_enforce(JSYS, jsol, jnp.asarray(z), jnp.asarray(aq),
                         total_budget=budget, rounds=64)
    assert _demotion_depth(dense).sum() > 0
    assert np.abs(_demotion_depth(dense) - _demotion_depth(got)).max() <= 1
    f = np.asarray(jcm.accuracy_table(JSYS, jnp.asarray(z)))
    acc = f[np.arange(m), got["r"], got["p"], got["v"], got["route"]]
    assert np.all(acc >= aq + JSYS.acc_margin_robust - 1e-6)
