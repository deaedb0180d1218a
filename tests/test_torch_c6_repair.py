"""The whole C6 repair (``c6_repair``) on the CPU: its plain version, through
``enforce_bandwidth``, against the live JAX ``enforce_bandwidth`` (also
above the one-block kernel's 16,384 tasks), the orders of work of the
one-block and the cluster CUDA kernels (``torch_kernel_orders``) against
the plain version, and the wrapper's choice of kernel by M.

Decisions are compared exactly, with two exemptions.  (1) Lanes whose
feasibility margin is under 1e-6 (torch's and XLA's float32 ``exp`` differ
by an ulp on some inputs), as in ``test_torch_c6_tail.py``.  (2) A task on
the boundary of a round's demotion: the kernel, torch and XLA sum the draw
and the prefix gains in different orders, so a task whose exclusive prefix
lies within the sums' rounding bound of the excess may be demoted on one
side only.  The bound, for a round with M draws and n positive gains
g_1..g_n: 2·M·ε·Σ bw + 2·n·ε·Σ g (ε = 2⁻²⁴; twice the first-order bound of
a float32 sum in any order, once for each of the two orders compared).
Runs are compared whole; where they differ, the first round that differs
must differ only on exempt tasks of that round, and the rounds after it are
not compared (they start from different states).  The draw history agrees
within 1e-6 relative up to that round.  Ties are the common case (gains
are differences of one 50-entry table): the order of the tasks demoted,
compared exactly, is the stable descending order.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_kernel_orders import (
    block_sum,
    c6_repair_cluster_emulated,
    c6_repair_emulated,
    cluster_shape,
    compare_runs,
    exclusive_prefix,
)

from repro.core import cost_model as jcm
from repro.core.lattice import DecisionLattice as JLat
from repro.core.router import enforce_bandwidth as j_enforce
from repro_torch.core import cost_model as tcm
from repro_torch.core.lattice import DecisionLattice as TLat
from repro_torch.core.router import enforce_bandwidth
from repro_torch.kernels.c6_tail.ops import (
    CLUSTER_BLOCKS,
    CLUSTER_CAP,
    REPAIR_CAP,
    c6_repair,
    repair_path,
)
from repro_torch.kernels.c6_tail.ref import EPS, c6_repair_ref, c6_tail_ref

JSYS, TSYS = jcm.SystemConfig(), tcm.SystemConfig()
JL, TL = JLat.build(JSYS), TLat.build(TSYS, "cpu")
MARGIN_EXEMPT = 1e-6


def feasibility_margin(z, aq):
    """Per lane: min over (F, K) of |f − (A^q + robust margin)| (JAX side)."""
    f = np.asarray(JL.accuracy_flat(jnp.asarray(z)))
    thr = np.asarray(jnp.asarray(aq) + JSYS.acc_margin_robust)
    return np.abs(f - thr[:, None, None]).min(axis=(1, 2))


def _decisions(m, seed, lo=2):
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.05, 0.7, m).astype(np.float32)
    aq = rng.uniform(0.5, 0.75, m).astype(np.float32)
    d = {"route": rng.integers(0, 2, m),
         "r": rng.integers(lo, TSYS.n_res, m),
         "p": rng.integers(lo, TSYS.n_fps, m),
         "v": rng.integers(lo, TSYS.num_versions, m)}
    return z, aq, d


def _inputs(z, aq, d):
    """c6_repair's operands on the CPU from numpy decisions."""
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    panel = torch.movedim(TL.bw, -1, 0)[t["route"]].reshape(len(z), -1)
    return (panel, t["r"], t["p"], t["v"], t["route"], torch.from_numpy(z),
            torch.from_numpy(aq) + TSYS.acc_margin_robust,
            tcm.res_norm(TSYS, "cpu"), tcm.fps_norm(TSYS, "cpu"))


def _draw(d):
    return float(np.asarray(JL.solution_bandwidth(
        {k: jnp.asarray(v, jnp.int32) for k, v in d.items()})).sum())


# M, budget as a fraction of the draw, rounds: each demotes in >= 2 rounds
CASES = [(40, 0.5, 8), (96, 0.3, 3), (4096, 0.8, 3), (4096, 0.4, 8)]


@pytest.mark.parametrize("budget_kind", ["float", "tensor"])
@pytest.mark.parametrize("jforce", ["ref", "pallas"])
@pytest.mark.parametrize("m,frac,rounds", CASES)
def test_c6_repair_plain_matches_reference(m, frac, rounds, jforce,
                                           budget_kind):
    """``enforce_bandwidth`` (c6_repair's plain version on the CPU) against
    the live JAX repair, with its ``c6_tail`` on the jnp ref or the Pallas
    kernel in interpret mode; the budget as a float or a 0-d tensor."""
    z, aq, d = _decisions(m, seed=m + rounds)
    budget = float(np.float32(frac * _draw(d)))
    jsol = {k: jnp.asarray(v, jnp.int32) for k, v in d.items()}
    tsol = {k: torch.from_numpy(v) for k, v in d.items()}
    tbudget = budget if budget_kind == "float" else torch.tensor(budget)

    def run_j(k):
        fix, hist = j_enforce(JSYS, jsol, jnp.asarray(z), jnp.asarray(aq),
                              total_budget=budget, rounds=k, force=jforce)
        return (torch.from_numpy(np.asarray(fix["r"]).astype(np.int64)),
                torch.from_numpy(np.asarray(fix["p"]).astype(np.int64)),
                torch.from_numpy(np.array(hist)))

    def run_t(k):
        fix, hist = enforce_bandwidth(TL, tsol, torch.from_numpy(z),
                                      torch.from_numpy(aq),
                                      total_budget=tbudget, rounds=k)
        for key in ("route", "v"):
            assert torch.equal(fix[key], tsol[key])
        return fix["r"], fix["p"], hist

    exempt = np.nonzero(feasibility_margin(z, aq) < MARGIN_EXEMPT)[0]
    demoting = compare_runs(run_t, run_j, rounds, _inputs(z, aq, d), budget,
                            exempt.tolist())
    assert demoting >= 2


@pytest.mark.parametrize("budget_kind", ["float", "tensor"])
def test_c6_repair_no_positive_gain(budget_kind):
    """Every task at r = p = 0 (nothing to demote) over a budget it cannot
    meet: nothing changes, every round records the same draw; a budget
    that holds changes nothing either."""
    m = 96
    z, aq, d = _decisions(m, seed=5, lo=0)
    d["r"][:] = 0
    d["p"][:] = 0
    args = _inputs(z, aq, d)
    draw = _draw(d)
    for frac in (0.5, 2.0):
        budget = float(np.float32(frac * draw))
        b = budget if budget_kind == "float" else torch.tensor(budget)
        r, p, hist = c6_repair_ref(*args, b, n_fps=5, rounds=4)
        assert torch.equal(r, args[1]) and torch.equal(p, args[2])
        assert len(set(hist.tolist())) == 1
        np.testing.assert_allclose(float(hist[0]), draw, rtol=1e-6)
        er, ep, eh = c6_repair_emulated(*args, b, n_fps=5, rounds=4)
        assert torch.equal(er, r) and torch.equal(ep, p)
        np.testing.assert_allclose(eh.numpy(), hist.numpy(), rtol=1e-6)


@pytest.mark.parametrize("m,frac,rounds", CASES + [(1500, 0.6, 8)])
def test_kernel_order_matches_plain(m, frac, rounds):
    """The one-block kernel's order of work (the draw's block sum, the
    compaction into keys, the key order, the chunked Kogge–Stone scan, the
    early stop) equals ``c6_repair_ref`` outside the boundary exemption;
    the tasks it demotes come in the stable descending order exactly."""
    z, aq, d = _decisions(m, seed=m + 7 * rounds)
    args = _inputs(z, aq, d)
    budget = float(np.float32(frac * _draw(d)))
    assert m <= REPAIR_CAP
    run_e = lambda k: c6_repair_emulated(*args, budget, n_fps=5, rounds=k)
    run_r = lambda k: c6_repair_ref(*args, budget, n_fps=5, rounds=k)
    assert compare_runs(run_e, run_r, rounds, args, budget) >= 2
    # the key order is the stable descending order, ties by index
    trace = []
    c6_repair_emulated(*args, budget, n_fps=5, rounds=rounds, trace=trace)
    assert len(trace) >= 2
    r, p = args[1], args[2]
    n_ties = 0
    for excess, g, order, cum in trace:
        _, gain, can_p = c6_tail_ref(*args[:1], r, p, *args[3:], 5)
        ref_order = torch.argsort(-gain, stable=True)[:len(order)].numpy()
        np.testing.assert_array_equal(order, ref_order)
        n_ties += len(order) - len(np.unique(g.numpy()))
        demote = (cum < excess).numpy()
        i = torch.from_numpy(order[demote])
        cp = can_p[i]
        p = p.clone()
        r = r.clone()
        p[i[cp]] -= 1
        r[i[~cp]] -= 1
    assert n_ties > 0


@pytest.mark.parametrize("n", [1, 31, 1024, 1025, 5000])
def test_kernel_sums_within_their_bound(n):
    """The block sum and the exclusive prefix sums, in the kernel's order,
    within the stated bound n·ε·Σ|x| of the float64 sums."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.uniform(0.1, 40.0, n).astype(np.float32))
    exact = np.cumsum(x.double().numpy())
    bound = n * EPS * float(x.double().sum())
    assert abs(float(block_sum(x)) - exact[-1]) <= bound
    excl = exclusive_prefix(x).double().numpy()
    assert excl[0] == 0.0
    assert np.all(np.abs(excl[1:] - exact[:-1]) <= bound)


def test_c6_repair_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors ``c6_repair`` runs its plain version for "auto" and
    "ref" and keeps the dtypes of r and p."""
    z, aq, d = _decisions(40, seed=3)
    args = list(_inputs(z, aq, d))
    args[1], args[2] = args[1].int(), args[2].int()
    budget = 0.5 * _draw(d)
    want = c6_repair_ref(*args, budget, n_fps=5, rounds=3)
    for force in ("auto", "ref"):
        got = c6_repair(*args, budget, n_fps=5, rounds=3, force=force)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("m,frac,rounds", [(16385, 0.5, 4), (40000, 0.7, 4)])
def test_c6_repair_plain_matches_reference_above_cap(m, frac, rounds):
    """Above the one-block kernel's cap (where the card runs the cluster
    kernel): ``enforce_bandwidth`` against the live JAX repair on the same
    numpy inputs, decisions exact outside the exemptions, the draw within
    1e-6 relative."""
    z, aq, d = _decisions(m, seed=m + rounds)
    budget = float(np.float32(frac * _draw(d)))
    jsol = {k: jnp.asarray(v, jnp.int32) for k, v in d.items()}
    tsol = {k: torch.from_numpy(v) for k, v in d.items()}

    def run_j(k):
        fix, hist = j_enforce(JSYS, jsol, jnp.asarray(z), jnp.asarray(aq),
                              total_budget=budget, rounds=k, force="ref")
        return (torch.from_numpy(np.asarray(fix["r"]).astype(np.int64)),
                torch.from_numpy(np.asarray(fix["p"]).astype(np.int64)),
                torch.from_numpy(np.array(hist)))

    def run_t(k):
        fix, hist = enforce_bandwidth(TL, tsol, torch.from_numpy(z),
                                      torch.from_numpy(aq),
                                      total_budget=budget, rounds=k)
        return fix["r"], fix["p"], hist

    exempt = np.nonzero(feasibility_margin(z, aq) < MARGIN_EXEMPT)[0]
    demoting = compare_runs(run_t, run_j, rounds, _inputs(z, aq, d), budget,
                            exempt.tolist())
    assert demoting >= 1


# M, budget as a fraction of the alive draw, rounds, blocks, threads a block:
# several small blocks at a few thousand tasks, then the kernel's own shape
# (16 blocks of 1024 threads) just above the one-block cap and at 40,000
CLUSTER_CASES = [(3000, 0.6, 8, 4, 64), (2500, 0.4, 8, 3, 128),
                 (4096, 0.8, 4, 8, 32), (16385, 0.5, 8, None, 1024),
                 (40000, 0.6, 8, None, 1024)]


@pytest.mark.parametrize("budget_kind", ["float", "tensor"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m,frac,rounds,blocks,threads", CLUSTER_CASES)
def test_cluster_order_matches_plain(m, frac, rounds, blocks, threads,
                                     masked, budget_kind):
    """The cluster kernel's order of work (per-block passes and sorts, the
    blocks' sums in block order, each key's gain before it from every
    block's prefix at its rank, the early stop) equals ``c6_repair_ref``
    outside the boundary exemption, the history within 1e-6; the tasks it
    demotes come in the stable descending order, ties by index, and a dead
    lane never moves."""
    z, aq, d = _decisions(m, seed=m + 11 * rounds)
    args = _inputs(z, aq, d)
    mask = None
    bw = c6_tail_ref(*args, 5)[0]
    if masked:
        mask = torch.from_numpy(np.random.default_rng(m).random(m) < 0.7)
        bw = torch.where(mask, bw, 0.0)
    budget = float(np.float32(frac * float(bw.double().sum())))
    b = budget if budget_kind == "float" else torch.tensor(budget)
    n_blocks, tasks = cluster_shape(m, blocks)
    assert n_blocks >= 2 and (n_blocks - 1) * tasks < m <= n_blocks * tasks

    def run_e(k, trace=None):
        return c6_repair_cluster_emulated(*args, b, n_fps=5, rounds=k,
                                          blocks=blocks, threads=threads,
                                          trace=trace, task_mask=mask)

    run_r = lambda k: c6_repair_ref(*args, b, n_fps=5, rounds=k,
                                    task_mask=mask)
    assert compare_runs(run_e, run_r, rounds, args, budget, (), mask) >= 1
    trace = []
    got = run_e(rounds, trace)
    if mask is not None:
        assert torch.equal(got[0][~mask], args[1][~mask])
        assert torch.equal(got[1][~mask], args[2][~mask])
    assert len(trace) >= 1
    r, p = args[1], args[2]
    for excess, g, order, before in trace:
        _, gain, can_p = c6_tail_ref(*args[:1], r, p, *args[3:], 5)
        if mask is not None:
            gain = torch.where(mask, gain, 0.0)
        ref_order = torch.argsort(-gain, stable=True)[:len(order)].numpy()
        np.testing.assert_array_equal(order, ref_order)
        i = torch.from_numpy(order[(before < excess).numpy()])
        cp = can_p[i]
        p, r = p.clone(), r.clone()
        p[i[cp]] -= 1
        r[i[~cp]] -= 1


@pytest.mark.parametrize("m,path,blocks,tasks", [
    (1, "block", None, None), (REPAIR_CAP, "block", None, None),
    (REPAIR_CAP + 1, "cluster", 16, 1056), (40000, "cluster", 16, 2528),
    (53248, "cluster", 16, 3328), (131072, "cluster", 16, 8192),
    (CLUSTER_CAP, "cluster", CLUSTER_BLOCKS, REPAIR_CAP),
    (CLUSTER_CAP + 1, "per_round", None, None)])
def test_c6_repair_path_by_task_count(m, path, blocks, tasks):
    """The wrapper's launch by M alone, and the cluster kernel's shape
    (blocks, tasks a block) where it launches: every block holds tasks and
    none more than the one-block kernel."""
    assert repair_path(m) == path
    if path == "cluster":
        assert cluster_shape(m) == (blocks, tasks)
        assert (blocks - 1) * tasks < m <= blocks * tasks
