"""Port parity: the unrolled CCG solver ``solve_ccg`` (repro_torch plain
versions, on the CPU) against a live JAX ``solve_ccg``, against the port's
own fused solve, and ``exact_oracle`` against the reference's.

Decisions and iteration counts must match exactly and bounds to 1e-6
relative, except on lanes whose smallest feasibility margin
min |f − (A^q + margin)| over the (F, K) options is below 1e-6 by the
reference's formula (torch's and XLA's float32 ``exp`` differ by an ulp on
some inputs); the test reports how many such lanes it saw.  The port's two
master forms — the running (M, F) η max and the slab master — must agree
with each other bit for bit on every lane.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core.lattice import DecisionLattice as JLat
from repro.core.robust import RobustProblem as JProb
from repro.core.robust import exact_oracle as j_exact_oracle
from repro.core.robust import solve_ccg as j_solve_ccg
from repro.core.robust import total_cost as j_total_cost
from repro_torch.core import cost_model as tcm
from repro_torch.core.robust import (
    RobustProblem,
    exact_oracle,
    solve_ccg,
    solve_ccg_fused,
    total_cost,
)

MARGIN_EXEMPT = 1e-6
DEC = ("route", "r", "p", "v", "iters", "infeasible")
BOUNDS = ("o_up", "o_down")


def feasibility_margin(jsys, z, aq):
    f = np.asarray(JLat.build(jsys).accuracy_flat(jnp.asarray(z)))
    thr = np.asarray(jnp.asarray(aq) + jsys.acc_margin_robust)
    return np.abs(f - thr[:, None, None]).min(axis=(1, 2))


def _inputs(m, seed):
    rng = np.random.default_rng(seed)
    z = rng.uniform(0, 1, m).astype(np.float32)
    aq = rng.uniform(0.5, 0.8, m).astype(np.float32)
    aq[:3] = [0.99, 0.97, 1.2]            # nothing feasible: fallback path
    z[3] = 0.0                            # fps-independent accuracy: ties
    wy = rng.integers(-1, 50, m).astype(np.int32)
    wy[4:8] = -1                          # cold lanes
    wy[8:12] = 0                          # warm on the cheapest option
    return z, aq, wy


def _tier(dead):
    if dead is None:
        return None
    t = np.ones(2, np.float32)
    t[dead] = 0.0
    return t


def _solve_both(m, seed, warm, dead, gamma=2):
    jsys = jcm.SystemConfig(gamma=gamma)
    jprob = JProb.build(jsys)
    tprob = RobustProblem.build(tcm.SystemConfig(gamma=gamma), "cpu")
    z, aq, wy = _inputs(m, seed)
    tier_ok = _tier(dead)
    want = j_solve_ccg(jprob, jnp.asarray(z), jnp.asarray(aq),
                       warm_y=jnp.asarray(wy) if warm else None,
                       tier_ok=None if tier_ok is None
                       else jnp.asarray(tier_ok))
    kw = dict(warm_y=torch.from_numpy(wy) if warm else None,
              tier_ok=None if tier_ok is None else torch.from_numpy(tier_ok))
    args = (tprob, torch.from_numpy(z), torch.from_numpy(aq))
    running = solve_ccg(*args, **kw)
    slab = solve_ccg(*args, force="ref", **kw)
    return jsys, z, aq, wy, want, running, slab, tprob


def _assert_matches(got, want, margin, what):
    exempt = margin < MARGIN_EXEMPT
    bad = np.zeros(len(margin), bool)
    for k in DEC:
        bad |= got[k].numpy() != np.asarray(want[k])
    for k in BOUNDS:
        bad |= ~np.isclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                           atol=0)
    print(f"{what}: {int(exempt.sum())} lanes with margin < {MARGIN_EXEMPT}, "
          f"{int((bad & exempt).sum())} of them differ")
    assert not (bad & ~exempt).any(), (what, np.nonzero(bad & ~exempt)[0])


@pytest.mark.parametrize("dead", [None, 0, 1],
                         ids=["all_up", "edge_down", "cloud_down"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("m", [37, 130])
def test_solve_ccg_matches_reference(m, warm, dead):
    jsys, z, aq, _, want, running, slab, _ = _solve_both(
        m, seed=m + 7 * warm + (dead or 0), warm=warm, dead=dead)
    for k in DEC + BOUNDS:
        assert torch.equal(running[k], slab[k]), k   # running η == slab
    _assert_matches(running, want, feasibility_margin(jsys, z, aq),
                    f"solve_ccg M={m} warm={warm} dead={dead}")
    assert running["infeasible"][:3].all()
    if dead is not None:
        assert (running["route"] != dead).all()
    if warm:
        cold = solve_ccg(RobustProblem.build(tcm.SystemConfig(), "cpu"),
                         torch.from_numpy(z), torch.from_numpy(aq),
                         tier_ok=None if dead is None
                         else torch.from_numpy(_tier(dead)))
        assert int(running["iters"].sum()) <= int(cold["iters"].sum())


@pytest.mark.parametrize("slab_master", [True, False])
def test_solve_ccg_gamma0_single_pole(slab_master):
    """Γ = 0 leaves one pole (P = 1): at most two master steps."""
    jsys, z, aq, wy, want, _, _, tprob = _solve_both(40, 3, True, None,
                                                     gamma=0)
    got = solve_ccg(tprob, torch.from_numpy(z), torch.from_numpy(aq),
                    warm_y=torch.from_numpy(wy), slab_master=slab_master)
    _assert_matches(got, want, feasibility_margin(jsys, z, aq),
                    f"solve_ccg gamma=0 slab={slab_master}")
    assert int(got["iters"].max()) <= 2


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_solve_ccg_equals_fused_solve(warm):
    """The unrolled solver and the fused ``ccg_solve`` give the same
    decisions, bounds and iteration counts bit for bit."""
    tprob = RobustProblem.build(tcm.SystemConfig(), "cpu")
    z, aq, wy = _inputs(257, seed=21 + warm)
    args = (tprob, torch.from_numpy(z), torch.from_numpy(aq))
    kw = dict(warm_y=torch.from_numpy(wy) if warm else None)
    fused = solve_ccg_fused(*args, **kw)
    for force in ("auto", "ref"):
        got = solve_ccg(*args, force=force, **kw)
        for k in DEC + BOUNDS:
            assert torch.equal(got[k], fused[k].to(got[k].dtype)), (force, k)


@pytest.mark.parametrize("dead", [None, 0], ids=["all_up", "edge_down"])
def test_exact_oracle_matches_reference(dead):
    jsys = jcm.SystemConfig()
    jprob = JProb.build(jsys)
    tprob = RobustProblem.build(tcm.SystemConfig(), "cpu")
    z, aq, _ = _inputs(90, seed=31)
    tier_ok = _tier(dead)
    y_w, obj_w = j_exact_oracle(jprob, jnp.asarray(z), jnp.asarray(aq),
                                tier_ok=None if tier_ok is None
                                else jnp.asarray(tier_ok))
    y, obj = exact_oracle(tprob, torch.from_numpy(z), torch.from_numpy(aq),
                          tier_ok=None if tier_ok is None
                          else torch.from_numpy(tier_ok))
    keep = feasibility_margin(jsys, z, aq) >= MARGIN_EXEMPT
    np.testing.assert_array_equal(y.numpy()[keep], np.asarray(y_w)[keep])
    np.testing.assert_array_equal(obj.numpy()[keep],
                                  np.asarray(obj_w)[keep])
    # the CCG solve reaches the oracle's robust objective on feasible lanes
    sol = solve_ccg(tprob, torch.from_numpy(z), torch.from_numpy(aq),
                    tier_ok=None if tier_ok is None
                    else torch.from_numpy(tier_ok))
    feas = ~sol["infeasible"].numpy()
    np.testing.assert_allclose(sol["o_up"].numpy()[feas],
                               obj.numpy()[feas], rtol=1e-4)


def test_total_cost_matches_reference():
    jprob = JProb.build(jcm.SystemConfig())
    tprob = RobustProblem.build(tcm.SystemConfig(), "cpu")
    rng = np.random.default_rng(4)
    sol = {k: rng.integers(0, n, 33) for k, n in
           (("route", 2), ("r", 5), ("p", 5), ("v", 5))}
    u = rng.uniform(0, 0.35, 5).astype(np.float32)
    z = np.zeros(33, np.float32)
    for uu in (None, u):
        want = j_total_cost(jprob, {k: jnp.asarray(v) for k, v in sol.items()},
                            z, z, u=None if uu is None else jnp.asarray(uu))
        got = total_cost(tprob, {k: torch.from_numpy(v)
                                 for k, v in sol.items()}, z, z,
                         u=None if uu is None else torch.from_numpy(uu))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
