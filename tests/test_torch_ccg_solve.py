"""Port parity: the fused CCG solve (repro_torch plain version vs the JAX
``ccg_solve`` ref and Pallas interpret kernel, on the CPU).

Decisions and iteration counts must match exactly and bounds to 1e-6
relative — except on lanes whose smallest feasibility margin
min |f − (A^q + margin)| over the (F, K) options is below 1e-6, measured
with the reference's own formula.  torch's and XLA's float32 ``exp`` differ
by an ulp on some inputs, which moves the accuracy surface by up to 1.2e-7
and can flip a feasibility bit that close to its threshold.  The test
reports how many such lanes it saw and fails on any mismatch outside them.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core.robust import RobustProblem as JProb
from repro.core.robust import solve_ccg_fused as j_solve_fused
from repro.kernels.ccg_solve.ops import ccg_solve as j_ccg_solve
from repro_torch.core import cost_model as tcm
from repro_torch.core.robust import RobustProblem, solve_ccg_fused
from repro_torch.kernels.ccg_solve.ops import ccg_solve
from repro_torch.kernels.ccg_solve.ref import ccg_solve_ref

MARGIN_EXEMPT = 1e-6
KEYS = ("y_f", "v_star", "o_up", "o_down", "iters", "infeasible")


def feasibility_margin(jsys, z, aq):
    """Per lane: min over (F, K) of |f − (A^q + robust margin)| (JAX side)."""
    from repro.core.lattice import DecisionLattice
    f = np.asarray(DecisionLattice.build(jsys).accuracy_flat(jnp.asarray(z)))
    thr = np.asarray(jnp.asarray(aq) + jsys.acc_margin_robust)
    return np.abs(f - thr[:, None, None]).min(axis=(1, 2))


def _inputs(m, seed, n_flat=50):
    rng = np.random.default_rng(seed)
    z = rng.uniform(0, 1, m).astype(np.float32)
    aq = rng.uniform(0.5, 0.8, m).astype(np.float32)
    aq[:3] = [0.99, 0.97, 1.2]            # nothing feasible: fallback path
    z[3] = 0.0                            # fps-independent accuracy: ties
    wy = rng.integers(-1, n_flat, m).astype(np.int32)
    wy[4:8] = -1                          # cold lanes
    wy[8:12] = 0                          # warm on the cheapest (often infeasible) option
    return z, aq, wy


def _compare(got, want, margin, what):
    exempt = margin < MARGIN_EXEMPT
    bad = np.zeros(len(margin), bool)
    for k in KEYS:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k in ("o_up", "o_down"):
            bad |= ~np.isclose(g, w, rtol=1e-6, atol=0)
        else:
            bad |= g != w
    print(f"{what}: {int(exempt.sum())} lanes with margin < {MARGIN_EXEMPT}, "
          f"{int((bad & exempt).sum())} of them differ")
    assert not (bad & ~exempt).any(), (
        what, np.nonzero(bad & ~exempt)[0],
        {k: (np.asarray(got[k])[bad & ~exempt],
             np.asarray(want[k])[bad & ~exempt]) for k in KEYS})


@pytest.mark.parametrize("jforce", ["ref", "pallas"])
@pytest.mark.parametrize("m,gamma", [(37, 2), (130, 2), (37, 0)])
def test_ccg_solve_matches_reference(m, gamma, jforce):
    jsys = jcm.SystemConfig(gamma=gamma)
    jprob = JProb.build(jsys)
    tprob = RobustProblem.build(tcm.SystemConfig(gamma=gamma), "cpu")
    jl, tl = jprob.lat, tprob.lat
    z, aq, wy = _inputs(m, seed=m + gamma)
    want = j_ccg_solve(jnp.asarray(z), jnp.asarray(aq), jl.rn_flat,
                       jl.pn_flat, jl.tier_flat, jl.b2_flat,
                       jprob.poles * jl.u_dev, jl.c1_flat, jnp.asarray(wy),
                       margin=jsys.acc_margin_robust, num_versions=5,
                       block_m=32, force=jforce)
    got = ccg_solve(torch.from_numpy(z), torch.from_numpy(aq), tl.rn_flat,
                    tl.pn_flat, tl.tier_flat, tl.b2_flat, tprob.u_all,
                    tl.c1_flat, torch.from_numpy(wy),
                    margin=jsys.acc_margin_robust, num_versions=5)
    assert got[0].dtype == torch.int32 and got[5].dtype == torch.bool
    _compare(dict(zip(KEYS, (t.numpy() for t in got))),
             dict(zip(KEYS, want)), feasibility_margin(jsys, z, aq),
             f"ccg_solve M={m} gamma={gamma} vs {jforce}")
    # the fallback lanes really are infeasible, the rest mostly are not
    assert got[5][:3].all() and not got[5][12:].all()


@pytest.mark.parametrize("dead_tier", [0, 1])
def test_ccg_solve_availability_mask_matches_reference(dead_tier):
    """``y_ok`` masks a dead tier's options out of feasibility and out of
    the all-infeasible fallback, as in the reference (the kernel's masks
    are held to this plain version in ``test_torch_kernels_cuda.py``)."""
    jsys = jcm.SystemConfig()
    jprob = JProb.build(jsys)
    tprob = RobustProblem.build(tcm.SystemConfig(), "cpu")
    jl, tl = jprob.lat, tprob.lat
    z, aq, wy = _inputs(40, seed=dead_tier)
    tier_ok = np.ones(2, np.float32)
    tier_ok[dead_tier] = 0.0
    y_ok = np.array(jl.tier_y_ok(jnp.asarray(tier_ok)))
    want = j_ccg_solve(jnp.asarray(z), jnp.asarray(aq), jl.rn_flat,
                       jl.pn_flat, jl.tier_flat, jl.b2_flat,
                       jprob.poles * jl.u_dev, jl.c1_flat, jnp.asarray(wy),
                       margin=jsys.acc_margin_robust, num_versions=5,
                       force="ref", y_ok=jnp.asarray(y_ok))
    got = ccg_solve_ref(torch.from_numpy(z), torch.from_numpy(aq),
                        tl.rn_flat, tl.pn_flat, tl.tier_flat, tl.b2_flat,
                        tprob.u_all, tl.c1_flat, torch.from_numpy(wy),
                        jsys.acc_margin_robust, 5, 8, 1e-4,
                        y_ok=torch.from_numpy(y_ok))
    _compare(dict(zip(KEYS, (t.numpy() for t in got))),
             dict(zip(KEYS, want)), feasibility_margin(jsys, z, aq),
             f"ccg_solve y_ok dead tier {dead_tier}")
    route = got[0].numpy() // 25
    assert (route != dead_tier).all()


def test_solve_ccg_fused_matches_reference():
    """The robust layer: unflattened (route, r, p, v), bounds, iters."""
    jsys = jcm.SystemConfig()
    jprob = JProb.build(jsys)
    tprob = RobustProblem.build(tcm.SystemConfig(), "cpu")
    z, aq, wy = _inputs(64, seed=5)
    want = j_solve_fused(jprob, jnp.asarray(z), jnp.asarray(aq),
                         warm_y=jnp.asarray(wy), force="ref")
    got = solve_ccg_fused(tprob, torch.from_numpy(z), torch.from_numpy(aq),
                          warm_y=torch.from_numpy(wy))
    margin = feasibility_margin(jsys, z, aq)
    exempt = margin < MARGIN_EXEMPT
    for k in ("route", "r", "p", "v", "iters", "infeasible"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert not ((g != w) & ~exempt).any(), k
    for k in ("o_up", "o_down"):
        np.testing.assert_allclose(got[k].numpy()[~exempt],
                                   np.asarray(want[k])[~exempt], rtol=1e-6)


def test_ccg_solve_cold_default_warm_start():
    """warm_y=None is the all-cold solve."""
    tprob = RobustProblem.build(tcm.SystemConfig(), "cpu")
    z, aq, _ = _inputs(16, seed=9)
    cold = solve_ccg_fused(tprob, torch.from_numpy(z), torch.from_numpy(aq))
    explicit = solve_ccg_fused(tprob, torch.from_numpy(z),
                               torch.from_numpy(aq),
                               warm_y=torch.full((16,), -1, dtype=torch.int32))
    for k in cold:
        torch.testing.assert_close(cold[k], explicit[k], rtol=0, atol=0)
