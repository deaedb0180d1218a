"""Port parity: the fused CCG encoding (repro_torch plain version vs the JAX
``ccg_encode`` ref and Pallas interpret kernel, on the CPU).

``code``, ``best`` and ``rec_all`` must be exactly equal, except on lanes
whose smallest feasibility margin min |f − (A^q + margin)| over the (F, K)
options is below 1e-6 by the reference's own formula: torch's and XLA's
float32 ``exp`` differ by an ulp on some inputs, which moves the accuracy
surface by up to 1.2e-7 and can flip a feasibility bit that close to its
threshold (and, for the same reason, the accuracy argmax between two
options tied within an ulp).  The test reports how many such lanes it saw
and fails on any mismatch outside them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core.lattice import DecisionLattice as JLat
from repro.core.robust import RobustProblem as JProb
from repro.core.robust import _encode_tasks as j_encode_tasks
from repro.kernels.ccg_encode.ops import ccg_encode as j_ccg_encode
from repro_torch.core import cost_model as tcm
from repro_torch.core.robust import (
    RobustProblem,
    _encode_tasks,
    _encode_tasks_fused,
)
from repro_torch.kernels.ccg_encode.ops import ccg_encode

MARGIN_EXEMPT = 1e-6


def feasibility_margin(jsys, z, aq):
    f = np.asarray(JLat.build(jsys).accuracy_flat(jnp.asarray(z)))
    thr = np.asarray(jnp.asarray(aq) + jsys.acc_margin_robust)
    return np.abs(f - thr[:, None, None]).min(axis=(1, 2))


def _inputs(m, seed):
    rng = np.random.default_rng(seed)
    z = rng.uniform(0, 1, m).astype(np.float32)
    aq = rng.uniform(0.5, 0.8, m).astype(np.float32)
    aq[:3] = [0.99, 0.97, 1.2]            # nothing feasible: fallback argmax
    z[3:5] = 0.0                          # fps-independent accuracy: ties
    aq[5] = 0.0                           # everything feasible
    return z, aq


def _y_ok(jl, dead):
    if dead is None:
        return None
    tier_ok = np.ones(2, np.float32)
    tier_ok[dead] = 0.0
    return np.array(jl.tier_y_ok(jnp.asarray(tier_ok)))


def _assert_equal_outside_margin(got, want, margin, what):
    exempt = margin < MARGIN_EXEMPT
    bad = np.zeros(len(margin), bool)
    for name, g, w in zip(("code", "rec_all", "best"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        neq = g != w
        bad |= neq.reshape(len(margin), -1).any(axis=1)
    print(f"{what}: {int(exempt.sum())} lanes with margin < {MARGIN_EXEMPT}, "
          f"{int((bad & exempt).sum())} of them differ")
    assert not (bad & ~exempt).any(), (what, np.nonzero(bad & ~exempt)[0])


@pytest.mark.parametrize("jforce", ["ref", "pallas"])
@pytest.mark.parametrize("dead", [None, 0], ids=["all_up", "edge_down"])
@pytest.mark.parametrize("m", [37, 130])
def test_ccg_encode_matches_reference(m, dead, jforce):
    jsys = jcm.SystemConfig()
    jprob = JProb.build(jsys)
    tprob = RobustProblem.build(tcm.SystemConfig(), "cpu")
    jl, tl = jprob.lat, tprob.lat
    z, aq = _inputs(m, seed=m + (dead or 0))
    y_ok = _y_ok(jl, dead)
    want = j_ccg_encode(jnp.asarray(z), jnp.asarray(aq), jl.rn_flat,
                        jl.pn_flat, jl.tier_flat, jprob.b2_scaled,
                        jprob.rec_table, margin=jsys.acc_margin_robust,
                        num_versions=5, block_m=32, force=jforce,
                        y_ok=None if y_ok is None else jnp.asarray(y_ok))
    got = ccg_encode(torch.from_numpy(z), torch.from_numpy(aq), tl.rn_flat,
                     tl.pn_flat, tl.tier_flat, tprob.b2_scaled,
                     tprob.rec_table, margin=jsys.acc_margin_robust,
                     num_versions=5,
                     y_ok=None if y_ok is None else torch.from_numpy(y_ok))
    assert [t.dtype for t in got] == [torch.int32, torch.float32, torch.int32]
    _assert_equal_outside_margin([t.numpy() for t in got], want,
                                 feasibility_margin(jsys, z, aq),
                                 f"ccg_encode M={m} dead={dead} vs {jforce}")
    code = got[0].numpy()
    alive = slice(0, 50) if dead is None else slice(25, 50)
    assert (code[:3] == 0).all() and (code[5, alive] == 31).all()
    if dead is not None:
        # a dead tier's options are infeasible and lose the fallback argmax
        assert (code[:, :25] == 0).all()
        assert (got[2].numpy() // 5 >= 25).all()


@pytest.mark.parametrize("jforce", ["ref", "pallas"])
@pytest.mark.parametrize("k,gamma", [(3, 1), (6, 2), (5, 0)],
                         ids=["table_k3", "generic_k6", "table_p1"])
def test_ccg_encode_matches_reference_where_the_kernel_branches(k, gamma,
                                                                jforce):
    """The shapes at which the CUDA kernel takes another path or another
    store: K = 3 with Γ = 1 (P = 4, the table path at a smaller K), K = 6
    (P = 22, the generic path) and Γ = 0 (P = 1: a task's P·F = 50 values
    are no whole 16-byte vectors); the dead-tier mask at each."""
    jsys = jcm.SystemConfig(num_versions=k, gamma=gamma)
    jprob = JProb.build(jsys)
    tprob = RobustProblem.build(tcm.SystemConfig(num_versions=k,
                                                 gamma=gamma), "cpu")
    jl, tl = jprob.lat, tprob.lat
    z, aq = _inputs(53, seed=10 * k + gamma)
    for dead in (None, 1):
        y_ok = _y_ok(jl, dead)
        want = j_ccg_encode(jnp.asarray(z), jnp.asarray(aq), jl.rn_flat,
                            jl.pn_flat, jl.tier_flat, jprob.b2_scaled,
                            jprob.rec_table, margin=jsys.acc_margin_robust,
                            num_versions=k, block_m=32, force=jforce,
                            y_ok=None if y_ok is None else jnp.asarray(y_ok))
        got = ccg_encode(torch.from_numpy(z), torch.from_numpy(aq),
                         tl.rn_flat, tl.pn_flat, tl.tier_flat,
                         tprob.b2_scaled, tprob.rec_table,
                         margin=jsys.acc_margin_robust, num_versions=k,
                         y_ok=None if y_ok is None
                         else torch.from_numpy(y_ok))
        assert got[1].shape == (53, tprob.poles.shape[0], 50)
        _assert_equal_outside_margin(
            [t.numpy() for t in got], want, feasibility_margin(jsys, z, aq),
            f"ccg_encode K={k} Γ={gamma} dead={dead} vs {jforce}")
        assert (got[0].numpy()[:3] == 0).all()


@pytest.mark.parametrize("gamma", [2, 0])
def test_recourse_tables_match_reference(gamma):
    """``b2_scaled`` and ``rec_table`` of the port equal the reference's."""
    jprob = JProb.build(jcm.SystemConfig(gamma=gamma))
    tprob = RobustProblem.build(tcm.SystemConfig(gamma=gamma), "cpu")
    np.testing.assert_array_equal(tprob.b2_scaled.numpy(),
                                  np.asarray(jprob.b2_scaled))
    np.testing.assert_array_equal(tprob.rec_table.numpy(),
                                  np.asarray(jprob.rec_table))


@pytest.mark.parametrize("dead", [None, 1], ids=["all_up", "cloud_down"])
def test_table_oracle_equals_fused_encode(dead):
    """The table-based oracle ``_encode_tasks`` and the table-free
    ``_encode_tasks_fused`` agree in the port, and the oracle agrees with
    the reference's."""
    jsys = jcm.SystemConfig()
    jprob = JProb.build(jsys)
    tprob = RobustProblem.build(tcm.SystemConfig(), "cpu")
    z, aq = _inputs(64, seed=11)
    tier_ok = None if dead is None else np.array(
        [1.0, 0.0] if dead == 1 else [0.0, 1.0], np.float32)
    t_tier = None if tier_ok is None else torch.from_numpy(tier_ok)
    f_flat, feas_f, fs_ok, rec_all = _encode_tasks(
        tprob, torch.from_numpy(z), torch.from_numpy(aq), tier_ok=t_tier)
    code, rec_fused, _ = _encode_tasks_fused(
        tprob, torch.from_numpy(z), torch.from_numpy(aq), tier_ok=t_tier)
    assert torch.equal(rec_all, rec_fused)
    assert torch.equal(fs_ok, code > 0)
    want = j_encode_tasks(jprob, jnp.asarray(z), jnp.asarray(aq),
                          tier_ok=None if tier_ok is None
                          else jnp.asarray(tier_ok))
    margin = feasibility_margin(jsys, z, aq)
    keep = margin >= MARGIN_EXEMPT
    for g, w in zip((f_flat, feas_f, fs_ok, rec_all), want):
        g, w = g.numpy()[keep], np.asarray(w)[keep]
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=0, atol=2.5e-7)
        else:
            np.testing.assert_array_equal(g, w)
