"""Port parity: the C6 repair tail, the bandwidth repair and the router
steps around it, LPT packing and realization (repro_torch plain versions vs
the JAX reference, on the CPU).

Draws are gathers of one table, compared exactly.  Feasibility bits
(``can_p``, and through them ``gain`` and the repaired (r, p)) are exact
except on lanes whose smallest margin min |f − (A^q + margin)| over the
(F, K) options, by the reference's formula, is below 1e-6: torch's and
XLA's float32 ``exp`` differ by an ulp on some inputs.  LPT packing is the
same float32 adds in the same order: exact.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core.lattice import DecisionLattice as JLat
from repro.core.router import enforce_bandwidth as j_enforce
from repro.kernels.c6_tail.ops import c6_tail as j_c6_tail
from repro.serving.simulator import _lpt_queue as j_lpt
from repro.serving.simulator import realize_rounds as j_realize
from repro_torch.core import cost_model as tcm
from repro_torch.core.lattice import DecisionLattice as TLat
from repro_torch.core.router import enforce_bandwidth
from repro_torch.kernels.c6_tail.ops import c6_tail
from repro_torch.kernels.lpt_queue.ops import lpt_queue
from repro_torch.serving.simulator import realize_rounds

JSYS, TSYS = jcm.SystemConfig(), tcm.SystemConfig()
JL, TL = JLat.build(JSYS), TLat.build(TSYS, "cpu")
MARGIN_EXEMPT = 1e-6


def feasibility_margin(z, aq):
    """Per lane: min over (F, K) of |f − (A^q + robust margin)| (JAX side)."""
    f = np.asarray(JL.accuracy_flat(jnp.asarray(z)))
    thr = np.asarray(jnp.asarray(aq) + JSYS.acc_margin_robust)
    return np.abs(f - thr[:, None, None]).min(axis=(1, 2))


def _decisions(m, seed, high=False):
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.05, 0.7, m).astype(np.float32)
    aq = rng.uniform(0.5, 0.75, m).astype(np.float32)
    lo = (2, 2, 2) if high else (0, 0, 0)
    d = {"route": rng.integers(0, 2, m),
         "r": rng.integers(lo[0], TSYS.n_res, m),
         "p": rng.integers(lo[1], TSYS.n_fps, m),
         "v": rng.integers(lo[2], TSYS.num_versions, m)}
    d["r"][0] = d["p"][0] = 0          # nothing to demote: gain -BIG
    return z, aq, d


@pytest.mark.parametrize("jforce", ["ref", "pallas"])
@pytest.mark.parametrize("m", [37, 300])
def test_c6_tail_matches_reference(m, jforce):
    z, aq, d = _decisions(m, seed=m)
    thr = (aq + np.float32(JSYS.acc_margin_robust)).astype(np.float32)
    jpanel = jnp.moveaxis(JL.bw, -1, 0)[jnp.asarray(d["route"])].reshape(m, -1)
    want = j_c6_tail(jpanel, *[jnp.asarray(d[k], jnp.int32)
                               for k in ("r", "p", "v", "route")],
                     jnp.asarray(z), jnp.asarray(thr), jcm.res_norm(JSYS),
                     jcm.fps_norm(JSYS), n_fps=5, block_m=64, force=jforce)
    tpanel = torch.movedim(TL.bw, -1, 0)[torch.from_numpy(d["route"])
                                         ].reshape(m, -1)
    got = c6_tail(tpanel, *[torch.from_numpy(d[k].astype(np.int32))
                            for k in ("r", "p", "v", "route")],
                  torch.from_numpy(z), torch.from_numpy(thr),
                  tcm.res_norm(TSYS, "cpu"), tcm.fps_norm(TSYS, "cpu"),
                  n_fps=5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    exempt = feasibility_margin(z, aq) < MARGIN_EXEMPT
    bad = (got[1].numpy() != np.asarray(want[1])) \
        | (got[2].numpy() != np.asarray(want[2]))
    print(f"c6_tail M={m}: {int(exempt.sum())} lanes with margin < "
          f"{MARGIN_EXEMPT}, {int((bad & exempt).sum())} differ")
    assert not (bad & ~exempt).any(), np.nonzero(bad & ~exempt)[0]
    assert float(got[1][0]) == -1e9 and got[1].max() > 0


@pytest.mark.parametrize("m,frac", [(40, 0.5), (96, 0.3)])
def test_enforce_bandwidth_matches_reference(m, frac):
    """An over-budget, slack-carrying batch: repaired (r, p) exact outside
    the margin exemption, the per-round draw history within 1e-6."""
    z, aq, d = _decisions(m, seed=m + 1, high=True)
    jsol = {k: jnp.asarray(v, jnp.int32) for k, v in d.items()}
    tsol = {k: torch.from_numpy(v) for k, v in d.items()}
    budget = frac * float(np.asarray(JL.solution_bandwidth(jsol)).sum())
    jfix, jhist = j_enforce(JSYS, jsol, jnp.asarray(z), jnp.asarray(aq),
                            total_budget=budget, rounds=8, force="ref")
    tfix, thist = enforce_bandwidth(TL, tsol, torch.from_numpy(z),
                                    torch.from_numpy(aq),
                                    total_budget=budget, rounds=8)
    exempt = feasibility_margin(z, aq) < MARGIN_EXEMPT
    bad = np.zeros(m, bool)
    for k in ("r", "p"):
        bad |= tfix[k].numpy() != np.asarray(jfix[k])
    for k in ("route", "v"):
        np.testing.assert_array_equal(tfix[k].numpy(), d[k])
    assert not (bad & ~exempt).any(), np.nonzero(bad & ~exempt)[0]
    if not bad.any():
        np.testing.assert_allclose(thist.numpy(), np.asarray(jhist),
                                   rtol=1e-6)
    # the repair did demote, and the draw never grows round over round
    assert (tfix["r"].numpy() < d["r"]).any() or \
        (tfix["p"].numpy() < d["p"]).any()
    assert np.all(np.diff(thist.numpy()) <= 1e-4)


@pytest.mark.parametrize("shape", [(64,), (3, 50)])
def test_lpt_queue_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    t = rng.uniform(0.01, 1.0, shape).astype(np.float32)
    t.reshape(-1)[:6] = 0.5                  # ties: the stable order decides
    route = rng.integers(0, 2, shape).astype(np.int32)
    want = np.asarray(j_lpt(jnp.asarray(t), jnp.asarray(route), 4, 1))
    got = lpt_queue(torch.from_numpy(t), torch.from_numpy(route), 4, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rounds", [None, 3])
def test_realize_rounds_matches_reference(rounds):
    m = 48
    lead = () if rounds is None else (rounds,)
    rng = np.random.default_rng(11)
    z = rng.uniform(0, 1, lead + (m,)).astype(np.float32)
    d = {k: rng.integers(0, n, lead + (m,)) for k, n in
         (("route", 2), ("r", 5), ("p", 5), ("v", 5))}
    bwm = rng.uniform(0.8, 1.0, lead + (2,)).astype(np.float32)
    u = rng.uniform(0, 0.3, lead + (5,)).astype(np.float32)
    want = j_realize(JSYS, jnp.asarray(z), jnp.asarray(bwm), jnp.asarray(u),
                     *[jnp.asarray(d[k], jnp.int32)
                       for k in ("route", "r", "p", "v")],
                     n_edge=4, n_cloud=1)
    got = realize_rounds(TL, torch.from_numpy(z), torch.from_numpy(bwm),
                         torch.from_numpy(u),
                         *[torch.from_numpy(d[k])
                           for k in ("route", "r", "p", "v")],
                         n_edge=4, n_cloud=1)
    np.testing.assert_array_equal(got["route"].numpy(), d["route"])
    for k in ("delay", "energy", "cost"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["accuracy"].numpy(),
                               np.asarray(want["accuracy"]), rtol=0,
                               atol=2.5e-7)


def test_router_stage1_and_consistency_match_reference():
    """Stage 1, the temporal-consistency override and the availability
    clamp against the reference on one batch (exact outside the Stage-1
    margin exemption)."""
    from repro.core import router as jr
    from repro_torch.core import router as tr

    m = 200
    rng = np.random.default_rng(21)
    z = rng.uniform(0, 1, m).astype(np.float32)
    aq = rng.uniform(0.5, 0.8, m).astype(np.float32)
    taus = rng.uniform(0, 1, m).astype(np.float32)
    prev_tau = rng.uniform(0, 1, m).astype(np.float32)
    prev_route = rng.integers(-1, 2, m)
    route = rng.integers(0, 2, m)
    jcfg, tcfg = jr.RouterConfig(), tr.RouterConfig()
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.from_numpy(np.asarray(a))
    np.testing.assert_array_equal(
        tr.apply_temporal_consistency(T(route), T(prev_route), T(taus),
                                      T(prev_tau), tcfg).numpy(),
        np.asarray(jr.apply_temporal_consistency(
            J(route), J(prev_route), J(taus), J(prev_tau), jcfg)))
    for ok in ([1, 1], [0, 1], [1, 0], [0, 0]):
        np.testing.assert_array_equal(
            tr.clamp_route_available(T(route), T(np.float32(ok))).numpy(),
            np.asarray(jr.clamp_route_available(J(route), J(np.float32(ok)))))
    want = jr.stage1_configure(JSYS, J(taus), J(z), J(aq), J(prev_route),
                               J(prev_tau), jcfg)
    got = tr.stage1_configure(TL, T(taus), T(z), T(aq), T(prev_route),
                              T(prev_tau), tcfg)
    s1 = np.asarray(jcm.accuracy_stage1(JSYS, J(z)))
    exempt = np.abs(s1 - aq[:, None]).min(axis=1) < MARGIN_EXEMPT
    for g, w in zip(got, want):
        assert not ((g.numpy() != np.asarray(w)) & ~exempt).any()
