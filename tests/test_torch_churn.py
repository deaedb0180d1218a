"""Slot-pool churn with SLA-aware admission in the port (plain versions, on
the CPU) against the live JAX package: the admission step, the masked C6
repair, and the churned ``ServeSession.run`` of every policy.

The admission bookkeeping (alive, degrade pins, queue, newly admitted,
admitted, dropped) and the decisions are compared exactly, the metrics to
1e-5 relative; the masked repair exactly outside the boundary exemption of
``test_torch_c6_repair.py`` (the draw and the prefix gains sum in torch's
order, not XLA's).  Also the reference's own churn invariants
(``tests/test_churn.py``): a constant pool equals the compacted dense run,
no segment lands on a dead slot or a downed tier, and the refusals.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_kernel_orders import c6_repair_emulated, compare_runs

from repro.core import cost_model as jcm
from repro.core.features import feature_dim
from repro.core.gating import GateConfig as JGateConfig
from repro.core.gating import gate_specs
from repro.core.lattice import DecisionLattice as JLat
from repro.core.router import enforce_bandwidth as j_enforce
from repro.models.params import init_params
from repro.serving import scenarios as jsc
from repro.serving.policy import Observation as JObs
from repro.serving.policy import make_policy as j_make_policy
from repro.serving.session import AdmissionConfig as JAdmission
from repro.serving.session import ServeSession as JSession
from repro.serving.session import _churn_admit as j_churn_admit
from repro.serving.simulator import SimConfig as JSimConfig
from repro.serving.simulator import Simulator as JSimulator
from repro_torch.convert import gate_params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core.gating import GateConfig
from repro_torch.core.lattice import DecisionLattice as TLat
from repro_torch.core.router import enforce_bandwidth
from repro_torch.kernels.c6_tail.ref import c6_repair_ref
from repro_torch.serving import scenarios as tsc
from repro_torch.serving.policy import Observation, make_policy
from repro_torch.serving.session import AdmissionConfig, ServeSession
from repro_torch.serving.session import _churn_admit
from repro_torch.serving.simulator import SimConfig

JSYS, TSYS = jcm.SystemConfig(), tcm.SystemConfig()
JL, TL = JLat.build(JSYS), TLat.build(TSYS, "cpu")
POLICIES = ("a2_cloud_only", "jcab", "rdap", "sniper", "r2evid")
M, R = 48, 12
MET_KEYS = ("delay", "energy", "cost", "accuracy")
CHURN_KEYS = ("alive", "queue_depth", "admitted", "dropped")


def _streams(m=M, r=R, seed=5):
    """The same sampled stream for both packages (JAX's, as numpy)."""
    simc = dict(n_tasks=m, n_rounds=r, seed=seed, bw_fluctuation=0.2)
    js = JSimulator(JSYS, JSimConfig(**simc)).sample_stream(r)
    ts = Observation(**{f.name: None if getattr(js, f.name) is None
                        else torch.from_numpy(np.array(getattr(js, f.name)))
                        for f in dataclasses.fields(Observation)})
    return JSimConfig(**simc), js, SimConfig(**simc), ts


def _with_churn(js, ts, arrive, depart):
    return (dataclasses.replace(js, arrive_n=jnp.asarray(arrive, jnp.int32),
                                depart=jnp.asarray(depart)),
            dataclasses.replace(ts, arrive_n=torch.from_numpy(arrive),
                                depart=torch.from_numpy(depart)))


def _assert_runs_equal(jm, tm, keys):
    for k in keys:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                      err_msg=k)
    for k in MET_KEYS:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# the admission step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", range(8))
def test_churn_admit_matches_reference(case):
    """One admission step on random pools, queues, arrivals, departures and
    budgets (scarce and not, the cap at and around the pool's size):
    alive, degr, queue, newly, admitted and dropped equal."""
    rng = np.random.default_rng(case)
    m = (7, 48, 96, 4096)[case % 4]
    alive = rng.random(m) < rng.uniform(0.1, 0.95)
    degr = alive & (rng.random(m) < 0.3)
    depart = rng.random(m) < 0.2
    queue = np.int32(rng.integers(0, 70))
    arrive = np.int32(rng.integers(0, 2 * m))
    bw_floor = np.float32(JL.bw[0, 0, :].max())
    budget = np.float32(rng.uniform(0.05, 1.2) * 600.0)
    if case == 7:   # exactly the per-stream floor times a pool size
        budget = np.float32(bw_floor * 40 / 0.95)
    acfg = dict(max_queue=int(rng.integers(1, 80)), margin=0.05,
                degrade_frac=0.5)
    valid = np.ones(m, bool)
    want = j_churn_admit(
        jnp.asarray(alive), jnp.asarray(degr), jnp.asarray(queue),
        jnp.asarray(arrive), jnp.asarray(depart), jnp.asarray(budget),
        jnp.asarray(np.float32(600.0)), jnp.asarray(bw_floor),
        JAdmission(**acfg), jnp.asarray(valid))
    got = _churn_admit(
        torch.from_numpy(alive), torch.from_numpy(degr),
        torch.tensor(queue), torch.tensor(arrive), torch.from_numpy(depart),
        torch.tensor(budget), torch.tensor(np.float32(600.0)),
        TL.bw[0, 0, :].max(), AdmissionConfig(**acfg),
        torch.from_numpy(valid))
    for name, g, w in zip(("alive", "degr", "queue", "newly", "admitted",
                           "dropped"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_admission_cap_at_the_paper_config():
    """The cap at the nominal 600 Mbps with the 5% margin: 2061 streams of
    the 0.27648 Mbps minimum-fidelity draw, on both packages."""
    m = 4096
    args = dict(queue=0, arrive=m, budget=np.float32(600.0))
    outs = []
    for admit, t, acfg in ((j_churn_admit, jnp.asarray, JAdmission()),
                           (_churn_admit, torch.as_tensor, AdmissionConfig())):
        floor = (JL if t is jnp.asarray else TL).bw[0, 0, :].max()
        out = admit(t(np.zeros(m, bool)), t(np.zeros(m, bool)),
                    t(np.int32(args["queue"])), t(np.int32(args["arrive"])),
                    t(np.zeros(m, bool)), t(args["budget"]),
                    t(np.float32(600.0)), floor, acfg, t(np.ones(m, bool)))
        outs.append(int(np.asarray(out[4])))
    assert outs == [2061, 2061]
    assert float(TL.bw[0, 0, :].max()) == pytest.approx(0.27648, rel=1e-6)


# ---------------------------------------------------------------------------
# the masked C6 repair
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alive_frac", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("m", [40, 96, 4096])
def test_enforce_bandwidth_task_mask_matches_reference(m, alive_frac):
    """``enforce_bandwidth(task_mask=)`` against the live JAX repair on
    decisions with ties (gains are differences of one 50-entry table), a
    budget that makes the alive lanes demote; dead lanes keep their r, p."""
    rng = np.random.default_rng(m)
    z = rng.uniform(0.05, 0.7, m).astype(np.float32)
    aq = rng.uniform(0.5, 0.75, m).astype(np.float32)
    d = {"route": rng.integers(0, 2, m), "r": rng.integers(2, 5, m),
         "p": rng.integers(2, 5, m), "v": rng.integers(2, 5, m)}
    mask = rng.random(m) < alive_frac
    draw = np.asarray(JL.solution_bandwidth(
        {k: jnp.asarray(v, jnp.int32) for k, v in d.items()}))
    budget = float(np.float32(0.5 * draw[mask].sum()))
    jsol = {k: jnp.asarray(v, jnp.int32) for k, v in d.items()}
    tsol = {k: torch.from_numpy(v) for k, v in d.items()}
    tmask = torch.from_numpy(mask)

    def run_j(k):
        fix, hist = j_enforce(JSYS, jsol, jnp.asarray(z), jnp.asarray(aq),
                              total_budget=budget, rounds=k,
                              task_mask=jnp.asarray(mask))
        return (torch.from_numpy(np.asarray(fix["r"]).astype(np.int64)),
                torch.from_numpy(np.asarray(fix["p"]).astype(np.int64)),
                torch.from_numpy(np.array(hist)))

    def run_t(k):
        fix, hist = enforce_bandwidth(TL, tsol, torch.from_numpy(z),
                                      torch.from_numpy(aq),
                                      total_budget=budget, rounds=k,
                                      task_mask=tmask)
        return fix["r"], fix["p"], hist

    t = {k: torch.from_numpy(v) for k, v in d.items()}
    panel = torch.movedim(TL.bw, -1, 0)[t["route"]].reshape(m, -1)
    args = (panel, t["r"], t["p"], t["v"], t["route"], torch.from_numpy(z),
            torch.from_numpy(aq) + TSYS.acc_margin_robust,
            tcm.res_norm(TSYS, "cpu"), tcm.fps_norm(TSYS, "cpu"))
    demoting = compare_runs(run_t, run_j, 8, args, budget, (), tmask)
    r, p, _ = run_t(8)
    assert torch.equal(r[~tmask], t["r"][~tmask])
    assert torch.equal(p[~tmask], t["p"][~tmask])
    if alive_frac == 0.0:
        assert demoting == 0
    else:
        assert demoting >= 1 and bool((r[tmask] != t["r"][tmask]).any()
                                      or (p[tmask] != t["p"][tmask]).any())


@pytest.mark.parametrize("alive_frac", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("m", [60, 4096])
def test_kernel_order_with_alive_mask_matches_plain(m, alive_frac):
    """``c6_repair``'s kernel order with the alive mask (emulated on the
    CPU, bit-equal to the kernel on the card) against the plain masked
    repair: equal outside the boundary exemption; dead lanes never move."""
    rng = np.random.default_rng(m + 1)
    d = {"route": rng.integers(0, 2, m), "r": rng.integers(2, 5, m),
         "p": rng.integers(2, 5, m), "v": rng.integers(2, 5, m)}
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    panel = torch.movedim(TL.bw, -1, 0)[t["route"]].reshape(m, -1)
    z = torch.from_numpy(rng.uniform(0.05, 0.7, m).astype(np.float32))
    thr = torch.from_numpy(rng.uniform(0.52, 0.77, m).astype(np.float32))
    args = (panel, t["r"], t["p"], t["v"], t["route"], z, thr,
            tcm.res_norm(TSYS, "cpu"), tcm.fps_norm(TSYS, "cpu"))
    mask = torch.from_numpy(rng.random(m) < alive_frac)
    draw = panel.gather(1, (t["r"] * 5 + t["p"])[:, None])[:, 0]
    budget = float(np.float32(0.4 * float(draw[mask].sum())))
    run_e = lambda k: c6_repair_emulated(*args, budget, n_fps=5, rounds=k,
                                         task_mask=mask)
    run_r = lambda k: c6_repair_ref(*args, budget, n_fps=5, rounds=k,
                                    task_mask=mask)
    demoted = compare_runs(run_e, run_r, 8, args, budget, (), mask)
    r, p, _ = run_e(8)
    assert torch.equal(r[~mask], t["r"][~mask])
    assert torch.equal(p[~mask], t["p"][~mask])
    assert (demoted >= 1) == (alive_frac > 0)


# ---------------------------------------------------------------------------
# the churned run
# ---------------------------------------------------------------------------
def _policies(name):
    return j_make_policy(name, JSYS), make_policy(name, TSYS, device="cpu")


@pytest.mark.parametrize("scenario", ["churn", "flash_churn"])
@pytest.mark.parametrize("policy", POLICIES)
def test_churned_run_matches_reference(policy, scenario):
    """Every policy through ``churn`` and ``flash_churn``: the churn
    bookkeeping and decisions exact, metrics within 1e-5; the traces equal
    array for array."""
    jsimc, js, tsimc, ts = _streams(seed=len(policy))
    jt = jsc.compile_scenario(scenario, JSYS, jsimc, R, seed=1)
    tt = tsc.compile_scenario(scenario, TSYS, tsimc, R, seed=1)
    np.testing.assert_array_equal(tt.arrive_n, jt.arrive_n)
    np.testing.assert_array_equal(tt.depart, jt.depart)
    assert dataclasses.asdict(tt.admission) == dataclasses.asdict(
        jt.admission)
    jp, tp = _policies(policy)
    jm = JSession(jp, M, sim=jsimc, admission=jt.admission).run(
        jsc.apply_scenario(js, jt))
    tm = ServeSession(tp, M, sim=tsimc, device="cpu",
                      admission=tt.admission).run(
        tsc.apply_scenario(ts, tt))
    _assert_runs_equal(jm, tm, ("route", "r", "p", "v") + CHURN_KEYS)
    assert set(tm) == set(jm)
    assert int(tm["admitted"].sum()) > 0


def test_churn_carry_continues_across_runs():
    """Two runs of one session continue the slot pool (alive, degrade pins,
    queue) as the reference's session does."""
    jsimc, js, tsimc, ts = _streams(r=2 * 6, seed=9)
    rng = np.random.default_rng(3)
    arrive = rng.poisson(6.0, size=12).astype(np.int32)
    depart = rng.random((12, M)) < 0.2
    js, ts = _with_churn(js, ts, arrive, depart)
    acfg = dict(init_alive=M // 3, max_queue=5)
    jp, tp = _policies("rdap")
    jsess = JSession(jp, M, sim=jsimc, admission=JAdmission(**acfg))
    tsess = ServeSession(tp, M, sim=tsimc, device="cpu",
                         admission=AdmissionConfig(**acfg))
    for half in (slice(0, 6), slice(6, 12)):
        jm = jsess.run(JObs(**{f.name: None if getattr(js, f.name) is None
                                else getattr(js, f.name)[half]
                                for f in dataclasses.fields(JObs)}))
        tm = tsess.run(Observation(**{
            f.name: None if getattr(ts, f.name) is None
            else getattr(ts, f.name)[half]
            for f in dataclasses.fields(Observation)}))
        _assert_runs_equal(jm, tm, ("route", "r", "p", "v") + CHURN_KEYS)


@pytest.mark.parametrize("name", ["rdap", "r2evid"])
def test_constant_pool_matches_compacted_dense_run(name):
    """A constant half-full pool (no churn events) equals a dense run on
    the alive half: masking is compaction (``tests/test_churn.py:104``)."""
    k = M // 2
    _, _, tsimc, ts = _streams()
    frozen = dataclasses.replace(
        ts, arrive_n=torch.zeros((R,), dtype=torch.int32),
        depart=torch.zeros((R, M), dtype=torch.bool))
    pol = make_policy(name, TSYS, device="cpu")
    churn = ServeSession(pol, M, sim=tsimc, device="cpu",
                         admission=AdmissionConfig(init_alive=k)).run(frozen)
    alive = churn["alive"].numpy()
    assert (alive == (np.arange(M) < k)[None, :]).all()
    slim = Observation(**{
        f.name: None if getattr(ts, f.name) is None
        else (getattr(ts, f.name)[:, :k] if getattr(ts, f.name).dim() >= 2
              and getattr(ts, f.name).shape[1] == M
              else getattr(ts, f.name))
        for f in dataclasses.fields(Observation)})
    dense = ServeSession(pol, k, sim=dataclasses.replace(tsimc, n_tasks=k),
                         device="cpu").run(slim)
    for key in dense:
        np.testing.assert_allclose(churn[key][:, :k].numpy(),
                                   dense[key].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=key)
    for key in MET_KEYS:
        assert (churn[key][:, k:] == 0.0).all(), key
    assert (churn["route"][:, k:] == -1).all()


def test_no_segment_lands_on_dead_slot_or_downed_tier():
    """Churn with an edge outage: dead slots never realize (route -1, zero
    metrics) and no alive lane routes to the edge while its quorum gate is
    down (``tests/test_churn.py:201``)."""
    _, _, tsimc, ts = _streams()
    rng = np.random.default_rng(0)
    arrive = rng.poisson(2.0, size=R).astype(np.int32)
    depart = rng.random((R, M)) < 0.15
    ts = dataclasses.replace(ts, arrive_n=torch.from_numpy(arrive),
                             depart=torch.from_numpy(depart))
    trace = tsc.compile_scenario("edge_outage", TSYS, tsimc, R, seed=0)
    mets = ServeSession(make_policy("r2evid", TSYS, device="cpu"), M,
                        sim=tsimc, device="cpu",
                        admission=AdmissionConfig(init_alive=M // 2)).run(
        tsc.apply_scenario(ts, trace))
    alive = mets["alive"].numpy()
    route = mets["route"].numpy()
    assert (route[~alive] == -1).all()
    for key in MET_KEYS:
        vals = mets[key].numpy()
        assert (vals[~alive] == 0.0).all(), key
        assert np.isfinite(vals).all(), key
    edge_down = trace.tier_ok[:, 0] == 0.0
    assert edge_down.any()
    assert (route[edge_down] != 0).all()


def test_churn_requires_admission_config_and_both_traces():
    """``tests/test_churn.py:276``."""
    _, _, tsimc, ts = _streams()
    rng = np.random.default_rng(1)
    cstream = dataclasses.replace(
        ts, arrive_n=torch.from_numpy(rng.poisson(2.0, R).astype(np.int32)),
        depart=torch.from_numpy(rng.random((R, M)) < 0.15))
    sess = ServeSession(make_policy("rdap", TSYS, device="cpu"), M,
                        sim=tsimc, device="cpu")
    with pytest.raises(ValueError, match="AdmissionConfig"):
        sess.run(cstream)
    sess2 = ServeSession(make_policy("rdap", TSYS, device="cpu"), M,
                         sim=tsimc, device="cpu",
                         admission=AdmissionConfig())
    with pytest.raises(ValueError, match="BOTH"):
        sess2.run(dataclasses.replace(cstream, depart=None))
    with pytest.raises(ValueError, match="run"):
        sess2.step(cstream.round(0))


def test_churn_rejects_hedge():
    """``tests/test_churn.py:288``."""
    _, _, tsimc, ts = _streams()
    cstream = dataclasses.replace(
        ts, arrive_n=torch.zeros((R,), dtype=torch.int32),
        depart=torch.zeros((R, M), dtype=torch.bool))
    sess = ServeSession(make_policy("rdap", TSYS, device="cpu"), M,
                        sim=tsimc, device="cpu", admission=AdmissionConfig(),
                        hedge=(0.9, 0.05))
    with pytest.raises(ValueError, match="hedge"):
        sess.run(cstream)


@pytest.mark.parametrize("policy", POLICIES + ("r2evid_gate",))
def test_reset_streams_matches_reference(policy):
    """``reset_streams`` after two rounds: the re-admitted rows equal a
    fresh ``init``'s, the others keep the carry (Sniper's profile table is
    shared memory and resets nothing), on both packages alike."""
    _, js, _, ts = _streams(r=2, seed=4)
    fresh = np.arange(M) % 3 == 1
    if policy == "r2evid_gate":
        jcfg = JGateConfig(d_feature=feature_dim())
        tcfg = GateConfig(d_feature=feature_dim())
        rng = np.random.default_rng(0)
        dx = rng.normal(size=(2, M, feature_dim())).astype(np.float32)
        js = dataclasses.replace(js, dx=jnp.asarray(dx))
        ts = dataclasses.replace(ts, dx=torch.from_numpy(dx))
        jgp = init_params(gate_specs(jcfg), jax.random.PRNGKey(0))
        jp = j_make_policy("r2evid", JSYS, gate_params=jgp, gate_cfg=jcfg)
        tp = make_policy("r2evid", TSYS, device="cpu", gate_cfg=tcfg,
                         gate_params=gate_params_from_numpy(
                             {k: np.asarray(v) for k, v in jgp.items()},
                             "cpu"))
    else:
        jp, tp = _policies(policy)
    jst, tst = jp.init(M), tp.init(M)
    for i in range(2):
        jst, _ = jp.decide(jst, JObs(**{
            f.name: None if getattr(js, f.name) is None
            else getattr(js, f.name)[i] for f in dataclasses.fields(JObs)}))
        tst, _ = tp.decide(tst, ts.round(i))
    jst = jp.reset_streams(jst, jnp.asarray(fresh))
    tst = tp.reset_streams(tst, torch.from_numpy(fresh))
    jleaves = jax.tree_util.tree_leaves(jst)
    tleaves = _torch_leaves(tst)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t.numpy().astype(np.float64),
                                   np.asarray(j).astype(np.float64),
                                   rtol=0, atol=1e-5)


def _torch_leaves(state):
    if isinstance(state, torch.Tensor):
        return [state]
    if dataclasses.is_dataclass(state):
        return [x for f in dataclasses.fields(state)
                for x in _torch_leaves(getattr(state, f.name))]
    if isinstance(state, tuple):
        return [x for s in state for x in _torch_leaves(s)]
    return []
