"""The scenario engine in the port (plain versions, on the CPU) against the
live JAX package and against ``SCENARIO_GOLDENS.json``: the trace builders,
``apply_scenario``, hedged dispatch, the scenario inputs of
``realize_rounds``, ``ccg_solve`` with tiers out, ``ServeSession.run`` of
R2E-VID (τ-proxy and gate mode) through every scenario, and ``run_suite``
at the golden point.

Traces are compared array for array, decisions and the churn bookkeeping
exactly, metrics to 1e-5 relative, the fused solve exactly (the same bar as
``test_torch_ccg_solve.py``, no lane of these inputs near a feasibility
threshold), and the golden rows at rtol = atol = 2e-3, the tolerance of the
reference's own golden test (``tests/test_scenarios.py``).
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core.features import feature_dim
from repro.core.gating import GateConfig as JGateConfig
from repro.core.gating import gate_specs
from repro.core.robust import RobustProblem as JProb
from repro.kernels.ccg_solve.ops import ccg_solve as j_ccg_solve
from repro.models.params import init_params
from repro.runtime import straggler as jstrag
from repro.serving import scenarios as jsc
from repro.serving.policy import make_policy as j_make_policy
from repro.serving.session import ServeSession as JSession
from repro.serving.simulator import SimConfig as JSimConfig
from repro.serving.simulator import Simulator as JSimulator
from repro.serving.simulator import realize_rounds as j_realize
from repro_torch.convert import gate_params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core.gating import GateConfig
from repro_torch.core.lattice import DecisionLattice as TLat
from repro_torch.core.robust import RobustProblem, solve_ccg_fused
from repro_torch.kernels.ccg_solve.ops import ccg_solve
from repro_torch.runtime.straggler import hedged_dispatch
from repro_torch.serving import scenarios as tsc
from repro_torch.serving.policy import Observation, make_policy
from repro_torch.serving.session import ServeSession
from repro_torch.serving.simulator import SimConfig, realize_rounds

ROOT = Path(__file__).resolve().parents[1]
JSYS, TSYS = jcm.SystemConfig(), tcm.SystemConfig()
TL = TLat.build(TSYS, "cpu")
NAMES = ("none",) + tsc.SUITE
FIELDS = ("tier_ok", "avail", "bw_mult", "bw_scale", "u", "lat_mult",
          "arrive_n", "depart")
M, R = 48, 12
DEC_KEYS = ("route", "r", "p", "v")
MET_KEYS = ("delay", "energy", "cost", "accuracy")


def _to_torch(obs):
    return Observation(**{f.name: None if getattr(obs, f.name) is None
                          else torch.from_numpy(np.array(getattr(obs, f.name)))
                          for f in dataclasses.fields(Observation)})


def test_suite_and_registry_match_reference():
    assert tsc.SUITE == jsc.SUITE
    assert list(tsc.SCENARIOS) == list(jsc.SCENARIOS)
    assert tsc.SLA_PENALTY == jsc.SLA_PENALTY


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", NAMES)
def test_builder_matches_reference(name, seed):
    """A (name, shape, seed) triple gives the reference's arrays, onset,
    hedge and admission knobs."""
    simc = dict(n_tasks=40, n_rounds=20, seed=1)
    jt = jsc.compile_scenario(name, JSYS, JSimConfig(**simc), seed=seed)
    tt = tsc.compile_scenario(name, TSYS, SimConfig(**simc), seed=seed)
    assert (tt.name, tt.onset, tt.hedge) == (jt.name, jt.onset, jt.hedge)
    assert (tt.admission is None) == (jt.admission is None)
    if jt.admission is not None:
        assert dataclasses.asdict(tt.admission) == \
            dataclasses.asdict(jt.admission)
    for fld in FIELDS:
        j, t = getattr(jt, fld), getattr(tt, fld)
        assert (j is None) == (t is None), fld
        if j is not None:
            assert np.asarray(t).dtype == np.asarray(j).dtype, fld
            np.testing.assert_array_equal(np.asarray(t), np.asarray(j),
                                          err_msg=fld)


def test_compile_scenario_refuses_unknown_names():
    with pytest.raises(KeyError, match="unknown scenario"):
        tsc.compile_scenario("nope", TSYS, SimConfig())


@pytest.mark.parametrize("name", NAMES)
def test_apply_scenario_matches_reference(name):
    """``apply_scenario`` field for field: composed bandwidth, replaced u,
    attached scenario and churn fields (dtypes included); ``none`` returns
    the stream itself."""
    simc = dict(n_tasks=16, n_rounds=9, seed=2, bw_fluctuation=0.2)
    js = JSimulator(JSYS, JSimConfig(**simc)).sample_stream(9, feature_seed=3)
    ts = _to_torch(js)
    jd = jsc.apply_scenario(js, jsc.compile_scenario(
        name, JSYS, JSimConfig(**simc), seed=4))
    td = tsc.apply_scenario(ts, tsc.compile_scenario(
        name, TSYS, SimConfig(**simc), seed=4))
    if name == "none":
        assert td is ts
    for f in dataclasses.fields(Observation):
        j, t = getattr(jd, f.name), getattr(td, f.name)
        assert (j is None) == (t is None), f.name
        if j is not None:
            assert t.numpy().dtype == np.asarray(j).dtype, f.name
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f.name)


def test_apply_scenario_refuses_half_a_churn_trace():
    trace = tsc.ScenarioTrace(name="half", arrive_n=np.ones(3, np.int32))
    stream = _to_torch(JSimulator(JSYS, JSimConfig(n_tasks=4)).sample_stream(3))
    with pytest.raises(ValueError, match="arrive_n/depart"):
        tsc.apply_scenario(stream, trace)


# ---------------------------------------------------------------------------
# hedged dispatch and the realization's scenario inputs
# ---------------------------------------------------------------------------
def _hedged_dispatch_numpy(latencies, *, hedge_quantile=0.9, hedge_cost=0.05):
    """The reference's numpy oracle (``repro/runtime/straggler.py``),
    copied: float64, ``np.quantile``."""
    lat = np.asarray(latencies, np.float64)
    primary = lat[:, 0]
    deadline = np.quantile(primary, hedge_quantile)
    if lat.shape[1] < 2:
        return primary
    backup = lat[:, 1] + deadline + hedge_cost
    return np.where(primary > deadline, np.minimum(primary, backup), primary)


@pytest.mark.parametrize("n,replicas,q", [(64, 2, 0.9), (4096, 2, 0.9),
                                          (37, 2, 0.5), (50, 1, 0.9)])
def test_hedged_dispatch_matches_oracles(n, replicas, q):
    """The torch port against the reference's jnp port (float32, equal to
    1 ulp) and the numpy oracle (float64, to float32 rounding)."""
    rng = np.random.default_rng(n)
    lat = np.clip((1.0 - rng.uniform(size=(n, replicas))) ** (-1 / 1.5),
                  1.0, 20.0).astype(np.float32)
    got = hedged_dispatch(torch.from_numpy(lat), hedge_quantile=q).numpy()
    want = np.asarray(jstrag.hedged_dispatch_jnp(jnp.asarray(lat),
                                                 hedge_quantile=q))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    np.testing.assert_allclose(got, _hedged_dispatch_numpy(
        lat, hedge_quantile=q), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        got, jstrag.hedged_dispatch(lat, hedge_quantile=q), rtol=1e-6)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.9, 0.99, 1.0])
def test_hedged_dispatch_per_round_matches_jnp(q):
    """With a leading round axis the deadline is each round's own
    quantile: equal to ``hedged_dispatch_jnp`` up to the one rounding of
    the interpolation that XLA may fuse into a multiply-add."""
    x = np.random.default_rng(3).uniform(1.0, 20.0, (3, 4093, 2)).astype(
        np.float32)
    got = hedged_dispatch(torch.from_numpy(x), hedge_quantile=q).numpy()
    want = np.asarray(jstrag.hedged_dispatch_jnp(jnp.asarray(x),
                                                 hedge_quantile=q))
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    assert (got <= x[..., 0]).all()


def _decisions(rounds, m, seed):
    rng = np.random.default_rng(seed)
    d = {"route": rng.integers(0, 2, (rounds, m)),
         "r": rng.integers(0, 5, (rounds, m)),
         "p": rng.integers(0, 5, (rounds, m)),
         "v": rng.integers(0, 5, (rounds, m))}
    z = rng.uniform(0, 1, (rounds, m)).astype(np.float32)
    bw = rng.uniform(0.7, 1.0, (rounds, 2)).astype(np.float32)
    u = rng.uniform(0, 0.3, (rounds, 5)).astype(np.float32)
    lat = np.clip((1.0 - rng.uniform(size=(rounds, m, 2))) ** (-1 / 1.5),
                  1.0, 20.0).astype(np.float32)
    avail = np.ones((rounds, 5), np.float32)
    avail[1, 2] = 0.0                   # one edge server down
    avail[2, 4] = 0.0                   # the cloud tier down: clamp to edge
    mask = rng.random((rounds, m)) < 0.6
    return d, z, bw, u, lat, avail, mask


REALIZE_CASES = {
    "avail": dict(avail=True),
    "lat_mult": dict(lat_mult=True),
    "hedge": dict(lat_mult=True, hedge=(0.9, 0.05)),
    "avail_hedge": dict(avail=True, lat_mult=True, hedge=(0.75, 0.1)),
    "task_mask": dict(task_mask=True),
    "task_mask_avail": dict(task_mask=True, avail=True),
}


@pytest.mark.parametrize("case", sorted(REALIZE_CASES))
def test_realize_rounds_scenario_inputs_match_reference(case):
    """``realize_rounds`` with ``avail`` / ``lat_mult`` + ``hedge`` /
    ``task_mask`` against the live JAX realization (LPT on its plain
    version): metrics within 1e-5, routes exact."""
    kw = REALIZE_CASES[case]
    d, z, bw, u, lat, avail, mask = _decisions(3, 64, seed=len(case))
    jkw, tkw = {}, {}
    for key, arr in (("avail", avail), ("lat_mult", lat),
                     ("task_mask", mask)):
        if kw.get(key):
            jkw[key], tkw[key] = jnp.asarray(arr), torch.from_numpy(arr)
    if "hedge" in kw:
        jkw["hedge"] = tkw["hedge"] = kw["hedge"]
    want = j_realize(JSYS, jnp.asarray(z), jnp.asarray(bw), jnp.asarray(u),
                     *(jnp.asarray(d[k], jnp.int32) for k in DEC_KEYS),
                     n_edge=4, n_cloud=1, **jkw)
    got = realize_rounds(TL, torch.from_numpy(z), torch.from_numpy(bw),
                         torch.from_numpy(u),
                         *(torch.from_numpy(d[k]) for k in DEC_KEYS),
                         n_edge=4, n_cloud=1, **tkw)
    np.testing.assert_array_equal(got["route"].numpy(),
                                  np.asarray(want["route"]))
    for k in MET_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    if kw.get("avail"):
        assert (got["route"][2] <= 0).all()     # the dead cloud tier
    if kw.get("task_mask"):
        assert (got["route"].numpy()[~mask] == -1).all()


def test_realize_rounds_refusals():
    d, z, bw, u, lat, _, mask = _decisions(3, 8, seed=0)
    args = (TL, torch.from_numpy(z[0]), torch.from_numpy(bw[0]),
            torch.from_numpy(u[0]),
            *(torch.from_numpy(d[k][0]) for k in DEC_KEYS))
    with pytest.raises(ValueError, match="lat_mult"):
        realize_rounds(*args, n_edge=4, n_cloud=1, hedge=(0.9, 0.05))
    with pytest.raises(ValueError, match="task_mask"):
        realize_rounds(*args, n_edge=4, n_cloud=1, hedge=(0.9, 0.05),
                       lat_mult=torch.from_numpy(lat[0]),
                       task_mask=torch.from_numpy(mask[0]))


# ---------------------------------------------------------------------------
# the fused solve with tiers out
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jforce", ["ref", "pallas"])
@pytest.mark.parametrize("tier_ok", [(0, 1), (1, 0), (0, 0)],
                         ids=["edge_out", "cloud_out", "both_out"])
def test_ccg_solve_tier_out_matches_reference(tier_ok, jforce):
    """``solve_ccg_fused(tier_ok=)`` (the plain ``ccg_solve`` with its
    ``y_ok``) against the JAX ref and the interpret-mode Pallas kernel:
    exact.  No lane lands on a dead tier unless both are dead, where every
    lane is infeasible and takes the reference's fallback index."""
    jprob = JProb.build(JSYS)
    tprob = RobustProblem.build(TSYS, "cpu")
    jl = jprob.lat
    rng = np.random.default_rng(sum(tier_ok))
    m = 37
    z = rng.uniform(0, 1, m).astype(np.float32)
    aq = rng.uniform(0.5, 0.8, m).astype(np.float32)
    wy = rng.integers(-1, 50, m).astype(np.int32)
    ok = np.asarray(tier_ok, np.float32)
    want = j_ccg_solve(jnp.asarray(z), jnp.asarray(aq), jl.rn_flat,
                       jl.pn_flat, jl.tier_flat, jl.b2_flat,
                       jprob.poles * jl.u_dev, jl.c1_flat, jnp.asarray(wy),
                       margin=JSYS.acc_margin_robust, num_versions=5,
                       block_m=32, force=jforce,
                       y_ok=jl.tier_y_ok(jnp.asarray(ok)))
    sol = solve_ccg_fused(tprob, torch.from_numpy(z), torch.from_numpy(aq),
                          warm_y=torch.from_numpy(wy),
                          tier_ok=torch.from_numpy(ok))
    got = ccg_solve(torch.from_numpy(z), torch.from_numpy(aq),
                    tprob.lat.rn_flat, tprob.lat.pn_flat, tprob.lat.tier_flat,
                    tprob.lat.b2_flat, tprob.u_all, tprob.lat.c1_flat,
                    torch.from_numpy(wy), margin=JSYS.acc_margin_robust,
                    num_versions=5,
                    y_ok=tprob.lat.tier_y_ok(torch.from_numpy(ok)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert torch.equal(sol["route"], tprob.lat.unflatten_index(
        got[0].long())[0])
    if ok.any():
        dead = int(np.nonzero(ok == 0)[0][0])
        assert not bool((sol["route"] == dead).any())
        assert not bool(sol["infeasible"].all())
    else:
        assert bool(sol["infeasible"].all())


# ---------------------------------------------------------------------------
# the session through every scenario
# ---------------------------------------------------------------------------
JGCFG = JGateConfig(d_feature=feature_dim())
JGPARAMS = init_params(gate_specs(JGCFG), jax.random.PRNGKey(0))


def _policies(mode):
    if mode == "tau_proxy":
        return (j_make_policy("r2evid", JSYS),
                make_policy("r2evid", TSYS, device="cpu"))
    return (j_make_policy("r2evid", JSYS, gate_params=JGPARAMS,
                          gate_cfg=JGCFG),
            make_policy("r2evid", TSYS, device="cpu",
                        gate_cfg=GateConfig(d_feature=feature_dim()),
                        gate_params=gate_params_from_numpy(
                            {k: np.asarray(v) for k, v in JGPARAMS.items()},
                            "cpu")))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mode", ["tau_proxy", "gate"])
def test_session_run_under_scenario_matches_reference(mode, name):
    """R2E-VID through each scenario at M = 48, R = 12 against the live JAX
    session: decisions, and on churn runs the bookkeeping, exact; metrics
    within 1e-5 relative, τ within 1e-5."""
    simc = dict(n_tasks=M, n_rounds=R, seed=3, bw_fluctuation=0.2)
    js = JSimulator(JSYS, JSimConfig(**simc)).sample_stream(
        R, feature_seed=1 if mode == "gate" else None)
    jt = jsc.compile_scenario(name, JSYS, JSimConfig(**simc), seed=0)
    tt = tsc.compile_scenario(name, TSYS, SimConfig(**simc), seed=0)
    jp, tp = _policies(mode)
    jm = JSession(jp, M, sim=JSimConfig(**simc), hedge=jt.hedge,
                  admission=jt.admission).run(jsc.apply_scenario(js, jt))
    tm = ServeSession(tp, M, sim=SimConfig(**simc), device="cpu",
                      hedge=tt.hedge, admission=tt.admission).run(
        tsc.apply_scenario(_to_torch(js), tt))
    assert set(tm) == set(jm)
    for k in set(tm) - set(MET_KEYS) - {"tau"}:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                      err_msg=k)
    # the gate's τ to 1e-5, as the dense session's parity (an ulp of exp)
    np.testing.assert_allclose(tm["tau"].numpy(), np.asarray(jm["tau"]),
                               rtol=0, atol=1e-5)
    for k in MET_KEYS:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    if jt.tier_ok is not None:
        down = jt.tier_ok[:, 0] == 0
        assert down.any() and (tm["route"].numpy()[down] == 1).all()


def test_session_hedge_refusals():
    sess = ServeSession(make_policy("rdap", TSYS, device="cpu"), 4,
                        device="cpu", hedge=(0.9, 0.05))
    stream = _to_torch(JSimulator(JSYS, JSimConfig(n_tasks=4)).sample_stream(2))
    with pytest.raises(ValueError, match="lat_mult"):
        sess.run(stream)
    with pytest.raises(ValueError, match="quantile"):
        ServeSession(make_policy("rdap", TSYS, device="cpu"), 4,
                     device="cpu", hedge=(1.5, 0.05))


# ---------------------------------------------------------------------------
# the golden point
# ---------------------------------------------------------------------------
GOLD = json.loads((ROOT / "SCENARIO_GOLDENS.json").read_text())


@pytest.mark.parametrize("name", NAMES)
def test_run_suite_meets_goldens(name):
    """The port's ``run_suite`` at the golden point (streams 64, rounds 30,
    seed 11, scenario seed 0; 5 policies) against every key each golden
    row holds, at rtol = atol = 2e-3.  No JAX runs here: the goldens guard
    the port alone."""
    cfg = GOLD["config"]
    rows = tsc.run_suite(scenarios=(name,), streams=cfg["streams"],
                         rounds=cfg["rounds"], seed=cfg["seed"],
                         scenario_seed=cfg["scenario_seed"], device="cpu")
    assert len(rows) == 5
    for key, scalars in rows.items():
        gold = GOLD["rows"][key]
        for metric, val in gold.items():
            np.testing.assert_allclose(scalars[metric], val, rtol=2e-3,
                                       atol=2e-3, err_msg=f"{key}:{metric}")
        if name.endswith("churn"):
            assert {"mean_alive", "max_queue_depth", "dropped"} <= set(scalars)
