"""Online gate fine-tuning (``ServeSession(finetune=FinetuneConfig(...))``)
of the port (plain versions, on the CPU) against the live JAX session fed
the same gate parameters and the same stream.

Decisions (route/r/p/v) are compared exactly; τ to 1e-5; metrics to 1e-5
relative (the bar of ``test_torch_session.py``); the tuned parameters to
1e-6 absolute of the reference's (the two take the same SGD steps with
gradients summed in another order; measured |Δ| <= 3e-8 while the
parameters moved by up to 1.6e-2 at M = 12).  Rounds before the first
update equal the plain run bit for bit.  On the CPU each run goes through
the session's finetune ``RoundGraph`` uncaptured: it must equal a plain
loop over the round function (``_finetune_round``) bit for bit.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import gating as jgating
from repro.core.features import feature_dim
from repro.models.params import init_params
from repro.serving import scenarios as jsc
from repro.serving.policy import Observation as JObs
from repro.serving.policy import make_policy as j_make_policy
from repro.serving.session import FinetuneConfig as JFinetuneConfig
from repro.serving.session import ServeSession as JSession
from repro.serving.simulator import SimConfig as JSimConfig
from repro.serving.simulator import Simulator as JSimulator
from repro_torch.convert import gate_params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core import gating
from repro_torch.launch.mesh import host_mesh, single_rank_group
from repro_torch.serving import FinetuneConfig
from repro_torch.serving import scenarios as tsc
from repro_torch.serving.graphs import tree_leaves
from repro_torch.serving.policy import Observation, make_policy
from repro_torch.serving.session import (
    ServeSession,
    _finetune_round,
    _flat_params,
)
from repro_torch.serving.simulator import SimConfig

JSYS, TSYS = jcm.SystemConfig(), tcm.SystemConfig()
JGCFG = jgating.GateConfig(d_feature=feature_dim())
TGCFG = gating.GateConfig(d_feature=feature_dim())
JGPARAMS = init_params(jgating.gate_specs(JGCFG), jax.random.PRNGKey(0))
NP_PARAMS = {k: np.asarray(v) for k, v in JGPARAMS.items()}
EXACT = ("route", "r", "p", "v")
REL = ("delay", "energy", "cost", "accuracy")
PARAM_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _policies():
    return (j_make_policy("r2evid", JSYS, gate_params=JGPARAMS,
                          gate_cfg=JGCFG),
            make_policy("r2evid", TSYS, device="cpu", gate_cfg=TGCFG,
                        gate_params=gate_params_from_numpy(NP_PARAMS, "cpu")))


def _golden_stream(m=12, r=6, seed=2026):
    """The generator of the reference's ``tests/test_session.py``."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        dx=rng.normal(size=(r, m, feature_dim())).astype(np.float32),
        z=rng.uniform(0, 1, (r, m)).astype(np.float32),
        aq=rng.uniform(0.55, 0.82, (r, m)).astype(np.float32),
        bw_mult=rng.uniform(0.8, 1.0, (r, 2)).astype(np.float32),
        u=rng.uniform(0, 0.3, (r, 5)).astype(np.float32))
    return (JObs(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            Observation(**{k: _t(v) for k, v in arrays.items()}))


def _sim_stream(m, r, seed=0):
    js = JSimulator(JSYS, JSimConfig(n_tasks=m, seed=seed)).sample_stream(
        r, feature_seed=1)
    ts = Observation(**{f.name: None if getattr(js, f.name) is None
                        else _t(getattr(js, f.name))
                        for f in dataclasses.fields(Observation)})
    return js, ts


def _assert_run(got, want, what=""):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, (what, k)
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        elif k == "tau":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"{what} {k}")
        else:
            assert k in REL, k
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what} {k}")


def _assert_params(tsess, jsess, moved=True):
    """The tuned parameters within ``PARAM_ATOL`` of the reference's, and
    (with ``moved``) away from the offline ones."""
    drift = 0.0
    for k, v in tsess.gate_params.items():
        want = np.asarray(jsess.gate_params[k])
        np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
        drift = max(drift, float(np.abs(want - NP_PARAMS[k]).max()))
    assert (drift > 100 * PARAM_ATOL) == moved, drift


def _bits(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", ["golden_m12_r6", "sim_m64_r8",
                                  "chip_m4096_r16"])
def test_finetune_session_matches_reference(case):
    """The finetune run against the live JAX session: the reference's
    ``test_finetune_updates_gate_params_on_cadence`` inputs at
    ``FinetuneConfig(lr=1e-2, resync_period=2)``, the simulator's stream
    at M = 64, R = 8 and at the chip's cell (M = 4096, R = 16, seed 0,
    feature seed 1) at the defaults.  A second run continues the counter
    (the reference's 12 after two runs of 6) and the tuning."""
    if case == "golden_m12_r6":
        js_obs, ts_obs = _golden_stream()
        kw = dict(lr=1e-2, resync_period=2)
    else:
        m, r = (64, 8) if case == "sim_m64_r8" else (4096, 16)
        js_obs, ts_obs = _sim_stream(m, r)
        kw = {}
    m, r = ts_obs.z.shape[1], ts_obs.n_rounds
    jp, tp = _policies()
    jsess = JSession(jp, m, finetune=JFinetuneConfig(**kw))
    tsess = ServeSession(tp, m, device="cpu", finetune=FinetuneConfig(**kw))
    _assert_run(tsess.run(ts_obs), jsess.run(js_obs), case)
    _assert_params(tsess, jsess)
    if case != "chip_m4096_r16":
        _assert_run(tsess.run(ts_obs), jsess.run(js_obs), f"{case} again")
        _assert_params(tsess, jsess)
    assert int(tsess._rounds_done) == int(jsess._rounds_done)
    assert int(tsess._rounds_done) == r * (1 if case == "chip_m4096_r16"
                                           else 2)


@pytest.mark.parametrize("case", ["golden", "sim"])
def test_rounds_before_the_first_update_equal_the_plain_run(case):
    """Rounds up to the first update serve the offline parameters: their
    outputs equal a session without finetune bit for bit; the caller's
    parameters are never written."""
    js_obs, ts_obs = (_golden_stream() if case == "golden"
                      else _sim_stream(64, 8))
    period = 2 if case == "golden" else 4
    _, tp = _policies()
    before = {k: v.clone() for k, v in tp.gate_params.items()}
    plain = ServeSession(tp, ts_obs.z.shape[1], device="cpu").run(ts_obs)
    sess = ServeSession(tp, ts_obs.z.shape[1], device="cpu",
                        finetune=FinetuneConfig(lr=1e-2,
                                                resync_period=period))
    tuned = sess.run(ts_obs)
    for k in plain:
        assert torch.equal(tuned[k][:period], plain[k][:period]), k
    assert any(not torch.equal(tuned[k][period:], plain[k][period:])
               for k in ("tau", "cost"))
    for k, v in tp.gate_params.items():
        assert torch.equal(v, before[k]), k
        assert sess.gate_params[k] is not v
        assert not torch.equal(sess.gate_params[k], v), k


@pytest.mark.parametrize("scenario", ["straggler_tail", "edge_outage"])
def test_finetune_under_scenario_matches_reference(scenario):
    """A hedged stream (``straggler_tail``: the hedge's deadline in the
    realization, so in the SLA misses) and an outage (``edge_outage``: the
    tier mask in the solve and the realization) through the finetune run,
    against the live JAX session at M = 48, R = 12."""
    m, r = 48, 12
    simc = dict(n_tasks=m, n_rounds=r, seed=11, bw_fluctuation=0.2)
    js_obs = JSimulator(JSYS, JSimConfig(**simc)).sample_stream(
        r, feature_seed=1)
    ts_obs = Observation(**{f.name: None if getattr(js_obs, f.name) is None
                            else _t(getattr(js_obs, f.name))
                            for f in dataclasses.fields(Observation)})
    jt = jsc.compile_scenario(scenario, JSYS, JSimConfig(**simc), r, seed=0)
    tt = tsc.compile_scenario(scenario, TSYS, SimConfig(**simc), r, seed=0)
    jp, tp = _policies()
    kw = dict(lr=1e-2, resync_period=3)
    jsess = JSession(jp, m, sim=JSimConfig(**simc), hedge=jt.hedge,
                     finetune=JFinetuneConfig(**kw))
    tsess = ServeSession(tp, m, sim=SimConfig(**simc), device="cpu",
                         hedge=tt.hedge, finetune=FinetuneConfig(**kw))
    assert (tt.hedge is not None) == (scenario == "straggler_tail")
    _assert_run(tsess.run(tsc.apply_scenario(ts_obs, tt)),
                jsess.run(jsc.apply_scenario(js_obs, jt)), scenario)
    _assert_params(tsess, jsess)


def test_finetune_session_rules():
    """The reference's rules: gate mode required; ``reset`` zeroes the
    counter and keeps the tuned parameters; ``step``, ``route`` and
    ``route_many`` neither tune nor count; churn raises; so does a run on a
    mesh."""
    js_obs, ts_obs = _golden_stream()
    with pytest.raises(ValueError, match="gate"):
        ServeSession(make_policy("jcab", TSYS, device="cpu"), 12,
                     device="cpu", finetune=FinetuneConfig())
    with pytest.raises(ValueError, match="gate"):
        ServeSession(make_policy("r2evid", TSYS, device="cpu"), 12,
                     device="cpu", finetune=FinetuneConfig())
    jp, tp = _policies()
    ft = dict(lr=1e-2, resync_period=2)
    jsess = JSession(jp, 12, finetune=JFinetuneConfig(**ft))
    tsess = ServeSession(tp, 12, device="cpu", finetune=FinetuneConfig(**ft))
    _assert_run(tsess.run(ts_obs), jsess.run(js_obs))
    tuned = {k: v.clone() for k, v in tsess.gate_params.items()}
    assert int(tsess._rounds_done) == 6
    # step / route / route_many: no tuning, no count
    tsess.step(ts_obs.round(0))
    tsess.route(dataclasses.replace(ts_obs.round(1), u=None, bw_mult=None))
    tsess.route_many(ts_obs.dx, ts_obs.z, ts_obs.aq)
    assert int(tsess._rounds_done) == 6
    for k, v in tsess.gate_params.items():
        assert torch.equal(v, tuned[k]), k
    # reset: the counter back to 0, the tuned parameters kept; the next run
    # equals the reference's after its own reset
    tsess.reset()
    jsess.reset()
    assert int(tsess._rounds_done) == 0
    for k, v in tsess.gate_params.items():
        assert torch.equal(v, tuned[k]), k
    _assert_run(tsess.run(ts_obs), jsess.run(js_obs), "after reset")
    _assert_params(tsess, jsess)
    # churn traces under finetune raise, as in the reference
    churned = dataclasses.replace(
        ts_obs, arrive_n=torch.zeros((6,), dtype=torch.int32),
        depart=torch.zeros((6, 12), dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="churn"):
        ServeSession(tp, 12, device="cpu", finetune=FinetuneConfig(),
                     admission=tsc.AdmissionConfig()).run(churned)
    # a mesh is ported (A.15): finetuning on one raises, as in the
    # reference, and a mesh that is not a DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServeSession(tp, 12, device="cpu", finetune=FinetuneConfig(),
                     mesh=object())
    with single_rank_group("gloo"):
        sharded = ServeSession(tp, 12, device="cpu", mesh=host_mesh(),
                               finetune=FinetuneConfig())
        with pytest.raises(NotImplementedError, match="single-mesh"):
            sharded.run(ts_obs)


def _loop(step, carry, stream):
    outs = []
    for i in range(stream.n_rounds):
        carry, out = step(carry, stream.round(i))
        outs.append(out)
    return carry, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def test_finetune_round_graph_equals_a_plain_loop():
    """The session's finetune graph (uncaptured on the CPU) against a plain
    loop over ``_finetune_round`` from the same carry and parameters: every
    output, the carry, the counter and the tuned parameters bit for bit;
    and a second run on the same graph continues both alike."""
    _, ts_obs = _sim_stream(64, 8)
    _, tp = _policies()
    ft = FinetuneConfig(lr=1e-2, resync_period=3)
    sess = ServeSession(tp, 64, device="cpu", finetune=ft)
    flat, params = _flat_params(tp.gate_params)
    own = dataclasses.replace(tp, gate_params=params)
    anchor = flat.clone()
    step = lambda c, o: _finetune_round(own, sess.n_edge, sess.n_cloud,
                                        None, ft, flat, anchor, c, o)
    carry = (own.init(64), torch.zeros((), dtype=torch.int64))
    for n in (8, 5):
        got = sess.run(ts_obs, n_rounds=n)
        carry, want = _loop(step, carry, ts_obs if n == 8 else
                            Observation(**{f.name: None if getattr(
                                ts_obs, f.name) is None else getattr(
                                ts_obs, f.name)[:n]
                                for f in dataclasses.fields(ts_obs)}))
        _bits(got, want)
        for a, b in zip(tree_leaves((sess.state, sess._rounds_done)),
                        tree_leaves(carry)):
            assert torch.equal(a, b)
        for k, v in sess.gate_params.items():
            assert torch.equal(v, own.gate_params[k]), k
    assert int(sess._rounds_done) == 13
    assert [g for g in sess.graphs] == [("finetune", g[1])
                                        for g in sess.graphs]
