"""The decide-only surface of the port and its round graphs' round
function (plain versions, on the CPU) against the live JAX package:
``gate_window_scan``, ``route_step`` / ``route_scan`` / the windowed
``route``, ``ServeSession.gate_params`` / ``route`` / ``route_many`` /
``step`` without ``u`` / ``run(n_rounds=)``, the host ``Simulator``
realizations, and the reference's refusals.

Decisions (route/r/p/v, the solver's iters and infeasible, the churn
bookkeeping) are compared exactly; τ, the gate's state and the C6 draw
history to 1e-5; metrics and the solver's objectives to 1e-5 relative, the
bar of ``test_torch_session.py``.  On the CPU a session runs every round
through its ``RoundGraph`` uncaptured (``serving/graphs.py``): the same
round function over the same static buffers that the card captures.  Its
runs must equal a plain loop over the round function bit for bit and the
live JAX session, at a small size and at the card's own cells (the main
path at M = 4096, R = 16; ``churn`` at M = 4096, R = 30).
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import functools
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import gating as jgating
from repro.core import router as jrouter
from repro.core.features import feature_dim
from repro.core.robust import RobustProblem as JProb
from repro.models.params import init_params
from repro.serving import scenarios as jsc
from repro.serving.policy import Observation as JObs
from repro.serving.policy import make_policy as j_make_policy
from repro.serving.session import ServeSession as JSession
from repro.serving.simulator import SimConfig as JSimConfig
from repro.serving.simulator import Simulator as JSimulator
from repro_torch.convert import gate_params_from_numpy, router_state_to_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core import gating, router
from repro_torch.core.robust import RobustProblem
from repro_torch.serving import scenarios as tsc
from repro_torch.serving.graphs import tree_leaves
from repro_torch.serving.policy import Observation, make_policy
from repro_torch.serving.session import (
    ServeSession,
    _churn_consts,
    _churn_round,
    _serve_step,
)
from repro_torch.serving.simulator import SimConfig, Simulator

JSYS, TSYS = jcm.SystemConfig(), tcm.SystemConfig()
JGCFG = jgating.GateConfig(d_feature=feature_dim())
TGCFG = gating.GateConfig(d_feature=feature_dim())
JGPARAMS = init_params(jgating.gate_specs(JGCFG), jax.random.PRNGKey(0))
TGPARAMS = gate_params_from_numpy(
    {k: np.asarray(v) for k, v in JGPARAMS.items()}, "cpu")
JPROB, TPROB = JProb.build(JSYS), RobustProblem.build(TSYS, "cpu")
M, S, T = 64, 8, 8
EXACT = ("route", "r", "p", "v", "iters", "infeasible", "warm_route",
         "warm_r", "alive", "queue_depth", "admitted", "dropped")
CLOSE = ("tau", "bw_history")
REL = ("o_up", "o_down", "delay", "energy", "cost", "accuracy")


def _inputs(seed, m=M, s=S):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(s, m, feature_dim())).astype(np.float32),
            rng.uniform(0, 1, (s, m)).astype(np.float32),
            rng.uniform(0.55, 0.82, (s, m)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_sol(got, want, what=""):
    """Every key of the reference's solution, at this file's bars."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        elif k in CLOSE:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{what} {k}")
        else:
            assert k in REL, (what, k)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what} {k}")


def _assert_bits(a, b):
    """Two runs of the port, equal bit for bit."""
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _assert_states(tstate, jstate):
    got = router_state_to_numpy(tstate)
    np.testing.assert_array_equal(got["prev_route"],
                                  np.asarray(jstate.prev_route))
    np.testing.assert_allclose(got["prev_tau"], np.asarray(jstate.prev_tau),
                               atol=1e-5)
    for k in ("h", "var_buf", "var_sum", "var_sumsq"):
        np.testing.assert_allclose(got[f"gate.{k}"],
                                   np.asarray(getattr(jstate.gate, k)),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["gate.var_idx"],
                                  np.asarray(jstate.gate.var_idx))


# ---------------------------------------------------------------------------
# gate_window_scan and the router functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("resync", [0, 1, 3])
def test_gate_window_scan_matches_reference(resync):
    """(M, T, d) windows from a fresh state: τ and mean g (M, T) and the
    final state to 1e-5; a given state is copied, never written."""
    jcfg = dataclasses.replace(JGCFG, resync_period=resync)
    tcfg = dataclasses.replace(TGCFG, resync_period=resync)
    dx = np.random.default_rng(resync).normal(
        size=(M, T, feature_dim())).astype(np.float32)
    jt, jg, jfin = jgating.gate_window_scan(jcfg, JGPARAMS, jnp.asarray(dx))
    tt, tg, tfin = gating.gate_window_scan(tcfg, TGPARAMS, _t(dx))
    assert tuple(tt.shape) == tuple(tg.shape) == (M, T)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)
    for k in ("h", "var_buf", "var_sum", "var_sumsq"):
        np.testing.assert_allclose(getattr(tfin, k).numpy(),
                                   np.asarray(getattr(jfin, k)), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(tfin.var_idx.numpy(), [T] * M)
    # from a given state: the second window continues the first
    jt2, _, _ = jgating.gate_window_scan(jcfg, JGPARAMS, jnp.asarray(dx),
                                         state=jfin)
    before = tfin.var_buf.clone()
    tt2, _, tfin2 = gating.gate_window_scan(tcfg, TGPARAMS, _t(dx),
                                            state=tfin)
    assert torch.equal(tfin.var_buf, before)
    assert tfin2.var_buf is not tfin.var_buf
    np.testing.assert_allclose(tt2.numpy(), np.asarray(jt2), atol=1e-5)


def test_route_step_matches_reference():
    """S route_step calls threading the state: every solution key and the
    final carry."""
    dx, z, aq = _inputs(1)
    jst = jrouter.init_router_state(JGCFG, M)
    tst = router.init_router_state(TGCFG, M, "cpu")
    for i in range(S):
        jst, jsol = jrouter.route_step(JPROB, JGCFG, JGPARAMS, jst,
                                       jnp.asarray(dx[i]), jnp.asarray(z[i]),
                                       jnp.asarray(aq[i]))
        tst, tsol = router.route_step(TPROB, TGCFG, TGPARAMS, tst,
                                      _t(dx[i]), _t(z[i]), _t(aq[i]))
        _assert_sol(tsol, jsol, f"step {i}")
    _assert_states(tst, jst)


def test_route_step_with_a_tier_out_matches_reference():
    dx, z, aq = _inputs(2)
    tier_ok = np.array([0.0, 1.0], np.float32)
    jst, jsol = jrouter.route_step(
        JPROB, JGCFG, JGPARAMS, jrouter.init_router_state(JGCFG, M),
        jnp.asarray(dx[0]), jnp.asarray(z[0]), jnp.asarray(aq[0]),
        tier_ok=jnp.asarray(tier_ok))
    tst, tsol = router.route_step(
        TPROB, TGCFG, TGPARAMS, router.init_router_state(TGCFG, M, "cpu"),
        _t(dx[0]), _t(z[0]), _t(aq[0]), tier_ok=_t(tier_ok))
    _assert_sol(tsol, jsol)
    assert (tsol["route"] == 1).all()


@pytest.mark.parametrize("calls", [1, 2])
@pytest.mark.parametrize("stacked", [False, True])
def test_route_scan_matches_reference(stacked, calls):
    """S segments with (M,) or (S, M) difficulty / requirements, in one
    call or in two threading the state, against one reference scan: the
    stacked solutions and the final carry."""
    dx, z, aq = _inputs(3)
    zz, aa = (z, aq) if stacked else (z[0], aq[0])
    jst, jsols = jrouter.route_scan(
        JPROB, JGCFG, JGPARAMS, jrouter.init_router_state(JGCFG, M),
        jnp.asarray(dx), jnp.asarray(zz), jnp.asarray(aa))
    tst, parts = router.init_router_state(TGCFG, M, "cpu"), []
    for seg in np.array_split(np.arange(S), calls):
        part = slice(seg[0], seg[-1] + 1)
        tst, sols = router.route_scan(
            TPROB, TGCFG, TGPARAMS, tst, _t(dx[part]),
            _t(zz[part] if stacked else zz), _t(aa[part] if stacked else aa))
        parts.append(sols)
    _assert_sol({k: torch.cat([p[k] for p in parts]) for k in parts[0]},
                jsols)
    _assert_states(tst, jst)


def test_route_scan_threaded_state_equals_eager_loop():
    """Two ``route_scan`` calls threading the state against a loop of
    ``route_step``, bit for bit; the caller's route, τ and hidden state
    are not written (only the gate's ring buffer is, as ``route_step``
    documents)."""
    dx, z, aq = _inputs(14)
    outs = []
    for scan in (True, False):
        st = router.init_router_state(TGCFG, M, "cpu")
        given = [t.clone() for t in (st.prev_route, st.prev_tau, st.gate.h)]
        sols = []
        for half in (slice(0, S // 2), slice(S // 2, S)):
            if scan:
                new, sol = router.route_scan(TPROB, TGCFG, TGPARAMS, st,
                                             _t(dx[half]), _t(z[half]),
                                             _t(aq[half]))
            else:
                new, steps = st, []
                for i in range(half.start, half.stop):
                    new, one = router.route_step(TPROB, TGCFG, TGPARAMS, new,
                                                 _t(dx[i]), _t(z[i]),
                                                 _t(aq[i]))
                    steps.append(one)
                sol = {k: torch.stack([x[k] for x in steps])
                       for k in steps[0]}
            for a, b in zip(given, (st.prev_route, st.prev_tau, st.gate.h)):
                assert torch.equal(a, b)
            st = new
            given = [t.clone() for t in (st.prev_route, st.prev_tau,
                                         st.gate.h)]
            sols.append(sol)
        outs.append((sols, tree_leaves(st)))
    for x, y in zip(outs[0][0], outs[1][0]):
        _assert_bits(x, y)
    for x, y in zip(outs[0][1], outs[1][1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("history", [False, True])
def test_windowed_route_matches_reference(history):
    """The windowed, stateless route over (M, T, d): defaults (no history)
    and a given previous route and τ."""
    rng = np.random.default_rng(4)
    dx = rng.normal(size=(M, T, feature_dim())).astype(np.float32)
    _, z, aq = _inputs(4)
    kw_j, kw_t = {}, {}
    if history:
        prev = rng.integers(-1, 2, M).astype(np.int32)
        ptau = rng.uniform(0, 1, M).astype(np.float32)
        kw_j = dict(prev_route=jnp.asarray(prev), prev_tau=jnp.asarray(ptau))
        kw_t = dict(prev_route=_t(prev.astype(np.int64)), prev_tau=_t(ptau))
    want = jrouter.route(JPROB, JGCFG, JGPARAMS, jnp.asarray(dx),
                         jnp.asarray(z[0]), jnp.asarray(aq[0]), **kw_j)
    got = router.route(TPROB, TGCFG, TGPARAMS, _t(dx), _t(z[0]), _t(aq[0]),
                       **kw_t)
    _assert_sol(got, want)


# ---------------------------------------------------------------------------
# the session's decide-only surface
# ---------------------------------------------------------------------------
def _policies(kind):
    if kind == "gate":
        return (j_make_policy("r2evid", JSYS, gate_params=JGPARAMS,
                              gate_cfg=JGCFG),
                make_policy("r2evid", TSYS, device="cpu", gate_cfg=TGCFG,
                            gate_params=TGPARAMS))
    if kind == "tau_proxy":
        return (j_make_policy("r2evid", JSYS),
                make_policy("r2evid", TSYS, device="cpu"))
    return j_make_policy(kind, JSYS), make_policy(kind, TSYS, device="cpu")


KINDS = ["gate", "tau_proxy", "rdap"]


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("kind, stacked", [("gate", False), ("gate", True),
                                           ("tau_proxy", True),
                                           ("rdap", True)])
def test_session_route_many_matches_reference(kind, stacked, warm):
    """``route_many`` twice on one session (the carry continues), then
    ``route`` of one more segment, then ``step`` without ``u``: every
    solution, against the reference session.  (M,) difficulty needs the
    features to set S, so only gate mode takes it.  ``warm``: the session
    first routes all S segments and is ``reset``, so the halves run on
    that longer graph, its carry refilled in place."""
    dx, z, aq = _inputs(5)
    jp, tp = _policies(kind)
    js = JSession(jp, M)
    ts = ServeSession(tp, M, device="cpu")
    if warm:
        ts.route_many(None if kind != "gate" else _t(dx), _t(z), _t(aq))
        ts.reset()
    if kind == "gate":
        np.testing.assert_array_equal(ts.gate_params["w_g"].numpy(),
                                      np.asarray(js.gate_params["w_g"]))
    else:
        assert ts.gate_params is None and js.gate_params is None
    jdx = None if kind != "gate" else jnp.asarray(dx)
    tdx = None if kind != "gate" else _t(dx)
    for half in (slice(0, S // 2), slice(S // 2, S)):
        zz, aa = (z[half], aq[half]) if stacked else (z[half][0], aq[half][0])
        want = js.route_many(None if jdx is None else jdx[half],
                             jnp.asarray(zz), jnp.asarray(aa))
        got = ts.route_many(None if tdx is None else tdx[half], _t(zz),
                            _t(aa))
        _assert_sol(got, want, f"{kind} {half}")
    obs = lambda i, mk, f: mk(z=f(z[i]), aq=f(aq[i]),
                              dx=None if kind != "gate" else f(dx[i]))
    _assert_sol(ts.route(obs(0, Observation, _t)),
                js.route(obs(0, JObs, jnp.asarray)), "route")
    _assert_sol(ts.step(obs(1, Observation, _t)),
                js.step(obs(1, JObs, jnp.asarray)), "step without u")


def _stream(m, r, seed, features):
    js = JSimulator(JSYS, JSimConfig(n_tasks=m, seed=seed)).sample_stream(
        r, feature_seed=1 if features else None)
    ts = Observation(**{f.name: None if getattr(js, f.name) is None
                        else _t(getattr(js, f.name))
                        for f in dataclasses.fields(Observation)})
    return js, ts


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_session_run_n_rounds_matches_reference(kind, warm):
    """``run(stream, n_rounds=)`` serves a prefix, twice in a row (the
    carry continues), as the reference does; ``warm``: after a whole run
    and ``reset``, on the longer graph."""
    js_obs, ts_obs = _stream(M, S, 6, kind == "gate")
    jp, tp = _policies(kind)
    js = JSession(jp, M)
    ts = ServeSession(tp, M, device="cpu")
    if warm:
        ts.run(ts_obs)
        ts.reset()
    for n in (3, 5):
        want, got = js.run(js_obs, n_rounds=n), ts.run(ts_obs, n_rounds=n)
        assert tuple(got["route"].shape) == (n, M)
        _assert_sol(got, want, f"n_rounds={n}")


def _loop(step, carry, stream):
    """The eager loop: ``step`` called a round from Python over the
    round-stacked ``stream``; the carry and the outputs stacked to (R,
    ...)."""
    outs = []
    for i in range(stream.n_rounds):
        carry, out = step(carry, stream.round(i))
        outs.append(out)
    return carry, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


@pytest.mark.parametrize("kind", ["gate", "sniper"])
def test_round_graph_function_equals_eager_loop(kind):
    """A session's round graphs (uncaptured on the CPU) and a plain loop
    over the round functions give the same bits: ``run`` twice, ``step``,
    ``route_many`` and ``route``, and the same carry after."""
    _, stream = _stream(M, S, 7, kind == "gate")
    _, tp = _policies(kind)
    sess = ServeSession(tp, M, device="cpu")
    got = [sess.run(stream), sess.run(stream, n_rounds=3),
           sess.step(stream.round(4)),
           sess.route_many(stream.dx, stream.z, stream.aq),
           sess.route(stream.round(2))]
    serve = functools.partial(_serve_step, tp, n_edge=sess.n_edge,
                              n_cloud=sess.n_cloud)
    prefix = Observation(**{f.name: None if getattr(stream, f.name) is None
                            else getattr(stream, f.name)[:3]
                            for f in dataclasses.fields(stream)})
    want = []
    st, out = _loop(serve, tp.init(M), stream)
    want.append(out)
    st, out = _loop(serve, st, prefix)
    want.append(out)
    st, out = serve(st, stream.round(4))
    want.append(out)
    st, out = _loop(tp.decide, st,
                    Observation(z=stream.z, aq=stream.aq, dx=stream.dx))
    want.append(out)
    st, out = tp.decide(st, stream.round(2))
    want.append(out)
    for x, y in zip(got, want):
        _assert_bits(x, y)
    for x, y in zip(tree_leaves(sess.state), tree_leaves(st)):
        assert torch.equal(x, y)
    assert set(k for k, _ in sess.graphs) == {"serve", "decide"}


@pytest.mark.parametrize("scenario", ["flash_churn", "straggler_tail"])
def test_round_graph_scenario_equals_eager_loop(scenario):
    """A churned and a hedged run through the session's round graph
    (uncaptured on the CPU) and through a plain loop over the round
    function: the same bits, over two runs (the slot pool continues) and
    after ``reset``."""
    simc = SimConfig(n_tasks=M, seed=3, bw_fluctuation=0.2)
    trace = tsc.compile_scenario(scenario, TSYS, simc, S, seed=0)
    _, stream = _stream(M, S, 3, True)
    obs = tsc.apply_scenario(stream, trace)
    _, tp = _policies("gate")
    sess = ServeSession(tp, M, sim=simc, device="cpu", hedge=trace.hedge,
                        admission=trace.admission)
    if trace.admission is None:
        carry = tp.init(M)
        step = functools.partial(_serve_step, tp, n_edge=sess.n_edge,
                                 n_cloud=sess.n_cloud, hedge=sess.hedge)
    else:
        carry = (tp.init(M), *sess._churn_init())
        bw_floor, total_bw, valid = _churn_consts(tp, carry[1])
        step = functools.partial(_churn_round, tp, bw_floor, total_bw,
                                 trace.admission, sess.n_edge, sess.n_cloud,
                                 valid)
    first = sess.run(obs)
    got = [first, sess.run(obs)]
    want = []
    for _ in range(2):
        carry, out = _loop(step, carry, obs)
        want.append(out)
    for x, y in zip(got, want):
        _assert_bits(x, y)
    sess.reset()
    _assert_bits(sess.run(obs), first)


def test_round_graph_reset_refills_in_place():
    """``reset`` refills the carry's tensors in place (a graph holds them
    by address): a run after it equals a fresh session's."""
    _, stream = _stream(M, 4, 8, True)
    _, tp = _policies("gate")
    sess = ServeSession(tp, M, device="cpu")
    first = sess.run(stream)
    leaves = tree_leaves(sess.state)
    sess.reset()
    assert all(a is b for a, b in zip(leaves, tree_leaves(sess.state)))
    graphs = dict(sess.graphs)
    _assert_bits(sess.run(stream), first)
    assert sess.graphs == graphs
    sess.reset(n_streams=M // 2)
    assert not sess.graphs


def test_round_graphs_die_with_their_session_without_the_collector():
    """A session and its graphs hold no reference cycle: dropping the
    session frees each graph at once (on the card a graph freed by the
    cycle collector in the middle of another capture invalidates it)."""
    simc = SimConfig(n_tasks=M, seed=3)
    trace = tsc.compile_scenario("churn", TSYS, simc, 4, seed=0)
    _, stream = _stream(M, 4, 16, True)
    _, tp = _policies("gate")
    collecting = gc.isenabled()
    gc.disable()
    try:
        sess = ServeSession(tp, M, sim=simc, device="cpu",
                            admission=trace.admission)
        sess.run(stream)
        sess.run(tsc.apply_scenario(stream, trace))
        sess.route_many(stream.dx, stream.z, stream.aq)
        graphs = [weakref.ref(g) for g in sess.graphs.values()]
        assert len(graphs) == 3
        del sess
        assert all(g() is None for g in graphs)
    finally:
        if collecting:
            gc.enable()


@pytest.mark.parametrize("given_state", [False, True])
def test_reset_and_replay_leave_the_callers_stream_alone(given_state):
    """The caller's stream, and a state given to the session, are never
    written: a round graph adopts copies of the carry (τ-proxy's round
    makes its prev_tau the round's z), and ``reset`` refills only the
    graph's own tensors."""
    _, stream = _stream(M, 4, 15, False)
    z = stream.z.clone()
    _, tp = _policies("tau_proxy")
    state = None
    if given_state:
        state = tp.init(M)
        state.prev_tau.uniform_(generator=torch.Generator().manual_seed(1))
        kept = [t.clone() for t in tree_leaves(state)]
    sess = ServeSession(tp, M, device="cpu", state=state)
    sess.run(stream)
    assert sess.state.prev_tau.data_ptr() != stream.z[-1].data_ptr()
    sess.reset()
    sess.run(stream, n_rounds=1)
    assert torch.equal(stream.z, z)
    if given_state:
        for a, b in zip(kept, tree_leaves(state)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the host Simulator API
# ---------------------------------------------------------------------------
def _decisions(rng, m):
    return {"route": rng.integers(0, 2, m), "r": rng.integers(0, 5, m),
            "p": rng.integers(0, 5, m), "v": rng.integers(0, 5, m)}


def _assert_realized(got, want):
    assert set(got) == set(want)
    for k in ("route", "success"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    for k in ("delay", "energy", "cost", "accuracy"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("fluct", [0.0, 0.2])
def test_simulator_realize_matches_reference(fluct):
    """``realize`` round after round and ``realize_batch`` of them: the
    same seed draws the same rounds and the same observation noise."""
    simc = dict(n_tasks=M, seed=9, bw_fluctuation=fluct)
    jsim = JSimulator(JSYS, JSimConfig(**simc))
    tsim = Simulator(TSYS, SimConfig(**simc), device="cpu")
    rng = np.random.default_rng(10)
    rnds, cfgs = [], []
    for _ in range(3):
        rnd_j, rnd_t = jsim.sample_round(), tsim.sample_round()
        cfg = _decisions(rng, M)
        _assert_realized(tsim.realize(rnd_t, cfg), jsim.realize(rnd_j, cfg))
        rnds.append(rnd_t)
        cfgs.append(cfg)
    det_t = tsim._realize_deterministic(rnds[0], cfgs[0])
    det_j = jsim._realize_deterministic(rnds[0], cfgs[0])
    for k in det_j:
        np.testing.assert_allclose(det_t[k], np.asarray(det_j[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _assert_realized(tsim.realize_batch(rnds, cfgs),
                     jsim.realize_batch(rnds, cfgs))


@pytest.mark.parametrize("name", ["jcab", "r2evid"])
def test_simulator_run_batch_matches_reference(name):
    simc = dict(n_tasks=M, n_rounds=4, seed=12)
    want = JSimulator(JSYS, JSimConfig(**simc)).run_batch(
        j_make_policy(name, JSYS))
    got = Simulator(TSYS, SimConfig(**simc), device="cpu").run_batch(
        make_policy(name, TSYS, device="cpu"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the reference's refusals and ranks
# ---------------------------------------------------------------------------
def test_decide_only_refusals_match_reference():
    """``route_many`` without dx on (M,) inputs cannot infer S; ``run``
    without ``u`` / ``bw_mult`` names ``route_many``; ranks and stream
    counts as the reference checks them."""
    _, z, aq = _inputs(13)
    jp, tp = _policies("tau_proxy")
    js, ts = JSession(jp, M), ServeSession(tp, M, device="cpu")
    for sess, f in ((js, jnp.asarray), (ts, _t)):
        with pytest.raises(ValueError, match="cannot infer the segment"):
            sess.route_many(None, f(z[0]), f(aq[0]))
        with pytest.raises(ValueError, match="route_many"):
            sess.run(JObs(z=f(z), aq=f(aq)) if sess is js
                     else Observation(z=f(z), aq=f(aq)))
    mk = lambda zz: Observation(z=_t(zz), aq=_t(zz))
    with pytest.raises(ValueError, match="rank 3"):
        ts.step(mk(np.zeros((1, 2, M), np.float32)))
    with pytest.raises(ValueError, match="rank 1"):
        ts.run(mk(np.zeros((M,), np.float32)))
    with pytest.raises(ValueError, match="sized for"):
        ts.step(mk(np.zeros((M + 1,), np.float32)))
    with pytest.raises(ValueError, match="capture"):
        ServeSession(tp, M, device="cpu", capture="yes")
    with pytest.raises(ValueError, match="capture=True needs the card"):
        ServeSession(tp, M, device="cpu", capture=True)
    # the reference's step without u is route: the carry advances once
    obs = Observation(z=_t(z[0]), aq=_t(aq[0]))
    a = ServeSession(tp, M, device="cpu")
    b = ServeSession(tp, M, device="cpu")
    _assert_bits(a.step(obs), b.route(obs))
    assert torch.equal(a.state.prev_route, b.state.prev_route)


# ---------------------------------------------------------------------------
# the round function at the card's own cells
# ---------------------------------------------------------------------------
def test_main_path_cell_through_round_graph_matches_reference():
    """Gate-mode R2E-VID at M = 4096, R = 16 (``chip_smoke.py``'s main
    path: ``SimConfig(seed 0)``, feature seed 1) through the round graph's
    function against the live JAX session."""
    js_obs, ts_obs = _stream(4096, 16, 0, True)
    jp, tp = _policies("gate")
    want = JSession(jp, 4096).run(js_obs)
    got = ServeSession(tp, 4096, device="cpu").run(ts_obs)
    _assert_sol(got, want)


def test_churn_cell_through_round_graph_matches_reference():
    """Gate-mode R2E-VID through ``churn`` at M = 4096, R = 30 (the cell of
    ``chip_smoke.py``'s scenarios: ``SimConfig(n_tasks=4096, seed=0)``,
    feature seed 1, scenario seed 0) through the round graph's function:
    decisions and the slot pool's bookkeeping exact."""
    simc = dict(n_tasks=4096, seed=0)
    js_obs, ts_obs = _stream(4096, 30, 0, True)
    jt = jsc.compile_scenario("churn", JSYS, JSimConfig(**simc), 30, seed=0)
    tt = tsc.compile_scenario("churn", TSYS, SimConfig(**simc), 30, seed=0)
    jp, tp = _policies("gate")
    want = JSession(jp, 4096, sim=JSimConfig(**simc),
                    admission=jt.admission).run(jsc.apply_scenario(js_obs,
                                                                   jt))
    got = ServeSession(tp, 4096, sim=SimConfig(**simc), device="cpu",
                       admission=tt.admission).run(
        tsc.apply_scenario(ts_obs, tt))
    _assert_sol(got, want)
    assert int(got["alive"][-1].sum()) == 2061
