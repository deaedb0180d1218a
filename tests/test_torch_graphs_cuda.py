"""The port's serving rounds as CUDA graphs (``serving/graphs.py``) on the
card: a replayed run against the same round function run uncaptured
(``capture=False``) in a session of the same kind, bit for bit on every
output and on the carry after it.

Needs an NVIDIA GPU and nvcc; skipped where CUDA is absent.  On a machine
with the card and without JAX (whose import ``tests/conftest.py`` needs),
run ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_graphs_cuda.py``.  The replay runs the same kernels on the
same inputs in the same order as the uncaptured run, so nothing may differ:
the main path, a baseline, ``straggler_tail`` (the hedge's quantile inside
the graph) and ``flash_churn`` (admission and the alive mask), the
decide-only paths, a round above the one-block repair's cap (its repair
one cluster launch), and ``reset`` before a replay.  A host synchronisation
forced into the round makes the capture raise (no fallback); launches
after a replay are the capture's counts times the rounds; one uncaptured
round of every policy and scenario makes no synchronising call
(``torch.cuda.set_sync_debug_mode("error")``).  The finetune round (the
gate tuned in the graph, its gradient on the backward kernel) likewise:
replay against uncaptured run, counts, ``reset`` and an uncaptured round
under the sync debug mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import router
from repro_torch.core.cost_model import SystemConfig
from repro_torch.core.gating import GateConfig
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.serving import scenarios as sc
from repro_torch.serving.graphs import tree_leaves
from repro_torch.serving.policy import JCABPolicy, make_policy
from repro_torch.serving.session import FinetuneConfig, ServeSession
from repro_torch.serving.simulator import SimConfig, Simulator

pytestmark = pytest.mark.cuda

SYS = SystemConfig()
GCFG = GateConfig(d_feature=35)
M, R = 4096, 6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _policy(kind, dev):
    if kind == "gate":
        return make_policy("r2evid", SYS, device=dev, gate_cfg=GCFG,
                           generator=torch.Generator().manual_seed(0))
    if kind == "tau_proxy":
        return make_policy("r2evid", SYS, device=dev)
    return make_policy(kind, SYS, device=dev)


def _stream(dev, rounds=R, m=M, features=True):
    return Simulator(SYS, SimConfig(n_tasks=m, seed=0), device=dev
                     ).sample_stream(n_rounds=rounds,
                                     feature_seed=1 if features else None)


def _assert_bits(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _sessions(pol, dev, **kw):
    return (ServeSession(pol, M, device=dev, capture=None, **kw),
            ServeSession(pol, M, device=dev, capture=False, **kw))


def _runs_equal(graphed, eager, stream):
    """Two runs of each (the carry continues), bits and carries equal."""
    for _ in range(2):
        _assert_bits(graphed.run(stream), eager.run(stream))
    for x, y in zip(tree_leaves(graphed.state), tree_leaves(eager.state)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["gate", "jcab", "sniper", "tau_proxy"])
def test_replay_equals_eager(dev, kind):
    pol = _policy(kind, dev)
    graphed, eager = _sessions(pol, dev)
    _runs_equal(graphed, eager, _stream(dev, features=kind == "gate"))
    (graph,) = graphed.graphs.values()
    assert graph.graph is not None and graph.replays == 2 * R - 1
    assert graph.capture_s > 0


@pytest.mark.parametrize("name", ["straggler_tail", "flash_churn",
                                  "edge_outage"])
def test_scenario_replay_equals_eager(dev, name):
    simc = SimConfig(n_tasks=M, seed=0)
    trace = sc.compile_scenario(name, SYS, simc, R, seed=0)
    obs = sc.apply_scenario(_stream(dev), trace)
    graphed, eager = _sessions(_policy("gate", dev), dev, sim=simc,
                               hedge=trace.hedge, admission=trace.admission)
    _runs_equal(graphed, eager, obs)
    if name == "flash_churn":
        for x, y in zip(graphed._churn_carry, eager._churn_carry):
            assert torch.equal(x, y)


def test_decide_paths_replay_equals_eager(dev):
    """``route_many`` ((S, M) and (M,) difficulty), ``route`` and ``step``
    without ``u``, captured and uncaptured; ``route_scan`` (a plain loop)
    decides as a fresh session's replayed ``route_many``."""
    stream = _stream(dev)
    pol = _policy("gate", dev)
    graphed, eager = _sessions(pol, dev)
    for args in ((stream.dx, stream.z, stream.aq),
                 (stream.dx, stream.z[0], stream.aq[0])):
        _assert_bits(graphed.route_many(*args), eager.route_many(*args))
    one = dataclasses.replace(stream.round(1), bw_mult=None, u=None)
    _assert_bits(graphed.route(one), eager.route(one))
    _assert_bits(graphed.step(one), eager.step(one))
    _, sols = router.route_scan(pol.prob, GCFG, pol.gate_params,
                                router.init_router_state(GCFG, M, dev),
                                stream.dx, stream.z, stream.aq)
    fresh = ServeSession(pol, M, device=dev).route_many(stream.dx, stream.z,
                                                        stream.aq)
    for k in ("route", "r", "p", "v", "tau"):
        assert torch.equal(sols[k], fresh[k]), k


def test_capture_raises_on_a_host_sync(dev):
    """A round that reads a value back to the host cannot be captured: the
    session raises and keeps no graph; uncaptured, the round still runs."""
    @dataclasses.dataclass(frozen=True)
    class Syncing(JCABPolicy):
        def decide_stream(self, state, obs):
            if float(obs.z.sum()) < 0:       # a device-to-host read
                raise AssertionError
            return super().decide_stream(state, obs)

    pol = Syncing(_policy("jcab", dev).lat)
    stream = _stream(dev, features=False)
    graphed, eager = _sessions(pol, dev)
    with pytest.raises(RuntimeError, match="capturing the serving round"):
        graphed.run(stream)
    assert not graphed.graphs
    eager.run(stream)


def test_launches_of_a_replay_are_the_captured_counts(dev):
    pol = _policy("gate", dev)
    sess = ServeSession(pol, M, device=dev)
    stream = _stream(dev)
    reset_launch_counts()
    sess.run(stream)           # warm-up round, capture, R - 1 replays
    want = {"gate_cell": R, "ccg_solve": R, "c6_repair": R, "lpt_queue": R}
    assert launch_counts() == want
    (graph,) = sess.graphs.values()
    assert dict(graph.launches) == {k: 1 for k in want}
    reset_launch_counts()
    sess.run(stream)
    assert launch_counts() == {k: R * n for k, n in graph.launches.items()}


def test_cluster_repair_round_replay_equals_eager(dev):
    """Above the one-block repair's 16,384 tasks the round's C6 repair is
    one launch of the cluster kernel: the replayed round equals its
    uncaptured twin bit for bit, one c6_repair launch a round, no
    c6_tail."""
    m, rounds = 20000, 3
    pol = _policy("gate", dev)
    stream = _stream(dev, rounds=rounds, m=m)
    graphed = ServeSession(pol, m, device=dev, capture=None)
    eager = ServeSession(pol, m, device=dev, capture=False)
    reset_launch_counts()
    _assert_bits(graphed.run(stream), eager.run(stream))
    counts = launch_counts()
    assert counts["c6_repair"] == 2 * rounds and "c6_tail" not in counts
    (graph,) = graphed.graphs.values()
    assert graph.graph is not None


def test_reset_then_replay_equals_a_fresh_session(dev):
    pol = _policy("gate", dev)
    stream = _stream(dev)
    sess = ServeSession(pol, M, device=dev)
    sess.run(stream)
    graphs = dict(sess.graphs)
    sess.reset()
    again = sess.run(stream)
    assert sess.graphs == graphs
    _assert_bits(again, ServeSession(pol, M, device=dev).run(stream))


@pytest.mark.parametrize("name", ("none",) + sc.SUITE)
@pytest.mark.parametrize("kind", ["gate", "tau_proxy"])
def test_eager_round_makes_no_sync(dev, kind, name):
    """One uncaptured round of R2E-VID through each scenario under
    ``set_sync_debug_mode("error")`` (after one unchecked round builds the
    cached tables)."""
    simc = SimConfig(n_tasks=M, seed=0)
    trace = sc.compile_scenario(name, SYS, simc, 4, seed=0)
    obs = sc.apply_scenario(_stream(dev, rounds=4, features=kind == "gate"),
                            trace)
    sess = ServeSession(_policy(kind, dev), M, sim=simc, device=dev,
                        capture=False, hedge=trace.hedge,
                        admission=trace.admission)
    sess.run(obs, n_rounds=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess.run(obs, n_rounds=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["a2_cloud_only", "jcab", "rdap", "sniper"])
def test_baseline_eager_round_makes_no_sync(dev, kind):
    stream = _stream(dev, rounds=2, features=False)
    sess = ServeSession(_policy(kind, dev), M, device=dev, capture=False)
    sess.run(stream, n_rounds=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess.run(stream, n_rounds=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_simulator_realize_on_the_card_equals_the_cpu(dev):
    rng = np.random.default_rng(0)
    cfgs = [{"route": rng.integers(0, 2, M), "r": rng.integers(0, 5, M),
             "p": rng.integers(0, 5, M), "v": rng.integers(0, 5, M)}
            for _ in range(3)]
    outs = []
    for where in (dev, "cpu"):
        sim = Simulator(SYS, SimConfig(n_tasks=M, seed=4), device=where)
        rnds = [sim.sample_round() for _ in range(3)]
        outs.append((sim.realize(rnds[0], cfgs[0]),
                     sim.realize_batch(rnds, cfgs)))
    for got, want in zip(*outs):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# the finetune round (online gate tuning inside the graph)
# ---------------------------------------------------------------------------
FT = FinetuneConfig(lr=1e-2, resync_period=2)


def _ft_sessions(dev, **kw):
    pol = _policy("gate", dev)
    return pol, (ServeSession(pol, M, device=dev, finetune=FT, **kw),
                 ServeSession(pol, M, device=dev, finetune=FT, capture=False,
                              **kw))


def _params_equal(a, b):
    for k, v in a.gate_params.items():
        assert torch.equal(v, b.gate_params[k]), k


@pytest.mark.parametrize("name", ["none", "straggler_tail"])
def test_finetune_replay_equals_eager(dev, name):
    """The finetune round captured and replayed against the same round
    uncaptured: outputs, carries, the round counter and the tuned
    parameters bit for bit over two runs; the caller's parameters are
    never written; a replayed update runs the backward kernel."""
    simc = SimConfig(n_tasks=M, seed=0)
    trace = sc.compile_scenario(name, SYS, simc, R, seed=0)
    obs = sc.apply_scenario(_stream(dev), trace)
    pol, (graphed, eager) = _ft_sessions(dev, sim=simc, hedge=trace.hedge)
    before = {k: v.clone() for k, v in pol.gate_params.items()}
    for _ in range(2):
        _assert_bits(graphed.run(obs), eager.run(obs))
        _params_equal(graphed, eager)
    for x, y in zip(tree_leaves((graphed.state, graphed._rounds_done)),
                    tree_leaves((eager.state, eager._rounds_done))):
        assert torch.equal(x, y)
    assert int(graphed._rounds_done) == 2 * R
    (graph,) = graphed.graphs.values()
    assert graph.graph is not None and graph.replays == 2 * R - 1
    assert graph.launches["gate_cell_bwd"] == 1
    for k, v in pol.gate_params.items():
        assert torch.equal(v, before[k]), k
        assert not torch.equal(graphed.gate_params[k], v), k


def test_finetune_rounds_before_the_update_equal_the_plain_run(dev):
    stream = _stream(dev)
    pol, (graphed, _) = _ft_sessions(dev)
    tuned = graphed.run(stream)
    plain = ServeSession(pol, M, device=dev).run(stream)
    for k in plain:
        assert torch.equal(tuned[k][:FT.resync_period],
                           plain[k][:FT.resync_period]), k


def test_finetune_replay_launches_and_reset(dev):
    """Launches after a replayed run are the capture's counts times the
    rounds (one backward a round, kept or not); ``reset`` zeroes the
    counter and keeps the tuned parameters, and the next run equals an
    uncaptured session's after the same reset."""
    stream = _stream(dev)
    _, (graphed, eager) = _ft_sessions(dev)
    reset_launch_counts()
    graphed.run(stream)
    want = {"gate_cell": R, "gate_cell_bwd": R, "ccg_solve": R,
            "c6_repair": R, "lpt_queue": R}
    assert launch_counts() == want
    (graph,) = graphed.graphs.values()
    assert dict(graph.launches) == {k: 1 for k in want}
    eager.run(stream)
    tuned = {k: v.clone() for k, v in graphed.gate_params.items()}
    graphed.reset()
    eager.reset()
    assert int(graphed._rounds_done) == 0
    for k, v in graphed.gate_params.items():
        assert torch.equal(v, tuned[k]), k
    graphs = dict(graphed.graphs)
    reset_launch_counts()
    _assert_bits(graphed.run(stream), eager.run(stream))
    assert graphed.graphs == graphs
    _params_equal(graphed, eager)


def test_finetune_eager_round_makes_no_sync(dev):
    """An uncaptured finetune round that updates (the counter at 1 with
    resync_period 2) under ``set_sync_debug_mode("error")``."""
    stream = _stream(dev, rounds=2)
    _, (_, eager) = _ft_sessions(dev)
    eager.run(stream, n_rounds=1)
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in eager.gate_params.items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager.run(stream, n_rounds=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert any(not torch.equal(v, before[k])
               for k, v in eager.gate_params.items())
