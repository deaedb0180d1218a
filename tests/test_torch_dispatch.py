"""The port's continuous-batching dispatch executor and tier pools: the
counterparts of ``tests/test_dispatch.py`` on the port (CPU, the tier SMOKE
configs in their bfloat16 compute), and parity with the live JAX executor
on the same weights and requests.

The serial ``ModelPool.serve_segment`` path is the executor's parity
oracle: its bucketed prefills and token-level slab decode must reproduce
the oracle's decoded ids request for request, on the dense tier pools and
on the recurrent ones (Falcon-Mamba's SSM blocks as the edge tier,
RecurrentGemma's RG-LRU and local-attention blocks as the cloud tier),
whose slab holds convolution and recurrent states.  Against the JAX
executor the models run in float32 compute (logits within ~1e-6, see
``test_torch_model.py``), and with the same injected tick clock the two
executors must agree exactly: decoded ids, admission trace, latency
statistics and feedback.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config as j_smoke
from repro.core import cost_model as jcm
from repro.core.lattice import DecisionLattice as JLat
from repro.serving.dispatch import DispatchExecutor as JDispatchExecutor
from repro.serving.dispatch import Request as JRequest
from repro.serving.policy import Observation as JObs
from repro.serving.policy import make_policy as j_make_policy
from repro.serving.pools import make_tier_pools as j_make_tier_pools
from repro.serving.session import ServeSession as JSession
from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.core.cost_model import SystemConfig
from repro_torch.serving.dispatch import (
    DispatchExecutor,
    PoolExecutor,
    Request,
    _bucket_pad,
    serve_serial_oracle,
)
from repro_torch.serving.policy import Observation, make_policy
from repro_torch.serving.pools import ModelPool, make_tier_pools
from repro_torch.serving.session import ServeSession

SYS = SystemConfig()
TIERS = ("qwen1.5-0.5b", "qwen3-8b")
RECURRENT = ("falcon-mamba-7b", "recurrentgemma-9b")


class _TickClock:
    """Deterministic clock: each read advances one tick."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


@pytest.fixture(scope="module")
def pools():
    return make_tier_pools(*(get_smoke_config(a) for a in TIERS),
                           device="cpu")


def _mixed_requests(vocab, m=12, seed=0, decode_tokens=6, lengths=(1, 4),
                    kind=Request):
    """Mixed-tier, mixed-length requests (prompts of 16·k tokens, the
    fidelity sizes the session's dispatch produces)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(m):
        tier = int(rng.integers(0, 2))
        n = 16 * int(rng.integers(*lengths))
        toks = ((i * 131 + np.arange(n)) % vocab).astype(np.int32)
        reqs.append(kind(stream=i, tier=tier, tokens=toks,
                         decode_tokens=decode_tokens))
    return reqs


def _ids(ex):
    return {c.stream: c.ids for t in ex.execs for c in ex.execs[t].completions}


# ---------------------------------------------------------------------------
# Parity with the serial oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decode_tokens", [6, 1])
def test_executor_matches_serial_oracle(pools, decode_tokens):
    """``decode_tokens=1`` segments finish at their prefill, as the serial
    path's decode loop runs no step."""
    reqs = _mixed_requests(128, m=12, decode_tokens=decode_tokens)
    want = serve_serial_oracle(pools, [dataclasses.replace(r) for r in reqs])
    ex = DispatchExecutor(pools, n_slots=4, max_prefill_batch=2)
    stats = ex.serve(reqs)
    got = _ids(ex)
    assert set(got) == set(want)
    for s in want:
        assert got[s].shape == (decode_tokens,)
        np.testing.assert_array_equal(got[s], want[s],
                                      err_msg=f"stream {s} ids diverge")
    assert sum(st["requests"] for st in stats.values()) == len(reqs)
    assert sum(st["tokens"] for st in stats.values()) == sum(
        len(r.tokens) + r.decode_tokens for r in reqs)


def test_recurrent_executor_matches_serial_oracle():
    """The slab path of the recurrent pools (states scattered into slots,
    updated in place by every decode step) reproduces the serial path."""
    pools = make_tier_pools(*(get_smoke_config(a) for a in RECURRENT),
                            device="cpu")
    reqs = _mixed_requests(128, m=12, seed=5, decode_tokens=6)
    want = serve_serial_oracle(pools, [dataclasses.replace(r) for r in reqs])
    ex = DispatchExecutor(pools, n_slots=4, max_prefill_batch=2)
    ex.serve(reqs)
    got = _ids(ex)
    assert set(got) == set(want)
    for s in want:
        np.testing.assert_array_equal(got[s], want[s],
                                      err_msg=f"stream {s} ids diverge")


def test_join_leave_does_not_perturb_decodes(pools):
    """A segment's ids do not depend on which segments share its decode
    batch, nor on their join and leave times."""
    mk = lambda s, n, d: Request(
        stream=s, tier=0,
        tokens=((s * 131 + np.arange(n)) % 128).astype(np.int32),
        decode_tokens=d)
    alone = DispatchExecutor(pools, n_slots=4)
    alone.serve([mk(0, 32, 10)])
    want = alone.execs[0].completions[0].ids

    ex = DispatchExecutor(pools, n_slots=4, max_prefill_batch=2)
    ex.submit([mk(0, 32, 10), mk(1, 32, 2)])
    for _ in range(4):
        ex.step()
    ex.submit([mk(2, 16, 6)])           # a late joiner at another depth
    ex.drain()
    got = {c.stream: c.ids for c in ex.execs[0].completions}
    np.testing.assert_array_equal(got[0], want)
    for s, n, d in ((1, 32, 2), (2, 16, 6)):
        solo = DispatchExecutor(pools, n_slots=4)
        solo.serve([mk(s, n, d)])
        np.testing.assert_array_equal(got[s],
                                      solo.execs[0].completions[0].ids)


# ---------------------------------------------------------------------------
# Scheduling invariants
# ---------------------------------------------------------------------------
def test_queue_drains_and_no_starvation(pools):
    reqs = _mixed_requests(128, m=16, seed=1, decode_tokens=4)
    ex = DispatchExecutor(pools, n_slots=2, max_prefill_batch=2)
    ex.serve(reqs)
    assert ex.idle
    assert set(_ids(ex)) == {r.stream for r in reqs}
    for t, pex in ex.execs.items():
        for admitted, oldest in pex.admission_log:
            assert oldest in admitted, (t, admitted, oldest)


def test_submit_validates_prompt_length(pools):
    ex = PoolExecutor(pools[0], n_slots=2, max_prefill_len=48)
    for n in (49, 0):
        with pytest.raises(ValueError, match="prompt length"):
            ex.submit(Request(stream=0, tier=0,
                              tokens=np.zeros((n,), np.int32)))
    with pytest.raises(ValueError, match="decode_tokens"):
        ex.submit(Request(stream=0, tier=0, tokens=np.zeros((4,), np.int32),
                          decode_tokens=0))
    with pytest.raises(ValueError, match="unknown tier"):
        DispatchExecutor(pools).submit([Request(
            stream=0, tier=2, tokens=np.zeros((4,), np.int32))])


def test_serve_empty_request_set(pools):
    ex = DispatchExecutor(pools)
    assert ex.serve([]) == {}
    assert ex.idle


def test_serial_path_b0_regression(pools):
    out = pools[0].serve_segment(torch.zeros((0, 16), dtype=torch.long),
                                 decode_tokens=4)
    assert tuple(out.shape) == (0, 4)


def test_bucket_pad():
    assert [_bucket_pad(n, 8) for n in (1, 2, 3, 5, 8, 9)] == \
        [1, 2, 4, 8, 8, 8]


# ---------------------------------------------------------------------------
# Stats / measurement
# ---------------------------------------------------------------------------
def test_pool_stats_latency_percentiles(pools):
    """Interpolated quantiles as the reference's (``jnp.quantile``)."""
    pool = ModelPool(get_smoke_config("qwen1.5-0.5b"), device="cpu",
                     params=pools[0].params)
    pool.serve_segment(torch.ones((3, 16), dtype=torch.long),
                       decode_tokens=4)
    st = pool.stats
    assert (st.requests, len(st.latencies)) == (3, 3)
    assert (st.prefills, st.decode_steps) == (1, 3)
    assert st.tokens_per_s > 0
    assert 0 < st.p50_s() <= st.p99_s()
    st.latencies = [0.5, 0.1, 0.4, 2.0, 0.3]
    lat = jnp.asarray(st.latencies, jnp.float32)
    assert st.p50_s() == float(jnp.quantile(lat, 0.5))
    assert st.p99_s() == float(jnp.quantile(lat, 0.99))
    assert {"requests", "tokens", "tokens_per_s", "p50_s",
            "p99_s"} <= set(st.summary())


def test_dispatch_returns_latency_stats(pools):
    ex = DispatchExecutor(pools, n_slots=4, clock=_TickClock())
    stats = ex.serve(_mixed_requests(128, m=8, seed=2, decode_tokens=4))
    for st in stats.values():
        assert st["requests"] > 0 and st["tokens_per_s"] > 0
        assert 0 < st["p50_s"] <= st["p99_s"]
        assert st["mean_service_s"] > 0


def test_feedback_loaded_tier_reports_lower_mult(pools):
    ex = DispatchExecutor(pools, n_slots=2, max_prefill_batch=2,
                          clock=_TickClock())
    reqs = [Request(stream=i, tier=1,
                    tokens=((i * 131 + np.arange(16)) % 128).astype(np.int32),
                    decode_tokens=4) for i in range(12)]
    ex.serve(reqs)
    fb = ex.feedback()
    assert fb["bw_mult"][0] == 1.0           # edge never served
    assert fb["bw_mult"][1] < 1.0            # cloud queued
    assert fb["per_tier"][1]["wait_ewma_s"] > 0
    ex.reset_measurements()
    assert ex.feedback()["bw_mult"][1] == 1.0


# ---------------------------------------------------------------------------
# Session integration
# ---------------------------------------------------------------------------
def _session(pools, m):
    return ServeSession(make_policy("r2evid", SYS, device="cpu"), m,
                        pools=pools, device="cpu")


def test_session_dispatch_sizes_tokens_per_segment(pools):
    sess = _session(pools, 6)
    r = torch.tensor([0, 2, 1, 4, 0, 1])
    sol = {"route": torch.tensor([0, 0, 1, 1, 1, 0]), "r": r,
           "p": torch.zeros(6, dtype=torch.long),
           "v": torch.zeros(6, dtype=torch.long)}
    sess.dispatch(sol, decode_tokens=2)
    got = {c.stream: c.n_prefill for t in sess.executor.execs
           for c in sess.executor.execs[t].completions}
    assert got == {i: 16 * (1 + int(r[i])) for i in range(6)}
    assert sess.executor.execs[0].max_prefill_len == 16 * SYS.n_res


def test_session_dispatch_skips_dead_lanes_and_serial_counts(pools):
    sess = _session(pools, 5)
    sol = {"route": torch.tensor([0, -1, 1, -1, 0]),
           "r": torch.zeros(5, dtype=torch.long)}
    sess.dispatch(sol, decode_tokens=2)
    done = {c.stream for t in sess.executor.execs
            for c in sess.executor.execs[t].completions}
    assert done == {0, 2, 4}
    assert sess.dispatch(sol, decode_tokens=2, serial=True) == {0: 2, 1: 1}
    with pytest.raises(ValueError, match="no pools"):
        ServeSession(make_policy("r2evid", SYS, device="cpu"), 5,
                     device="cpu").dispatch(sol)


# ---------------------------------------------------------------------------
# Parity with the live JAX executor and session
# ---------------------------------------------------------------------------
def _f32_pools(tiers):
    """The JAX tier pools and the port's on the same weights, both in
    float32 compute."""
    jcfgs = [dataclasses.replace(j_smoke(a), compute_dtype="float32")
             for a in tiers]
    jpools = j_make_tier_pools(*jcfgs)
    tpools = {}
    for t, a in enumerate(tiers):
        cfg = dataclasses.replace(get_smoke_config(a),
                                  compute_dtype="float32")
        params = model_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jpools[t].params), cfg, "cpu")
        tpools[t] = ModelPool(cfg, name=jpools[t].name, device="cpu",
                              params=params)
    return jpools, tpools


@pytest.fixture(scope="module")
def f32_pools():
    return _f32_pools(TIERS)


def test_executor_matches_jax_executor(f32_pools):
    _executor_matches_jax_executor(*f32_pools)


def test_recurrent_executor_matches_jax_executor():
    _executor_matches_jax_executor(*_f32_pools(RECURRENT))


def _executor_matches_jax_executor(jpools, tpools):
    kw = dict(n_slots=4, max_prefill_len=64, max_prefill_batch=2)
    jex = JDispatchExecutor(jpools, clock=_TickClock(), **kw)
    tex = DispatchExecutor(tpools, clock=_TickClock(), **kw)
    jstats = jex.serve(_mixed_requests(128, m=14, seed=3, decode_tokens=5,
                                       lengths=(1, 5), kind=JRequest))
    tstats = tex.serve(_mixed_requests(128, m=14, seed=3, decode_tokens=5,
                                       lengths=(1, 5)))
    want, got = _ids(jex), _ids(tex)
    assert set(got) == set(want)
    for s in want:
        np.testing.assert_array_equal(got[s], want[s], err_msg=f"stream {s}")
    for t in jex.execs:
        assert tex.execs[t].admission_log == jex.execs[t].admission_log
    assert set(tstats) == set(jstats)
    for t in jstats:
        for k, v in jstats[t].items():
            np.testing.assert_allclose(tstats[t][k], v, rtol=1e-6,
                                       err_msg=f"tier {t} {k}")
    jfb, tfb = jex.feedback(), tex.feedback()
    np.testing.assert_array_equal(tfb["bw_mult"], jfb["bw_mult"])
    for t in jfb["per_tier"]:
        for k in ("bw_mult", "wait_ewma_s", "service_ewma_s", "queue_depth",
                  "in_flight"):
            assert tfb["per_tier"][t][k] == jfb["per_tier"][t][k], (t, k)


def _decision_margin(z, aq):
    """Per lane: the smallest distance of a feasibility test to its
    threshold (JAX formula); decisions under 1e-6 may flip by an ulp."""
    jsys = jcm.SystemConfig()
    f = np.asarray(JLat.build(jsys).accuracy_flat(jnp.asarray(z)))
    thr = np.asarray(jnp.asarray(aq) + jsys.acc_margin_robust)
    ccg = np.abs(f - thr[:, None, None]).min(axis=(1, 2))
    s1 = np.asarray(jcm.accuracy_stage1(jsys, jnp.asarray(z)))
    return np.minimum(ccg, np.abs(s1 - aq[:, None]).min(axis=1))


def test_feedback_round_trip_matches_reference(f32_pools):
    """Serve a routed solution that loads the cloud tier, fold the measured
    feedback into the next rounds' observation (``apply_feedback``), and
    route them: the port and the JAX session, fed the same feedback, agree
    on every decision (lanes under the 1e-6 feasibility margin excepted)."""
    jpools, tpools = f32_pools
    m, rounds = 64, 3
    sol = {"route": torch.tensor(([1] * 6 + [0] * 2) * 3),
           "r": torch.ones(24, dtype=torch.long)}
    tsess = ServeSession(make_policy("r2evid", SYS, device="cpu"), m,
                         pools=tpools, device="cpu")
    tsess._executor = DispatchExecutor(tpools, n_slots=2,
                                       max_prefill_batch=2,
                                       clock=_TickClock())
    tsess.dispatch(sol, decode_tokens=4)
    fb = tsess.feedback()
    assert fb["bw_mult"][1] < 1.0 and fb["bw_mult"][0] <= 1.0

    rng = np.random.default_rng(0)
    inputs = {
        "z": rng.uniform(0.4, 0.8, (rounds, m)).astype(np.float32),
        "aq": rng.uniform(0.6, 0.8, (rounds, m)).astype(np.float32),
        "bw_mult": rng.uniform(0.8, 1.0, (rounds, 2)).astype(np.float32),
        "u": np.full((rounds, SYS.num_versions), 0.5, np.float32)}
    obs = Observation(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    adjusted = tsess.apply_feedback(obs)
    mult = np.asarray(fb["bw_mult"][:2], np.float32)
    np.testing.assert_allclose(adjusted.bw_mult.numpy(),
                               inputs["bw_mult"] * mult, rtol=1e-7)
    cap = SYS.edge_bw_mbps + SYS.cloud_bw_mbps
    scale = (SYS.edge_bw_mbps * mult[0] + SYS.cloud_bw_mbps * mult[1]) / cap
    np.testing.assert_allclose(adjusted.bw_scale.numpy(),
                               np.full(rounds, scale), rtol=1e-6)
    assert float(adjusted.bw_scale[0]) < 1.0

    tout = tsess.run(adjusted)
    jsess = JSession(j_make_policy("r2evid", jcm.SystemConfig()), m,
                     pools=jpools)
    jout = jsess.run(JObs(**{k: jnp.asarray(v) for k, v in inputs.items()},
                          bw_scale=jnp.asarray(adjusted.bw_scale.numpy())))
    blind = ServeSession(make_policy("r2evid", SYS, device="cpu"), m,
                         device="cpu").run(obs)
    changed = False
    for t in range(rounds):
        near = _decision_margin(inputs["z"][t], inputs["aq"][t]) < 1e-6
        for k in ("route", "r", "p", "v"):
            diff = tout[k][t].numpy() != np.asarray(jout[k][t])
            assert not (diff & ~near).any(), (t, k)
            changed |= not torch.equal(tout[k][t], blind[k][t])
    assert changed, "the fed-back budget changed no decision"
