"""Stream-sharded serving in the port (``ServeSession.run_sharded``, plain
versions on the CPU, ranks on gloo) against the JAX package.

* World 1 (in this process): every policy in both modes equals the port's
  dense ``run`` bit for bit, the reference's one-device contract.
* World 4 (spawned ranks), M = 64, R = 4, pools 16 / 8, ``bw_scale`` 0.5:
  gate-mode R2E-VID, RDAP and Sniper against the live JAX ``run_sharded``
  on 4 host devices, in both modes: decisions exact, metrics within 1e-5
  relative (the hierarchical mode's partitioned delay and cost included)
  and the final carry equal.
* M = 13 on 4 ranks (churn × ``outage_collapse``), both modes: the
  reference's checks against the JAX dense run (JAX's own sharded run
  fails at an M that does not divide by the device count).
* The guards, the audit of the collectives a round makes, and the sharded
  round graph against a plain loop over its round function.

The JAX references run in one subprocess (the device count is fixed when
JAX starts; this process's JAX has one device) that writes them to an npz.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch_sharded_ranks import policy, session_ranks

from repro_torch.core.cost_model import SystemConfig
from repro_torch.core.gating import GateConfig, init_gate_params
from repro_torch.launch.mesh import host_mesh, run_ranks, single_rank_group
from repro_torch.serving.tree import tree_leaves
from repro_torch.serving.session import FinetuneConfig, ServeSession
from repro_torch.serving.simulator import SimConfig, Simulator

SYS = SystemConfig()
POLICIES = ("r2evid", "rdap", "jcab", "a2_cloud_only", "sniper")
LIVE = ("r2evid", "rdap", "sniper")
DEC_KEYS = ("route", "r", "p", "v")
MET_KEYS = ("delay", "energy", "cost", "accuracy")
STREAM_KEYS = ("z", "aq", "dx", "bw_mult", "u", "tier_ok", "avail",
               "lat_mult", "bw_scale", "arrive_n", "depart")

JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp
import numpy as np
from repro.core.cost_model import SystemConfig
from repro.core.features import feature_dim
from repro.core.gating import GateConfig, gate_specs
from repro.models.params import init_params
from repro.serving.policy import make_policy
from repro.serving.scenarios import apply_scenario, compile_scenario
from repro.serving.session import AdmissionConfig, ServeSession
from repro.serving.simulator import SimConfig, Simulator

KEYS = %(keys)r
out = {}
def put(prefix, obj):
    for k in KEYS:
        if getattr(obj, k, None) is not None:
            out[f"{prefix}/{k}"] = np.asarray(getattr(obj, k))

sys_ = SystemConfig()
m, r = 64, 4
simc = SimConfig(n_tasks=m, n_rounds=r, seed=7, bw_fluctuation=0.2)
stream = Simulator(sys_, simc).sample_stream(r, feature_seed=1)
stream = dataclasses.replace(stream, bw_scale=jnp.full((r,), 0.5, jnp.float32))
put("stream", stream)
gcfg = GateConfig(d_feature=feature_dim())
gp = init_params(gate_specs(gcfg), jax.random.PRNGKey(0))
for k, v in gp.items():
    out[f"gate/{k}"] = np.asarray(v)
mesh = jax.make_mesh((4,), ("data",))
for name in %(live)r:
    pol = make_policy(name, sys_, **(dict(gate_params=gp, gate_cfg=gcfg)
                                     if name == "r2evid" else {}))
    for hier in (0, 1):
        sess = ServeSession(pol, m, sim=simc, n_edge=16, n_cloud=8)
        mets = sess.run_sharded(mesh, stream, hierarchical=bool(hier))
        for k, v in mets.items():
            out[f"run/{name}/{hier}/{k}"] = np.asarray(v)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(sess.state)):
            out[f"state/{name}/{hier}/{i}"] = np.asarray(leaf)

# churn x outage_collapse at M = 13 (the reference's uneven case): JAX's
# sharded run fails there, so the dense run is the reference
m, r = 13, 8
simc = SimConfig(n_tasks=m, n_rounds=r, seed=11, bw_fluctuation=0.2,
                 n_edge_servers=8, n_cloud_servers=4)
stream = Simulator(sys_, simc).sample_stream(r)
rng = np.random.default_rng(0)
stream = dataclasses.replace(
    stream, arrive_n=jnp.asarray(rng.poisson(2.0, size=r), jnp.int32),
    depart=jnp.asarray(rng.random((r, m)) < 0.15))
stream = apply_scenario(stream, compile_scenario("outage_collapse", sys_,
                                                 simc, r, seed=0))
put("uneven", stream)
acfg = AdmissionConfig(init_alive=m // 2)
out["uneven/acfg_max_queue"] = np.asarray(acfg.max_queue)
out["uneven/acfg_init_alive"] = np.asarray(acfg.init_alive)
dense = ServeSession(make_policy("r2evid", sys_), m, sim=simc,
                     admission=acfg).run(stream)
for k, v in dense.items():
    out[f"udense/{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


def _prefixed(ref, prefix):
    n = len(prefix) + 1
    return {k[n:]: ref[k] for k in ref if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_sharded") / "ref.npz"
    script = JAX_SCRIPT % {"keys": STREAM_KEYS, "live": LIVE}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", textwrap.dedent(script),
                           str(path)], capture_output=True, text=True,
                          timeout=300, env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def ranks(jax_ref):
    """The port's checks on 4 gloo ranks (one start), each rank's result."""
    return run_ranks(session_ranks, 4, backend="gloo", timeout=120,
                     args=(_prefixed(jax_ref, "stream"),
                           _prefixed(jax_ref, "gate"),
                           _prefixed(jax_ref, "uneven")))


def _stream_world1(m=64, r=4):
    """M = 64 streams of the port's own simulator, ``bw_scale`` 0.5."""
    stream = Simulator(SYS, SimConfig(n_tasks=m, seed=7, bw_fluctuation=0.2),
                       device="cpu").sample_stream(r, feature_seed=1)
    return dataclasses.replace(stream, bw_scale=torch.full((r,), 0.5))


# ---------------------------------------------------------------------------
# world 1: the dense run, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hierarchical", [False, True])
@pytest.mark.parametrize("name", POLICIES)
def test_world_one_equals_dense_bit_for_bit(name, hierarchical):
    """One rank: the gathered tail is the dense tail, and the hierarchical
    one degenerates to it (sub-budget min(bw, B), the whole pool), so
    every output and the final carry equal the dense run's bits."""
    stream = _stream_world1()
    kw = dict(n_edge=16, n_cloud=8, device="cpu")
    pol = (policy("r2evid", {k: v.numpy() for k, v in
                             _gate_params().items()})
           if name == "r2evid" else policy(name))
    dense_sess = ServeSession(pol, 64, **kw)
    dense = dense_sess.run(stream)
    with single_rank_group("gloo"):
        sess = ServeSession(pol, 64, mesh=host_mesh(),
                            hierarchical=hierarchical, **kw)
        out = sess.run(stream)
    assert set(out) == set(dense)
    for k in dense:
        assert torch.equal(out[k], dense[k]), k
    for a, b in zip(tree_leaves(sess.state), tree_leaves(dense_sess.state),
                    strict=True):
        assert torch.equal(a, b)


def _gate_params():
    return init_gate_params(GateConfig(d_feature=35),
                            torch.Generator().manual_seed(0), "cpu")


# ---------------------------------------------------------------------------
# world 4 against the live JAX sharded run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hierarchical", [0, 1])
@pytest.mark.parametrize("name", LIVE)
def test_four_ranks_match_live_jax_run_sharded(jax_ref, ranks, name,
                                               hierarchical):
    want = _prefixed(jax_ref, f"run/{name}/{hierarchical}")
    got = ranks[0]["runs"][name, bool(hierarchical)]
    assert set(got["out"]) == set(want)
    for k in DEC_KEYS:
        np.testing.assert_array_equal(got["out"][k], want[k], err_msg=k)
    for k in set(want) - set(DEC_KEYS):
        np.testing.assert_allclose(got["out"][k], want[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    state = _prefixed(jax_ref, f"state/{name}/{hierarchical}")
    assert len(got["state"]) == len(state)
    for i, leaf in enumerate(got["state"]):
        np.testing.assert_allclose(leaf, state[str(i)], rtol=1e-5,
                                   atol=1e-6, err_msg=f"carry leaf {i}")


def test_every_rank_returns_the_same_outputs(ranks):
    for res in ranks[1:]:
        for key, run in res["runs"].items():
            for k, v in run["out"].items():
                np.testing.assert_array_equal(
                    v, ranks[0]["runs"][key]["out"][k], err_msg=str(key))
            for a, b in zip(run["state"], ranks[0]["runs"][key]["state"]):
                np.testing.assert_array_equal(a, b)
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# uneven M: the reference's invariants against the JAX dense run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hierarchical", [False, True])
def test_uneven_m_churn_outage_collapse(jax_ref, ranks, hierarchical):
    """M = 13 on 4 ranks (3 dummy streams), slot-pool churn under
    ``outage_collapse``: the gathered mode equals dense on every key; the
    hierarchical mode keeps the admission and every decision exact and the
    accuracy close, and serves nothing on a dead slot."""
    dense = _prefixed(jax_ref, "udense")
    got = ranks[0]["uneven"][hierarchical]
    assert set(got) == set(dense)
    if not hierarchical:
        for k in dense:
            np.testing.assert_allclose(got[k], dense[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        return
    for k in ("alive", "route", "r", "p", "v", "queue_depth", "admitted",
              "dropped"):
        np.testing.assert_array_equal(got[k], dense[k], err_msg=k)
    np.testing.assert_allclose(got["accuracy"], dense["accuracy"],
                               rtol=1e-5, atol=1e-5)
    alive = got["alive"]
    for k in MET_KEYS:
        assert (got[k][~alive] == 0.0).all() and np.isfinite(got[k]).all(), k
    assert got["admitted"].sum() > 0


# ---------------------------------------------------------------------------
# guards, audit, the round graph
# ---------------------------------------------------------------------------
def test_hierarchical_refuses_hedge(ranks):
    assert "hedge" in ranks[0]["hedge_refusal"]


def test_hierarchical_refuses_an_indivisible_pool(ranks):
    assert "divide" in ranks[0]["pool_refusal"]


@pytest.mark.parametrize("name", LIVE)
def test_hierarchical_round_exchanges_at_most_four_elements(ranks, name):
    """The structural invariant, measured: inside a hierarchical round only
    the (2,) (draw, weight) gather (R2E-VID's repair) and the 2-int tier
    count psum cross ranks."""
    ops = ranks[0]["runs"][name, True]["in_round"]
    assert ops and max(n for _, n in ops) <= 4, ops
    assert {op for op, _ in ops} <= {"all_gather", "psum"}


@pytest.mark.parametrize("name", LIVE)
def test_gathered_round_gathers_a_whole_shard(ranks, name):
    ops = ranks[0]["runs"][name, False]["in_round"]
    assert max(n for op, n in ops if op == "all_gather") >= 64 // 4, ops


def test_sharded_round_graph_equals_a_plain_loop(ranks):
    for res in ranks:
        assert all(res["graph_vs_loop"].values()), res["graph_vs_loop"]
    assert set(ranks[0]["graph_vs_loop"]) >= set(DEC_KEYS + MET_KEYS)


def test_non_shardable_policy_finetune_and_unknown_dim_refused():
    stream = _stream_world1(m=8, r=2)
    with single_rank_group("gloo"):
        mesh = host_mesh()
        sniper = dataclasses.replace(policy("sniper"),
                                     replicated_profile=False)
        with pytest.raises(ValueError, match="cannot run stream-sharded"):
            ServeSession(sniper, 8, device="cpu").run_sharded(mesh, stream)
        gate = policy("r2evid", {k: v.numpy() for k, v in
                                 _gate_params().items()})
        assert gate.gate_cfg == GateConfig(d_feature=35)
        ft = ServeSession(gate, 8, device="cpu", finetune=FinetuneConfig())
        with pytest.raises(NotImplementedError, match="single-mesh"):
            ft.run_sharded(mesh, stream)
        with pytest.raises(ValueError, match="no 'model'"):
            ServeSession(policy("rdap"), 8, device="cpu", mesh=mesh,
                         mesh_axis="model")
