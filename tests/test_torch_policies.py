"""Port parity for the paper's method comparison: every registered policy
(A², JCAB, RDAP, Sniper, R2E-VID in τ-proxy mode and its two §4.4
ablations) through the port's ``ServeSession.run`` (plain versions, on the
CPU) against a live JAX ``ServeSession.run`` on the same stream, a carry
converted in mid-run, ``Simulator.run`` / ``aggregate``, and the registry.

Decisions (route/r/p/v) must match exactly, except on lanes where some
feasibility test of the round lies within 1e-6 of its threshold by the
reference's formula (torch's and XLA's float32 ``exp`` differ by an ulp on
some inputs): the test reports such lanes.  Metrics must agree to 1e-5
relative on every round whose decisions all match, the bar of the slice-1
session test.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core.lattice import DecisionLattice as JLat
from repro.serving import policy as jpolicy
from repro.serving.policy import Observation as JObs
from repro.serving.policy import make_policy as j_make_policy
from repro.serving.session import ServeSession as JSession
from repro.serving.simulator import SimConfig as JSimConfig
from repro.serving.simulator import Simulator as JSimulator
from repro_torch.convert import policy_state_from_numpy, policy_state_to_numpy
from repro_torch.core.cost_model import SystemConfig
from repro_torch.serving import policy as tpolicy
from repro_torch.serving.policy import Observation, make_policy
from repro_torch.serving.session import ServeSession
from repro_torch.serving.simulator import SimConfig, Simulator

JSYS = jcm.SystemConfig()
MARGIN_EXEMPT = 1e-6
DEC_KEYS = ("route", "r", "p", "v")
MET_KEYS = ("delay", "energy", "cost", "accuracy")
VARIANTS = {
    "a2_cloud_only": ("a2_cloud_only", {}),
    "jcab": ("jcab", {}),
    "rdap": ("rdap", {}),
    "sniper": ("sniper", {}),
    "r2evid_tau_proxy": ("r2evid", {}),
    "r2evid_no_stage1": ("r2evid", {"use_stage1": False}),
    "r2evid_no_stage2": ("r2evid", {"use_stage2": False}),
}


def _inputs(m, r, seed):
    rng = np.random.default_rng(seed)
    z = rng.uniform(0, 1, (r, m)).astype(np.float32)
    aq = rng.uniform(0.55, 0.82, (r, m)).astype(np.float32)
    aq[:, :2] = [0.99, 1.1]                     # nothing feasible: fallbacks
    z[1:, 2] = z[0, 2]                          # sniper reuses its profile
    aq[1:, 2] = aq[0, 2]
    return dict(z=z, aq=aq,
                bw_mult=rng.uniform(0.8, 1.0, (r, 2)).astype(np.float32),
                u=rng.uniform(0, 0.3, (r, 5)).astype(np.float32))


def decision_margin(z, aq, z_prev=None):
    """Per lane: the smallest distance of any accuracy test a policy makes
    this round to its threshold (A^q, A^q + nominal margin, A^q + robust
    margin), at z and, for RDAP's forecast, at the EMA of z."""
    lat = JLat.build(JSYS)
    zs = [z] if z_prev is None else [
        z, (np.float32(0.7) * z_prev + np.float32(0.3) * z).astype(np.float32)]
    out = np.full(z.shape, np.inf)
    for zz in zs:
        f = np.asarray(lat.accuracy_flat(jnp.asarray(zz)))
        for off in (0.0, JSYS.acc_margin_nominal, JSYS.acc_margin_robust):
            thr = (aq + np.float32(off))[:, None, None]
            out = np.minimum(out, np.abs(f - thr).min(axis=(1, 2)))
    return out


def _obs(inputs, kind):
    if kind == "jax":
        return JObs(**{k: jnp.asarray(v) for k, v in inputs.items()})
    return Observation(**{k: torch.from_numpy(np.array(v))
                          for k, v in inputs.items()})


def _compare_runs(tm, jm, inputs, what):
    n_rounds, m = inputs["z"].shape
    exempt_seen, matched = 0, 0
    for t in range(n_rounds):
        margin = decision_margin(inputs["z"][t], inputs["aq"][t],
                                 inputs["z"][t - 1] if t else None)
        diff = np.zeros(m, bool)
        for k in DEC_KEYS:
            diff |= tm[k][t].numpy() != np.asarray(jm[k][t])
        assert not (diff & (margin >= MARGIN_EXEMPT)).any(), (
            what, t, np.nonzero(diff & (margin >= MARGIN_EXEMPT))[0])
        exempt_seen += int(diff.sum())
        if not diff.any():
            matched += 1
            for k in MET_KEYS:
                np.testing.assert_allclose(
                    tm[k][t].numpy(), np.asarray(jm[k][t]), rtol=1e-5,
                    atol=1e-7, err_msg=f"{what} round {t} {k}")
    print(f"{what}: {exempt_seen} lane-rounds differed under the margin "
          f"exemption; {matched}/{n_rounds} rounds compared in full")
    assert matched >= n_rounds // 2


@pytest.mark.parametrize("m,r", [(12, 6), (64, 8)])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_policy_session_run_matches_reference(variant, m, r):
    name, kw = VARIANTS[variant]
    inputs = _inputs(m, r, seed=m + r)
    jm = JSession(j_make_policy(name, JSYS, **kw), n_streams=m).run(
        _obs(inputs, "jax"))
    pol = make_policy(name, SystemConfig(), device="cpu", **kw)
    tsess = ServeSession(pol, n_streams=m, device="cpu")
    tm = tsess.run(_obs(inputs, "torch"))
    assert sorted(tm) == sorted(jm)
    for k in tm:
        assert tuple(tm[k].shape) == (r, m), k
    _compare_runs(tm, jm, inputs, f"{variant} M={m} R={r}")
    if variant == "r2evid_tau_proxy":
        np.testing.assert_array_equal(tm["tau"].numpy(), inputs["z"])


@pytest.mark.parametrize("variant", ["rdap", "sniper", "r2evid_tau_proxy"])
def test_carry_converted_mid_run_continues_like_reference(variant):
    """A JAX carry after 3 rounds, converted with
    ``policy_state_from_numpy``, serves the next 3 rounds in the port as the
    JAX session does; the port's carry converts back to the same arrays."""
    name, kw = VARIANTS[variant]
    kind = {"rdap": tpolicy.RDAPState, "sniper": tpolicy.SniperState,
            "r2evid_tau_proxy": tpolicy.HistoryState}[variant]
    inputs = _inputs(20, 6, seed=5)
    first = {k: v[:3] for k, v in inputs.items()}
    rest = {k: v[3:] for k, v in inputs.items()}
    jsess = JSession(j_make_policy(name, JSYS, **kw), n_streams=20)
    jsess.run(_obs(first, "jax"))
    state = policy_state_from_numpy(kind, jsess.state, "cpu")
    jm = jsess.run(_obs(rest, "jax"))
    tsess = ServeSession(make_policy(name, SystemConfig(), device="cpu",
                                     **kw),
                         n_streams=20, device="cpu", state=state)
    tm = tsess.run(_obs(rest, "torch"))
    _compare_runs(tm, jm, rest, f"{variant} carried")
    back = policy_state_to_numpy(tsess.state)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jsess.state, k)),
                                      err_msg=k)


@pytest.mark.parametrize("variant", ["rdap", "sniper", "r2evid_no_stage1"])
def test_step_loop_equals_run(variant):
    """R calls of ``step`` serve the same rounds as one ``run``, with a
    stateful carry and with the ``()`` carry of a stateless policy."""
    name, kw = VARIANTS[variant]
    obs = _obs(_inputs(9, 3, seed=4), "torch")
    pol = make_policy(name, SystemConfig(), device="cpu", **kw)
    run = ServeSession(pol, n_streams=9, device="cpu").run(obs)
    sess = ServeSession(pol, n_streams=9, device="cpu")
    steps = [sess.step(obs.round(t)) for t in range(3)]
    for k in run:
        torch.testing.assert_close(run[k], torch.stack([s[k] for s in steps]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["a2_cloud_only", "sniper",
                                     "r2evid_tau_proxy"])
def test_simulator_run_matches_reference(variant):
    """``Simulator.run`` with one seed gives the reference's paper scalars
    (delay, energy, cost, accuracy, success, cloud_frac) to 1e-6."""
    name, kw = VARIANTS[variant]
    cfg = dict(n_rounds=5, n_tasks=30, seed=42, bw_fluctuation=0.1)
    want = JSimulator(JSYS, JSimConfig(**cfg)).run(
        j_make_policy(name, JSYS, **kw))
    sim = Simulator(SystemConfig(), SimConfig(**cfg), device="cpu")
    got = sim.run(make_policy(name, SystemConfig(), device="cpu", **kw))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_aggregate_matches_reference_on_given_metrics():
    """``aggregate`` draws the same observation noise as the reference from
    the same rng state and averages the same way."""
    rng = np.random.default_rng(0)
    mets = {k: rng.uniform(0.1, 1.0, (4, 11)).astype(np.float32)
            for k in MET_KEYS}
    mets["route"] = rng.integers(0, 2, (4, 11)).astype(np.int32)
    aq = rng.uniform(0.55, 0.82, (4, 11)).astype(np.float32)
    want = JSimulator(JSYS, JSimConfig(seed=3)).aggregate(mets, aq)
    got = Simulator(SystemConfig(), SimConfig(seed=3), device="cpu").aggregate(
        {k: torch.from_numpy(v) for k, v in mets.items()},
        torch.from_numpy(aq))
    assert got == want


def test_registry_names_and_aliases():
    assert sorted(tpolicy.POLICIES) == sorted(jpolicy.POLICIES)
    assert tpolicy._ALIASES == jpolicy._ALIASES
    for name in list(tpolicy.POLICIES) + list(tpolicy._ALIASES):
        key = tpolicy._ALIASES.get(name, name)
        pol = make_policy(name, SystemConfig(), device="cpu")
        assert isinstance(pol, tpolicy.POLICIES[key])
        assert pol.name == j_make_policy(name, JSYS).name == key
        assert pol.device.type == "cpu" and pol.force == "auto"
    assert make_policy("jcab", SystemConfig(), device="cpu",
                       force="ref").force == "ref"
    with pytest.raises(KeyError):
        make_policy("nope", SystemConfig(), device="cpu")
    with pytest.raises(ValueError, match="use_gate"):
        make_policy("r2evid", SystemConfig(), device="cpu", use_gate=False,
                    gate_params={"w": torch.zeros(1)})
