"""Scenario engine: fault injection for serving runs (paper §4.3) — port of
``repro/serving/scenarios.py``.

A :class:`ScenarioTrace` compiles an adverse serving condition into
per-round arrays that ride on the round-stacked
:class:`~repro_torch.serving.policy.Observation`; ``apply_scenario`` merges
the trace into a sampled stream and ``ServeSession.run`` serves the whole
degraded run:

  ``tier_ok``  (R, 2)     router-visible availability: outaged tiers are
                          infeasible in Stage 1, the CCG solve and C6, and
                          clamped away after temporal consistency
  ``avail``    (R, S)     realization-visible per-server availability
  ``bw_mult``  (R, 2)     bandwidth trace composed onto the stream's
  ``bw_scale`` (R,)       the C6 budget scale the repair plans against
  ``u``        (R, K)     realized compute deviations (adversarial rotation)
  ``lat_mult`` (R, M, 2)  heavy-tailed latency multipliers; with the
                          session's ``hedge=(quantile, cost)`` a backup
                          replica races each straggler
  ``arrive_n`` / ``depart`` (R,) / (R, M)  slot-pool churn, with the
                          trace's ``AdmissionConfig``

The builders are host numpy with a seeded ``default_rng``, copied from the
reference, so a (name, shape, seed) triple gives the reference's arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.cost_model import SystemConfig
from repro_torch.core.lattice import version_deviations
from repro_torch.device import resolve_device
from repro_torch.serving.policy import Observation, make_policy
from repro_torch.serving.session import AdmissionConfig, ServeSession
from repro_torch.serving.simulator import SimConfig, Simulator

#: the named adverse suite (``none`` is the benign control)
SUITE = ("edge_outage", "bw_collapse", "flash_crowd", "straggler_tail",
         "adversarial_u", "churn", "flash_churn", "markov_bw",
         "outage_collapse")

#: Pareto tail index for straggler latency draws (heavy: infinite variance)
_PARETO_ALPHA = 1.5
_LAT_CLIP = 20.0

#: re-serve premium per SLA-violated segment:
#: ``sla_cost = cost + SLA_PENALTY * sla_violation_rate``
SLA_PENALTY = 10.0


@dataclasses.dataclass(frozen=True)
class ScenarioTrace:
    """One compiled scenario: per-round fault arrays (host numpy; None is
    benign along that axis) + the static hedge and admission knobs.
    ``onset`` is the first degraded round (None for always-on scenarios),
    the anchor of the recovery-rounds metric."""
    name: str
    onset: Optional[int] = None
    tier_ok: Any = None     # (R, 2)
    avail: Any = None       # (R, S)
    bw_mult: Any = None     # (R, 2) multiplier composed onto the stream's
    bw_scale: Any = None    # (R,)
    u: Any = None           # (R, K) replaces the stream's realized u
    lat_mult: Any = None    # (R, M, 2)
    hedge: Optional[tuple] = None   # static (quantile, cost)
    arrive_n: Any = None    # (R,) stream arrivals per round (churn)
    depart: Any = None      # (R, M) per-slot departure events (churn)
    admission: Optional[AdmissionConfig] = None


# ---------------------------------------------------------------------------
# builders (host-side, seeded numpy)
# ---------------------------------------------------------------------------
def _none(r, m, n_edge, n_cloud, sys, rng):
    return ScenarioTrace(name="none")


def _cap_frac(sys, edge_frac, cloud_frac):
    """Uplink capacity fraction from per-tier alive/throughput fractions."""
    cap = sys.edge_bw_mbps + sys.cloud_bw_mbps
    return (sys.edge_bw_mbps * edge_frac
            + sys.cloud_bw_mbps * cloud_frac) / cap


def _edge_outage(r, m, n_edge, n_cloud, sys, rng):
    """The edge tier dies at R//3; its servers come back one every other
    round; ``tier_ok`` readmits the tier at quorum (half its servers)."""
    r0 = max(1, r // 3)
    avail = np.ones((r, n_edge + n_cloud), np.float32)
    for i in range(n_edge):
        rec = min(r, r0 + 2 + 2 * i)         # server i back at r0+2+2i
        avail[r0:rec, i] = 0.0
    alive_e = avail[:, :n_edge].mean(axis=1)
    tier_ok = np.ones((r, 2), np.float32)
    tier_ok[:, 0] = (alive_e >= 0.5).astype(np.float32)   # quorum gate
    return ScenarioTrace(
        name="edge_outage", onset=r0, tier_ok=tier_ok, avail=avail,
        bw_scale=_cap_frac(sys, alive_e, 1.0).astype(np.float32))


def _bw_collapse(r, m, n_edge, n_cloud, sys, rng):
    """The cloud uplink ramps down to a 0.15 floor, holds, ramps back."""
    r0 = max(1, r // 3)
    ramp = max(2, r // 8)
    hold = max(2, r // 6)
    floor = 0.15
    trace = np.ones((r,), np.float32)
    for i in range(ramp):                     # down-ramp
        if r0 + i < r:
            trace[r0 + i] = 1.0 - (1.0 - floor) * (i + 1) / ramp
    lo, hi = min(r, r0 + ramp), min(r, r0 + ramp + hold)
    trace[lo:hi] = floor
    for i in range(ramp):                     # recovery ramp
        t = r0 + ramp + hold + i
        if t < r:
            trace[t] = floor + (1.0 - floor) * (i + 1) / ramp
    bw_mult = np.stack([np.ones((r,), np.float32), trace], axis=1)
    return ScenarioTrace(
        name="bw_collapse", onset=r0, bw_mult=bw_mult,
        bw_scale=_cap_frac(sys, 1.0, trace).astype(np.float32))


def _flash_crowd(r, m, n_edge, n_cloud, sys, rng):
    """Three 2-round windows where cross traffic takes ~65% of both
    uplinks."""
    trace = np.ones((r,), np.float32)
    r0 = max(1, r // 4)
    starts = sorted(rng.choice(np.arange(r0, max(r0 + 1, r - 2)),
                               size=min(3, max(1, r - r0 - 2)),
                               replace=False))
    for s in starts:
        trace[s:s + 2] = 0.35
    bw_mult = np.repeat(trace[:, None], 2, axis=1)
    return ScenarioTrace(name="flash_crowd", onset=int(starts[0]),
                         bw_mult=bw_mult, bw_scale=trace.copy())


def _straggler_tail(r, m, n_edge, n_cloud, sys, rng):
    """Pareto (α = 1.5) compute latency multipliers on the primary replica
    and an independent draw for the backup, hedged at the 0.9 quantile."""
    u = rng.uniform(size=(r, m, 2))
    lat = np.clip((1.0 - u) ** (-1.0 / _PARETO_ALPHA), 1.0, _LAT_CLIP)
    return ScenarioTrace(name="straggler_tail",
                         lat_mult=lat.astype(np.float32),
                         hedge=(0.9, 0.05))


def _adversarial_u(r, m, n_edge, n_cloud, sys, rng):
    """Realized deviation saturating the Γ budget every round, the hit set
    rotating across versions."""
    k = sys.num_versions
    udev = version_deviations(sys, "cpu").numpy()
    u = np.zeros((r, k), np.float32)
    for t in range(r):
        hit = [(t + j) % k for j in range(sys.gamma)]
        u[t, hit] = udev[hit]
    return ScenarioTrace(name="adversarial_u", u=u)


def _churn(r, m, n_edge, n_cloud, sys, rng):
    """Poisson(M/10) arrivals a round against per-slot departures with
    p = 1/8; the pool starts half full."""
    lam = max(1.0, m / 10)
    arrive = rng.poisson(lam, size=r).astype(np.int32)
    depart = rng.random((r, m)) < (1.0 / 8.0)
    return ScenarioTrace(name="churn", arrive_n=arrive, depart=depart,
                         admission=AdmissionConfig(init_alive=m // 2))


def _flash_churn(r, m, n_edge, n_cloud, sys, rng):
    """A Poisson(2) trickle plus three bursts of M/2 streams, each landing
    as both uplinks dip to 0.4x for 3 rounds."""
    arrive = rng.poisson(2.0, size=r).astype(np.int32)
    r0 = max(2, r // 5)
    gap = max(3, r // 4)
    bursts = [b for b in (r0, r0 + gap, r0 + 2 * gap) if b < r]
    trace = np.ones((r,), np.float32)
    for b in bursts:
        arrive[b] += m // 2
        trace[b:b + 3] = 0.4
    bw_mult = np.repeat(trace[:, None], 2, axis=1)
    depart = rng.random((r, m)) < (1.0 / 6.0)
    return ScenarioTrace(
        name="flash_churn", onset=int(bursts[0]), bw_mult=bw_mult,
        bw_scale=trace.copy(), arrive_n=arrive, depart=depart,
        admission=AdmissionConfig(init_alive=m // 2, max_queue=m))


def _markov_bw(r, m, n_edge, n_cloud, sys, rng):
    """Gilbert-Elliott cloud uplink: good -> bad with p = 0.15, bad ->
    good with p = 0.35, the bad state at 0.3x."""
    p_gb, p_bg, bad_mult = 0.15, 0.35, 0.3
    trace = np.ones((r,), np.float32)
    state = 0                         # 0 = good, 1 = bad
    for t in range(r):
        flip = rng.random()
        state = (1 if flip < p_gb else 0) if state == 0 else \
                (0 if flip < p_bg else 1)
        trace[t] = bad_mult if state else 1.0
    bad = np.nonzero(trace < 1.0)[0]
    bw_mult = np.stack([np.ones((r,), np.float32), trace], axis=1)
    return ScenarioTrace(
        name="markov_bw", onset=int(bad[0]) if bad.size else None,
        bw_mult=bw_mult,
        bw_scale=_cap_frac(sys, 1.0, trace).astype(np.float32))


def _outage_collapse(r, m, n_edge, n_cloud, sys, rng):
    """The edge outage and the cloud uplink collapse on one schedule."""
    eo = _edge_outage(r, m, n_edge, n_cloud, sys, rng)
    bc = _bw_collapse(r, m, n_edge, n_cloud, sys, rng)
    alive_e = np.asarray(eo.avail)[:, :n_edge].mean(axis=1)
    cloud_trace = np.asarray(bc.bw_mult)[:, 1]
    return ScenarioTrace(
        name="outage_collapse", onset=min(eo.onset, bc.onset),
        tier_ok=eo.tier_ok, avail=eo.avail, bw_mult=bc.bw_mult,
        bw_scale=_cap_frac(sys, alive_e, cloud_trace).astype(np.float32))


SCENARIOS = {
    "none": _none,
    "edge_outage": _edge_outage,
    "bw_collapse": _bw_collapse,
    "flash_crowd": _flash_crowd,
    "straggler_tail": _straggler_tail,
    "adversarial_u": _adversarial_u,
    "churn": _churn,
    "flash_churn": _flash_churn,
    "markov_bw": _markov_bw,
    "outage_collapse": _outage_collapse,
}


def compile_scenario(name: str, sys: SystemConfig, sim: SimConfig,
                     n_rounds: int | None = None,
                     seed: int = 0) -> ScenarioTrace:
    """Compile a named scenario into per-round arrays for one run shape."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {sorted(SCENARIOS)}")
    rng = np.random.default_rng(seed)
    r = n_rounds or sim.n_rounds
    return SCENARIOS[name](r, sim.n_tasks, sim.n_edge_servers,
                           sim.n_cloud_servers, sys, rng)


def apply_scenario(stream: Observation, trace: ScenarioTrace) -> Observation:
    """Merge a compiled trace into a round-stacked stream, on the stream's
    device: ``bw_mult`` composes with the stream's, ``u`` replaces it,
    the other fields attach.  The ``none`` trace returns the stream."""
    dev = stream.z.device
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    kw = {}
    if trace.bw_mult is not None:
        tm = t(trace.bw_mult, torch.float32)
        kw["bw_mult"] = tm if stream.bw_mult is None else stream.bw_mult * tm
    if trace.u is not None:
        kw["u"] = t(trace.u, torch.float32)
    for fld in ("tier_ok", "avail", "lat_mult", "bw_scale"):
        val = getattr(trace, fld)
        if val is not None:
            kw[fld] = t(val, torch.float32)
    if (trace.arrive_n is None) != (trace.depart is None):
        raise ValueError(
            f"scenario {trace.name!r} carries only one of arrive_n/depart; "
            f"a churn trace needs both")
    if trace.arrive_n is not None:
        kw["arrive_n"] = t(trace.arrive_n, torch.int32)
        kw["depart"] = t(trace.depart, torch.bool)
    if not kw:
        return stream
    return dataclasses.replace(stream, **kw)


# ---------------------------------------------------------------------------
# metrics + suite runner
# ---------------------------------------------------------------------------
def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scenario_metrics(mets, stream: Observation,
                     trace: ScenarioTrace) -> Dict[str, float]:
    """Scalar robustness metrics of one run's (R, M) outputs, on the host
    after the run: run means of cost / delay / accuracy, the SLA violation
    rate, ``sla_cost`` (cost + SLA_PENALTY·violations), ``cloud_frac`` and
    ``recovery_rounds`` (rounds after the onset until a round's mean cost
    is back within 1.1x of the pre-onset mean).  Churn runs average over
    alive lanes and add ``mean_alive``, ``max_queue_depth`` and
    ``dropped``."""
    acc = _host(mets["accuracy"])
    aq = _host(stream.aq)
    extra = {}
    if "alive" in mets:
        w = _host(mets["alive"]).astype(np.float64)            # (R, M)
        n_r = np.maximum(w.sum(axis=1), 1.0)
        n_tot = max(w.sum(), 1.0)
        cost_r = _host(mets["cost"]).sum(axis=1) / n_r         # (R,)
        viol = float(((acc < aq) * w).sum() / n_tot)
        delay = float(_host(mets["delay"]).sum() / n_tot)
        accuracy = float((acc * w).sum() / n_tot)
        cloud_frac = float((np.maximum(_host(mets["route"]), 0)
                            * w).sum() / n_tot)
        extra = {
            "mean_alive": float(w.sum(axis=1).mean()),
            "max_queue_depth": float(_host(mets["queue_depth"]).max()),
            "dropped": float(_host(mets["dropped"]).sum()),
        }
    else:
        cost_r = _host(mets["cost"]).mean(axis=1)              # (R,)
        viol = float((acc < aq).mean())
        delay = float(_host(mets["delay"]).mean())
        accuracy = float(acc.mean())
        cloud_frac = (float(_host(mets["route"]).mean())
                      if "route" in mets else float("nan"))
    out = {
        "cost": float(cost_r.mean()),
        "delay": delay,
        "accuracy": accuracy,
        "sla_violation_rate": viol,
        "sla_cost": float(cost_r.mean()) + SLA_PENALTY * viol,
        "cloud_frac": cloud_frac,
        **extra,
    }
    r = cost_r.shape[0]
    onset = trace.onset
    if onset is None or onset <= 0 or onset >= r:
        out["recovery_rounds"] = 0.0
        return out
    pre = cost_r[:onset].mean()
    recovered = np.nonzero(cost_r[onset:] <= 1.1 * pre)[0]
    out["recovery_rounds"] = float(recovered[0] if recovered.size
                                   else r - onset)
    return out


def run_scenario(policy, scenario, *, streams: int = 64, rounds: int = 30,
                 seed: int = 11, scenario_seed: int = 0,
                 sys: SystemConfig | None = None, force: str | None = None,
                 device="cuda", return_mets: bool = False):
    """Serve one policy through one scenario on ``device``.

    ``policy``: a registry name (``make_policy``) or a built Policy;
    ``scenario``: a registry name or a compiled :class:`ScenarioTrace`.
    Returns :func:`scenario_metrics` (and the (R, M) outputs with
    ``return_mets``)."""
    dev = resolve_device(device)
    sys = sys or SystemConfig()
    simc = SimConfig(n_tasks=streams, n_rounds=rounds, seed=seed,
                     bw_fluctuation=0.2)
    stream = Simulator(sys, simc, device=dev).sample_stream(rounds)
    trace = (scenario if isinstance(scenario, ScenarioTrace)
             else compile_scenario(scenario, sys, simc, rounds,
                                   seed=scenario_seed))
    degraded = apply_scenario(stream, trace)
    if isinstance(policy, str):
        policy = make_policy(policy, sys, device=dev)
    session = ServeSession(policy, streams, sim=simc, device=dev,
                           hedge=trace.hedge, admission=trace.admission,
                           force=force)
    mets = session.run(degraded)
    scalars = scenario_metrics(mets, degraded, trace)
    return (scalars, mets) if return_mets else scalars


def run_suite(policies=None, scenarios=None, *, streams: int = 64,
              rounds: int = 30, seed: int = 11, scenario_seed: int = 0,
              sys: SystemConfig | None = None, force: str | None = None,
              device="cuda") -> Dict[str, Dict[str, float]]:
    """Every policy × every scenario -> ``{"policy@scenario": metrics}``;
    by default the whole registry against ``SUITE``."""
    from repro_torch.serving.policy import POLICIES

    policies = sorted(POLICIES) if policies is None else list(policies)
    scenarios = list(SUITE) if scenarios is None else list(scenarios)
    rows = {}
    for s in scenarios:
        for p in policies:
            rows[f"{p}@{s}"] = run_scenario(
                p, s, streams=streams, rounds=rounds, seed=seed,
                scenario_seed=scenario_seed, sys=sys, force=force,
                device=device)
    return rows
