"""Routing-policy protocol, the four baselines and R2E-VID — port of
``repro/serving/policy.py`` (``Observation`` :78, ``capacity_budget`` :135,
``_argmin_feasible_jnp`` :161, the ``Policy`` base, the baselines :293-492,
``R2EVidPolicy`` :509-651, the registry :692-735).

A policy exposes ``init(n_streams) -> state`` and
``decide(state, obs) -> (state, sol)``; ``decide`` is ``decide_stream``
(the per-stream decision) followed by ``repair`` (the cross-task tail: the
C6 bandwidth budget for R2E-VID, the identity for the others).  Stateless
policies carry ``()``.  Every policy is a frozen dataclass holding its
tables on one device and a ``force`` pin that the session hands to the
kernels it runs.

  a2_cloud_only  cloud-pinned nominal argmin
  jcab           mid-ladder nominal, escalate on a miss
  rdap           plans against an EMA difficulty forecast (EMA in the carry)
  sniper         reuses the first round's profiled configs (table in carry)
  r2evid         gate mode (``gate_params``): gate → Stage-1 → warm CCG →
                 temporal consistency → C6; τ-proxy mode (no gate params):
                 cold CCG, difficulty as τ, consistency, C6; §4.4 ablations
                 ``use_stage1=False`` / ``use_stage2=False``.

``reset_streams``, ``pad_state`` and ``preseed_sharded`` (churn and
sharding) are ROADMAP queue A.10 and A.15.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.cost_model import SystemConfig, accuracy_at
from repro_torch.core.gating import GateConfig, init_gate_params
from repro_torch.core.lattice import BIG, DecisionLattice
from repro_torch.core.robust import RobustProblem, solve_ccg_fused
from repro_torch.core.router import (
    RouterConfig,
    RouterState,
    apply_temporal_consistency,
    clamp_route_available,
    enforce_bandwidth,
    init_router_state,
    route_segment,
)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Observation:
    """What one serving round exposes: (M,) / (M, d) / (2,) / (K,) fields,
    or the same with a leading round axis R for a whole run.  ``bw_mult``
    and ``u`` are realization inputs that no policy reads.  The scenario
    and churn fields of the reference must stay None here (ROADMAP queue
    A.9 and A.10)."""
    z: torch.Tensor                 # (..., M) content difficulty
    aq: torch.Tensor                # (..., M) accuracy requirements A^q
    dx: Any = None                  # (..., M, d) motion features (gate input)
    bw_mult: Any = None             # (..., 2) per-tier bandwidth fluctuation
    u: Any = None                   # (..., K) realized compute deviation
    tier_ok: Any = None             # (..., 2) per-tier availability (router)
    avail: Any = None               # (..., S) per-server availability
    lat_mult: Any = None            # (..., M, 2) hedged latency multipliers
    bw_scale: Any = None            # (...,) C6 budget scale
    arrive_n: Any = None            # (...,) stream arrivals (churn)
    depart: Any = None              # (..., M) per-slot departures (churn)

    @property
    def n_rounds(self) -> int:
        return self.z.shape[0]

    def round(self, i: int) -> "Observation":
        """Round ``i`` of a round-stacked stream."""
        return Observation(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name)[i]
            for f in dataclasses.fields(self)})


def capacity_budget(sys: SystemConfig, tier_ok=None, bw_scale=None):
    """The round's planning bandwidth budget (Mbps) from capacity telemetry,
    or None when none rides the observation (``total_bw_mbps`` applies)."""
    if bw_scale is not None:
        return torch.as_tensor(sys.total_bw_mbps, dtype=torch.float32,
                               device=bw_scale.device) * bw_scale
    if tier_ok is not None:
        cap = sys.edge_bw_mbps + sys.cloud_bw_mbps
        frac = (sys.edge_bw_mbps * (tier_ok[..., 0] > 0)
                + sys.cloud_bw_mbps * (tier_ok[..., 1] > 0)) / cap
        return torch.as_tensor(sys.total_bw_mbps, dtype=torch.float32,
                               device=tier_ok.device) * frac
    return None


def _argmin_feasible(lat: DecisionLattice, z, aq, *, force_route=None,
                     allowed_versions=None, tier_ok=None):
    """The nominal argmin of the baselines: the cheapest (y, v) whose
    accuracy clears A^q + the nominal margin, or the most accurate when none
    does.  ``force_route`` pins a tier, ``allowed_versions`` a version
    subset; ``tier_ok`` takes outaged tiers out of both.  Same ops in the
    same order as the reference, first index on ties."""
    sys = lat.sys
    f_flat = lat.accuracy_flat(z)                                 # (M, F, K)
    if tier_ok is not None:
        f_flat = torch.where(lat.tier_y_ok(tier_ok)[..., None] > 0, f_flat,
                             -BIG)
    total = lat.c1_flat[None, :, None] + lat.b2_flat[None]        # (1, F, K)
    feas = f_flat >= (aq + sys.acc_margin_nominal)[:, None, None]
    if force_route is not None:
        y_route, _, _ = lat.unflatten_index(
            torch.arange(lat.n_flat, device=lat.device))
        feas = feas & (y_route == force_route)[None, :, None]
    if allowed_versions is not None:
        mv = torch.zeros((sys.num_versions,), dtype=torch.bool,
                         device=lat.device)
        for v in allowed_versions:      # fills on the device, no host copy
            mv[v] = True
        feas = feas & mv[None, None, :]
    obj = torch.where(feas, total, BIG)
    flat = obj.reshape(obj.shape[0], -1)
    low, idx = flat.min(dim=1)
    # fall back to the max-accuracy config when nothing is feasible
    best_acc = f_flat.reshape(f_flat.shape[0], -1).argmax(dim=1)
    idx = torch.where(low >= BIG, best_acc, idx)
    route, r, p = lat.unflatten_index(idx // sys.num_versions)
    return {"route": route, "r": r, "p": p, "v": idx % sys.num_versions}


class Policy:
    """Base protocol: ``init``, ``decide_stream``, ``repair``, ``decide``.
    Subclasses hold their tables on one device (``device``) and a kernel
    pin (``force``)."""

    name: str = "policy"
    force: str = "auto"

    def init(self, n_streams: int):
        raise NotImplementedError

    def decide_stream(self, state, obs: Observation):
        raise NotImplementedError

    def repair(self, sol, z, aq, tier_ok=None, bw_scale=None, task_mask=None):
        """Cross-task tail on the whole batch; identity by default."""
        return sol

    def decide(self, state, obs: Observation):
        """One full round: per-stream decision + cross-task repair."""
        state, sol = self.decide_stream(state, obs)
        return state, self.repair(sol, obs.z, obs.aq, tier_ok=obs.tier_ok,
                                  bw_scale=obs.bw_scale)

    @property
    def lat(self) -> DecisionLattice:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.lat.device


# ---------------------------------------------------------------------------
# Baselines (paper §4.1.1)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class A2CloudOnlyPolicy(Policy):
    """A² — cloud-only joint model-and-data adaptation (stateless)."""
    _lat: DecisionLattice
    force: str = "auto"
    name = "a2_cloud_only"

    @property
    def lat(self):
        return self._lat

    def init(self, n_streams):
        return ()

    def decide_stream(self, state, obs):
        return state, _argmin_feasible(self._lat, obs.z, obs.aq,
                                       force_route=1, tier_ok=obs.tier_ok)


@dataclasses.dataclass(frozen=True)
class JCABPolicy(Policy):
    """JCAB — nominal single mid-ladder model, escalates the version only
    where the mid model misses the requirement (stateless)."""
    _lat: DecisionLattice
    force: str = "auto"
    name = "jcab"

    @property
    def lat(self):
        return self._lat

    def init(self, n_streams):
        return ()

    def decide_stream(self, state, obs):
        lat = self._lat
        z, aq = obs.z, obs.aq
        cfg = _argmin_feasible(lat, z, aq,
                               allowed_versions=[lat.sys.num_versions // 2],
                               tier_ok=obs.tier_ok)
        ok = accuracy_at(lat.sys, z, cfg["r"], cfg["p"], cfg["v"],
                         cfg["route"]) >= aq
        esc = _argmin_feasible(lat, z, aq, tier_ok=obs.tier_ok)
        return state, {k: torch.where(ok, cfg[k], esc[k]) for k in cfg}


class RDAPState(NamedTuple):
    z_ema: torch.Tensor    # (M,) last observed difficulty (the EMA input)
    has: torch.Tensor      # (M,) bool, False until the first round lands


@dataclasses.dataclass(frozen=True)
class RDAPPolicy(Policy):
    """RDAP — plans against an EMA difficulty forecast ẑ; the EMA memory is
    the carry."""
    _lat: DecisionLattice
    ema: float = 0.7
    force: str = "auto"
    name = "rdap"

    @property
    def lat(self):
        return self._lat

    def init(self, n_streams):
        dev = self.device
        return RDAPState(
            z_ema=torch.zeros((n_streams,), dtype=torch.float32, device=dev),
            has=torch.zeros((n_streams,), dtype=torch.bool, device=dev))

    def decide_stream(self, state, obs):
        z = obs.z
        # plans against the forecast; reality realizes obs.z.  The Python
        # scalars round to float32 before each product, as JAX's weak types
        z_hat = torch.where(state.has, self.ema * state.z_ema
                            + (1 - self.ema) * z, z)
        cfg = _argmin_feasible(self._lat, z_hat, obs.aq, tier_ok=obs.tier_ok)
        return RDAPState(z_ema=z.to(torch.float32),
                         has=torch.ones_like(state.has)), cfg


class SniperState(NamedTuple):
    key: torch.Tensor      # (n_profiles, 2) profiled (z, aq); +inf = empty
    route: torch.Tensor    # (n_profiles,) profiled configs, int64
    r: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    has: torch.Tensor      # () bool: profile table captured yet?
    warmup: torch.Tensor   # () bool: table preseeded (sharded runs, A.15)


_SNIPER_FIELDS = ("route", "r", "p", "v")


@dataclasses.dataclass(frozen=True)
class SniperPolicy(Policy):
    """Sniper — similarity-aware reuse of the first round's profiled
    configs; the profile table is the carry, written once in the first
    round (dense serving)."""
    _lat: DecisionLattice
    n_profiles: int = 8
    force: str = "auto"
    name = "sniper"

    @property
    def lat(self):
        return self._lat

    def init(self, n_streams):
        n, dev = self.n_profiles, self.device
        idx = lambda: torch.zeros((n,), dtype=torch.int64, device=dev)
        flag = lambda: torch.zeros((), dtype=torch.bool, device=dev)
        return SniperState(
            key=torch.full((n, 2), float("inf"), dtype=torch.float32,
                           device=dev),
            route=idx(), r=idx(), p=idx(), v=idx(), has=flag(),
            warmup=flag())

    def decide_stream(self, state, obs):
        z, aq = obs.z, obs.aq
        k = min(self.n_profiles, z.shape[0])
        fresh = _argmin_feasible(self._lat, z, aq, tier_ok=obs.tier_ok)
        key = torch.stack([z, aq], dim=1)                       # (M, 2)
        # the nearest profiled config; +inf keys keep empty rows unreachable
        d = ((key[:, None, :] - state.key[None]) ** 2).sum(-1)  # (M, n)
        d_min, nn = d.min(dim=1)
        far = d_min > 0.02                               # profile refresh
        use_table = state.has & ~state.warmup
        sol = {f: torch.where(use_table, torch.where(
            far, fresh[f], getattr(state, f)[nn]), fresh[f])
            for f in _SNIPER_FIELDS}
        if obs.tier_ok is not None:
            # a reused profile may point at a tier that has since died
            sol["route"] = clamp_route_available(sol["route"], obs.tier_ok)
        # first-round capture of the first k tasks, then the table freezes
        cap_key = state.key.clone()
        cap_key[:k] = key[:k]
        cap = {}
        for f in _SNIPER_FIELDS:
            cap[f] = getattr(state, f).clone()
            cap[f][:k] = fresh[f][:k]
        new = SniperState(
            key=torch.where(state.has, state.key, cap_key),
            **{f: torch.where(state.has, getattr(state, f), cap[f])
               for f in _SNIPER_FIELDS},
            has=torch.ones_like(state.has),
            warmup=torch.zeros_like(state.warmup))
        return new, sol


# ---------------------------------------------------------------------------
# R2E-VID
# ---------------------------------------------------------------------------
class HistoryState(NamedTuple):
    """τ-proxy carry: route/score history without a gate recurrence."""
    prev_route: torch.Tensor   # (M,) int64, -1 = no previous segment
    prev_tau: torch.Tensor     # (M,) float32


@dataclasses.dataclass(frozen=True)
class R2EVidPolicy(Policy):
    """Ours, in two modes plus the §4.4 ablations.

    * gate mode (``gate_params`` given): fused batched gate over ``obs.dx``,
      Stage-1, warm-started CCG, temporal consistency, C6 repair; the carry
      is :class:`RouterState`.
    * τ-proxy mode (``gate_params=None``): cold fused CCG, the difficulty
      as the gate-score proxy for temporal consistency, C6 repair; the carry
      is :class:`HistoryState`.  ``use_gate=False`` drops the consistency.

    Ablations: ``use_stage1=False`` pins a static mid (r, p) on edge with
    only the robust version choice; ``use_stage2=False`` keeps the adaptive
    config with a fixed mid-ladder version, nominal planning.  Both are
    stateless and skip the C6 repair.  ``force`` pins every kernel wrapper.
    """
    prob: RobustProblem
    gate_params: Any = None
    gate_cfg: GateConfig | None = None
    rcfg: RouterConfig = RouterConfig()
    use_gate: bool = True
    use_stage1: bool = True
    use_stage2: bool = True
    force: str = "auto"
    name = "r2evid"

    def __post_init__(self):
        # gate mode always runs the consistency constraint: refuse a
        # silently null no-gate ablation
        if not self.use_gate and self.gate_params is not None:
            raise ValueError("use_gate=False is the τ-proxy-mode ablation; "
                             "drop gate_params to run it")
        if self.gate_params is not None and self.gate_cfg is None:
            raise ValueError("gate mode needs gate_cfg with gate_params")

    @property
    def lat(self):
        return self.prob.lat

    @property
    def _full(self) -> bool:
        return self.use_stage1 and self.use_stage2

    def init(self, n_streams):
        if not self._full:
            return ()
        if self.gate_params is not None:
            return init_router_state(self.gate_cfg, n_streams, self.device)
        return HistoryState(
            prev_route=torch.full((n_streams,), -1, dtype=torch.int64,
                                  device=self.device),
            prev_tau=torch.zeros((n_streams,), dtype=torch.float32,
                                 device=self.device))

    def decide_stream(self, state, obs):
        lat = self.prob.lat
        sys = lat.sys
        z, aq = obs.z, obs.aq
        if not self.use_stage1:
            # static configuration on edge; robust version choice at it
            m = z.shape[0]
            fr, fp = sys.n_res // 2, sys.n_fps // 2
            fv = lat.accuracy(z)[:, fr, fp, :, 0]                 # (M, K)
            cost_v = lat.b2[fr, fp, :, 0] * (1.0 + lat.u_dev)     # (K,)
            feas = fv >= aq[:, None]
            v = torch.where(feas, cost_v[None], BIG).argmin(dim=1)
            v = torch.where(feas.any(dim=1), v, fv.argmax(dim=1))
            route = torch.zeros((m,), dtype=torch.int64, device=z.device)
            if obs.tier_ok is not None:
                route = clamp_route_available(route, obs.tier_ok)
            full = lambda x: torch.full((m,), x, dtype=torch.int64,
                                        device=z.device)
            return state, {"route": route, "r": full(fr), "p": full(fp),
                           "v": v}
        if not self.use_stage2:
            return state, _argmin_feasible(
                lat, z, aq, allowed_versions=[sys.num_versions // 2],
                tier_ok=obs.tier_ok)
        if self.gate_params is not None:
            new_gate, taus, sol = route_segment(
                self.prob, self.gate_cfg, self.gate_params, state, obs.dx,
                z, aq, self.rcfg, force=self.force, tier_ok=obs.tier_ok)
            return RouterState(prev_route=sol["route"], prev_tau=taus,
                               gate=new_gate), sol
        # τ-proxy mode: cold CCG, difficulty as the gate-score proxy
        sol = solve_ccg_fused(self.prob, z, aq, force=self.force,
                              tier_ok=obs.tier_ok)
        if self.use_gate:
            route = apply_temporal_consistency(
                sol["route"], state.prev_route, z, state.prev_tau, self.rcfg)
            if obs.tier_ok is not None:
                route = clamp_route_available(route, obs.tier_ok)
            sol = dict(sol, route=route, tau=z)
            state = HistoryState(prev_route=route, prev_tau=z)
        return state, sol

    def repair(self, sol, z, aq, tier_ok=None, bw_scale=None, task_mask=None):
        if not self._full:
            return sol
        sys = self.prob.lat.sys
        total_budget = capacity_budget(sys, tier_ok=tier_ok,
                                       bw_scale=bw_scale)
        sol, bw_hist = enforce_bandwidth(self.prob.lat, sol, z, aq,
                                         total_budget=total_budget,
                                         rounds=self.rcfg.repair_rounds,
                                         force=self.force,
                                         task_mask=task_mask)
        sol["bw_history"] = bw_hist
        return sol


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
POLICIES = {
    "a2_cloud_only": A2CloudOnlyPolicy,
    "jcab": JCABPolicy,
    "rdap": RDAPPolicy,
    "sniper": SniperPolicy,
    "r2evid": R2EVidPolicy,
}

# the display names of the paper's tables keep working
_ALIASES = {"A2": "a2_cloud_only", "JCAB": "jcab", "RDAP": "rdap",
            "Sniper": "sniper", "R2E-VID": "r2evid"}


def make_policy(name: str, sys: SystemConfig, *, device="cuda",
                generator: torch.Generator | None = None, **kw) -> Policy:
    """Build a registered policy by name (registry or display name) on
    ``device``.  ``kw`` goes to the policy (``force``, ``ema``,
    ``n_profiles``, ``gate_params``, ``gate_cfg``, ``use_stage1`` ...).
    For R2E-VID, ``generator`` (a seeded ``torch.Generator``) draws random
    gate parameters when ``gate_cfg`` is given without ``gate_params``;
    without either it serves in τ-proxy mode."""
    key = _ALIASES.get(name, name)
    if key not in POLICIES:
        raise KeyError(
            f"unknown policy {name!r}; registered: {sorted(POLICIES)}")
    dev = resolve_device(device)
    if key != "r2evid":
        if generator is not None:
            raise TypeError(f"policy {name!r} has no gate to draw")
        return POLICIES[key](DecisionLattice.build(sys, dev), **kw)
    if kw.get("gate_params") is None and generator is not None \
            and kw.get("gate_cfg") is not None:
        kw["gate_params"] = init_gate_params(kw["gate_cfg"], generator, dev)
    return R2EVidPolicy(prob=RobustProblem.build(sys, dev), **kw)
