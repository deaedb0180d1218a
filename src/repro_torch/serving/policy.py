"""Routing-policy protocol and R2E-VID in gate mode — port of
``repro/serving/policy.py`` (``Observation`` :78, ``capacity_budget`` :135,
the ``Policy`` base, ``R2EVidPolicy`` :509-651, ``make_policy``).

A policy exposes ``init(n_streams) -> state`` and
``decide(state, obs) -> (state, sol)``; ``decide`` is ``decide_stream``
(per-stream: gate → Stage-1 → CCG → temporal consistency) followed by
``repair`` (the cross-task C6 bandwidth budget).  The four baselines, the
τ-proxy mode and the ablations are ROADMAP queue A.8.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.cost_model import SystemConfig
from repro_torch.core.gating import GateConfig, init_gate_params
from repro_torch.core.robust import RobustProblem
from repro_torch.core.router import (
    RouterConfig,
    RouterState,
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


class Policy:
    """Base protocol: ``init``, ``decide_stream``, ``repair``, ``decide``."""

    name: str = "policy"

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
    def lat(self):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class R2EVidPolicy(Policy):
    """Ours, gate mode: fused batched gate over ``obs.dx``, Stage-1,
    warm-started CCG, temporal consistency, C6 repair; the carry is
    :class:`RouterState`.  ``force`` pins every kernel wrapper."""
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
        if self.gate_params is None or self.gate_cfg is None:
            raise NotImplementedError(
                "R2E-VID without gate params (the τ-proxy mode) is ROADMAP "
                "queue A.8; pass gate_params and gate_cfg")
        if not (self.use_gate and self.use_stage1 and self.use_stage2):
            raise NotImplementedError(
                "the §4.4 ablations are ROADMAP queue A.8")

    @property
    def lat(self):
        return self.prob.lat

    @property
    def device(self) -> torch.device:
        return self.prob.lat.device

    def init(self, n_streams):
        return init_router_state(self.gate_cfg, n_streams, self.device)

    def decide_stream(self, state, obs):
        if obs.tier_ok is not None:
            raise NotImplementedError(
                "tier_ok (scenario outages) is ROADMAP queue A.9")
        new_gate, taus, sol = route_segment(
            self.prob, self.gate_cfg, self.gate_params, state, obs.dx,
            obs.z, obs.aq, self.rcfg, force=self.force)
        new_state = RouterState(prev_route=sol["route"], prev_tau=taus,
                                gate=new_gate)
        return new_state, sol

    def repair(self, sol, z, aq, tier_ok=None, bw_scale=None, task_mask=None):
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


_ALIASES = {"R2E-VID": "r2evid"}
_BASELINES = ("a2_cloud_only", "jcab", "rdap", "sniper", "A2", "JCAB", "RDAP",
              "Sniper")


def make_policy(name: str, sys: SystemConfig, *, device="cuda",
                gate_cfg: GateConfig | None = None, gate_params=None,
                generator: torch.Generator | None = None, **kw) -> Policy:
    """Build a policy by name.  Only ``"r2evid"`` / ``"R2E-VID"`` in gate
    mode is ported; the baselines raise (ROADMAP queue A.8).

    ``gate_params`` (a dict of tensors) or ``generator`` (a seeded
    ``torch.Generator`` for :func:`init_gate_params`) supplies the gate."""
    dev = resolve_device(device)
    if name in _BASELINES:
        raise NotImplementedError(
            f"policy {name!r} is not ported yet (ROADMAP queue A.8)")
    if _ALIASES.get(name, name) != "r2evid":
        raise KeyError(f"unknown policy {name!r}; ported: ['r2evid']")
    if gate_params is None and generator is not None and gate_cfg is not None:
        gate_params = init_gate_params(gate_cfg, generator, dev)
    return R2EVidPolicy(prob=RobustProblem.build(sys, dev),
                        gate_params=gate_params, gate_cfg=gate_cfg, **kw)
