"""ServeSession: the serve driver — port of ``repro/serving/session.py``:
``__init__`` :572, ``reset``, ``step`` :705, ``run`` :717 with the round
body ``_serve_step`` / ``_serve_run`` :160/:169 and the scenario inputs of
``_realize_obs`` :143; slot-pool churn with SLA-aware admission
(``AdmissionConfig`` and ``_churn_admit`` :62-117, ``_churn_round`` and
``_serve_run_churn`` :180-231, ``_churn_init`` / ``_check_churn``
:636-662); and the live model pools (``dispatch``, ``feedback``,
``apply_feedback`` :870-972).

The reference runs the rounds under one ``lax.scan``; here ``run`` is a
Python loop over rounds, each of which launches its work on the policy's
device and never reads back to the host: the churn bookkeeping (alive,
degrade pins, queue, admitted, dropped) stays in device tensors across
rounds.  Mesh and finetune are later slices of the port (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serving.dispatch import DispatchExecutor, Request
from repro_torch.serving.policy import Observation, Policy, capacity_budget
from repro_torch.serving.simulator import SimConfig, realize_rounds

_MET_KEYS = ("delay", "energy", "cost", "accuracy")
_SOL_KEYS = ("route", "r", "p", "v", "tau")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """SLA-aware admission control for slot-pool (churn) runs.

    Each round, before the policy decides, new streams are admitted only
    while every admitted stream could still be served at minimum fidelity
    within the round's budget (``capacity_budget``, the number the C6
    repair plans against), the overflow queues up to ``max_queue`` and the
    rest is dropped.  Streams admitted while the budget is below
    ``degrade_frac`` of nominal serve at minimum fidelity (r = p = v = 0)
    for their lifetime in the pool."""
    max_queue: int = 64        # waiting arrivals carried across rounds
    margin: float = 0.05       # headroom fraction held back from the budget
    degrade_frac: float = 0.5  # budget/nominal below this => degrade mode
    init_alive: int | None = None   # slots occupied at round 0 (None = all)


def _churn_admit(alive, degr, queue, arrive_n, depart, budget, total_bw,
                 bw_floor, acfg: AdmissionConfig, valid):
    """One round of slot-pool bookkeeping and admission, on the device.

    Departures free their slots first; then up to ``cap - n_alive`` of the
    waiting streams (``queue`` + this round's ``arrive_n``) are admitted
    into the lowest-indexed free slots, ``cap`` being the largest pool whose
    minimum-fidelity draw (``bw_floor`` a stream) fits the budget less the
    margin: floor(budget·(1 − margin)/bw_floor) in float32, the reference's
    order (one ulp moves the cap by a whole stream).  ``valid`` masks the
    usable slots.  Returns ``(alive, degr, queue, newly, admitted,
    dropped)``; the counts are 0-d int32 tensors.
    """
    alive = alive & ~depart & valid
    n_alive = alive.sum(dtype=torch.int32)
    # a Python float meets a float32 tensor as a float32, as JAX's weak type
    cap = torch.floor(budget * (1.0 - acfg.margin) / bw_floor).to(
        torch.int32)
    cap = torch.clamp(cap, torch.zeros_like(cap), valid.sum(dtype=torch.int32))
    free = valid & ~alive
    want = queue + arrive_n
    can = torch.clamp(cap - n_alive, torch.zeros_like(cap),
                      free.sum(dtype=torch.int32))
    admitted = torch.minimum(want, can)
    backlog = want - admitted
    queue = torch.clamp_max(backlog, acfg.max_queue)
    dropped = backlog - queue
    rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32)
    newly = free & (rank <= admitted)
    scarce = budget < acfg.degrade_frac * total_bw
    # a freed slot sheds its degrade pin before re-admission
    degr = (degr & alive) | (newly & scarce)
    alive = alive | newly
    return alive, degr, queue, newly, admitted, dropped


def _round_output(sol, met):
    """The per-round output: deterministic metrics + the decisions."""
    out = {k: met[k] for k in _MET_KEYS}
    out.update({k: sol[k] for k in _SOL_KEYS if k in sol})
    return out


def _realize_obs(policy: Policy, obs: Observation, sol, n_edge: int,
                 n_cloud: int, hedge, task_mask=None):
    """The one realization call every round shares: the scenario's fault
    inputs (per-server availability, latency draws) ride on the
    observation; None fields realize the nominal round."""
    return realize_rounds(policy.lat, obs.z, obs.bw_mult, obs.u, sol["route"],
                          sol["r"], sol["p"], sol["v"], n_edge=n_edge,
                          n_cloud=n_cloud, force=policy.force,
                          avail=obs.avail, lat_mult=obs.lat_mult, hedge=hedge,
                          task_mask=task_mask)


def _serve_step(policy: Policy, state, obs: Observation, n_edge: int,
                n_cloud: int, hedge=None):
    """One round: decide (policy) then realize (simulator)."""
    state, sol = policy.decide(state, obs)
    met = _realize_obs(policy, obs, sol, n_edge, n_cloud, hedge)
    return state, _round_output(sol, met)


def _stack(outs):
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _serve_run(policy: Policy, state, obs_seq: Observation, n_edge: int,
               n_cloud: int, hedge=None):
    """R rounds of :func:`_serve_step`; outputs stacked to (R, M)."""
    outs = []
    for i in range(obs_seq.n_rounds):
        state, out = _serve_step(policy, state, obs_seq.round(i), n_edge,
                                 n_cloud, hedge)
        outs.append(out)
    return state, _stack(outs)


def _churn_round(policy: Policy, bw_floor, total_bw, acfg: AdmissionConfig,
                 n_edge: int, n_cloud: int, valid, carry, obs: Observation):
    """One slot-pool round: admission → reset of re-admitted slots →
    per-stream decision → degrade clamp → masked repair → masked
    realization.  ``carry`` is (policy state, alive, degr, queue)."""
    st, alive, degr, queue = carry
    budget = capacity_budget(policy.lat.sys, tier_ok=obs.tier_ok,
                             bw_scale=obs.bw_scale)
    budget = total_bw if budget is None else budget
    alive, degr, queue, newly, admitted, dropped = _churn_admit(
        alive, degr, queue, obs.arrive_n, obs.depart, budget, total_bw,
        bw_floor, acfg, valid)
    st = policy.reset_streams(st, newly)
    st, sol = policy.decide_stream(st, obs)
    # streams admitted under scarcity serve at minimum fidelity for their
    # lifetime in the pool (the contract their cap was computed against)
    sol = dict(sol, **{k: torch.where(degr, torch.zeros_like(sol[k]), sol[k])
                       for k in ("r", "p", "v")})
    sol = policy.repair(sol, obs.z, obs.aq, tier_ok=obs.tier_ok,
                        bw_scale=obs.bw_scale, task_mask=alive)
    met = _realize_obs(policy, obs, sol, n_edge, n_cloud, None,
                       task_mask=alive)
    out = _round_output(sol, met)
    out["route"] = met["route"]        # masked: -1 marks the dead slots
    out.update(alive=alive, queue_depth=queue, admitted=admitted,
               dropped=dropped)
    return (st, alive, degr, queue), out


def _serve_run_churn(policy: Policy, carry, obs_seq: Observation,
                     acfg: AdmissionConfig, n_edge: int, n_cloud: int):
    """:func:`_serve_run` on a fixed-capacity slot pool: the carry also
    holds the alive mask, the degrade pins and the queue depth, and the
    arrival / departure traces ride the stream."""
    lat = policy.lat
    # the per-stream minimum-fidelity draw the admission cap is computed
    # against: the worst tier's (r = 0, p = 0) draw
    bw_floor = lat.bw[0, 0, :].max()
    total_bw = torch.tensor(np.float32(lat.sys.total_bw_mbps),
                            device=lat.device)
    valid = torch.ones_like(carry[1])
    outs = []
    for i in range(obs_seq.n_rounds):
        carry, out = _churn_round(policy, bw_floor, total_bw, acfg, n_edge,
                                  n_cloud, valid, carry, obs_seq.round(i))
        outs.append(out)
    return carry, _stack(outs)


class ServeSession:
    """Owns the policy, the per-stream carry, the server pool sizes and,
    optionally, the live tier model ``pools`` ({tier: ModelPool}) that
    :meth:`dispatch` executes routed solutions on.

    The device is the policy's (``make_policy(..., device=...)``); a
    ``device`` given here must agree with it.  With no card and no
    ``device="cpu"`` the constructor raises.  ``hedge=(quantile, cost)``
    hedges stragglers in the realization (a stream with ``lat_mult``);
    ``admission=AdmissionConfig(...)`` makes ``n_streams`` a slot pool's
    capacity and ``run`` take ``arrive_n`` / ``depart`` traces; ``force``
    replaces the policy's kernel pin.
    """

    def __init__(self, policy: Policy, n_streams: int, *,
                 sim: SimConfig | None = None, n_edge: int | None = None,
                 n_cloud: int | None = None, device="cuda", state=None,
                 mesh=None, finetune=None, hedge=None, admission=None,
                 force: str | None = None, pools=None):
        for key, val, item in (("mesh", mesh, "A.15"),
                               ("finetune", finetune, "A.11")):
            if val is not None:
                raise NotImplementedError(
                    f"ServeSession({key}=...) is ROADMAP queue {item}")
        dev = resolve_device(device)
        if policy.device.type != dev.type:
            raise ValueError(f"ServeSession(device={device!r}) but the "
                             f"policy lives on {policy.device}")
        if force is not None:
            policy = dataclasses.replace(policy, force=force)
        if hedge is not None:
            hq, hc = hedge
            hedge = (float(hq), float(hc))
            if not 0.0 < hedge[0] < 1.0:
                raise ValueError(f"hedge quantile must be in (0, 1), "
                                 f"got {hedge[0]}")
        sim = sim or SimConfig()
        self.policy = policy
        self.n_streams = n_streams
        self.n_edge = sim.n_edge_servers if n_edge is None else n_edge
        self.n_cloud = sim.n_cloud_servers if n_cloud is None else n_cloud
        self.hedge = hedge
        self.admission = admission
        self.state = policy.init(n_streams) if state is None else state
        self._churn_carry = None
        self.pools = pools
        self._executor = None

    @property
    def sys_cfg(self):
        return self.policy.lat.sys

    def reset(self, n_streams: int | None = None):
        if n_streams is not None:
            self.n_streams = n_streams
        self.state = self.policy.init(self.n_streams)
        self._churn_carry = None

    def _churn_init(self):
        """Fresh slot-pool carry: the first ``init_alive`` slots occupied
        (all of them by default), no degrade pins, an empty queue."""
        m, dev = self.n_streams, self.policy.device
        k = m if self.admission.init_alive is None \
            else min(self.admission.init_alive, m)
        return (torch.arange(m, device=dev) < k,
                torch.zeros((m,), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))

    def _check_churn(self, stream: Observation) -> bool:
        """Whether ``stream`` drives churn; refuses the reference's
        unsupported pairings."""
        if (stream.arrive_n is None) != (stream.depart is None):
            raise ValueError(
                "churn needs BOTH arrive_n and depart on the stream "
                "(one without the other is almost certainly a trace bug)")
        has_churn = stream.arrive_n is not None
        if has_churn and self.admission is None:
            raise ValueError(
                "stream carries churn traces (arrive_n/depart) but the "
                "session has no AdmissionConfig — pass admission= to "
                "ServeSession")
        if has_churn and self.hedge is not None:
            raise ValueError(
                "hedged dispatch is not supported under churn (the hedge "
                "fair-share model has no alive-lane masking)")
        return has_churn

    def _check_obs(self, obs: Observation, rounds: bool):
        want = 2 if rounds else 1
        if obs.z.dim() != want:
            raise ValueError(f"Observation.z has rank {obs.z.dim()}; "
                             f"expected a {'round-stacked ' if rounds else ''}"
                             f"stream batch")
        if obs.z.shape[-1] != self.n_streams:
            raise ValueError(
                f"Observation carries {obs.z.shape[-1]} streams but the "
                f"session was sized for {self.n_streams}")
        if obs.u is None or obs.bw_mult is None:
            raise ValueError("serving needs bw_mult and u on the observation")

    def step(self, obs: Observation):
        """One serving round -> dict of (M,) metrics and decisions.  Churn
        runs through :meth:`run`."""
        self._check_obs(obs, rounds=False)
        if self._check_churn(obs):
            raise ValueError("churn traces (arrive_n/depart) are served by "
                             "ServeSession.run, not step")
        self.state, out = _serve_step(self.policy, self.state, obs,
                                      self.n_edge, self.n_cloud, self.hedge)
        return out

    def run(self, stream: Observation):
        """Serve R rounds; returns the per-round dict of (R, M) tensors
        (deterministic delay / energy / cost / accuracy + decisions + τ).
        A stream with churn traces runs the slot pool and also returns
        ``alive`` (R, M) and ``queue_depth`` / ``admitted`` / ``dropped``
        (R,); its ``route`` is -1 on dead slots."""
        self._check_obs(stream, rounds=True)
        if self._check_churn(stream):
            if self._churn_carry is None:
                self._churn_carry = self._churn_init()
            carry = (self.state, *self._churn_carry)
            (self.state, *churn), mets = _serve_run_churn(
                self.policy, carry, stream, self.admission, self.n_edge,
                self.n_cloud)
            self._churn_carry = tuple(churn)
            return mets
        self.state, mets = _serve_run(self.policy, self.state, stream,
                                      self.n_edge, self.n_cloud, self.hedge)
        return mets

    # -- live model pools ---------------------------------------------------
    def _make_executor(self):
        # slab sized for the largest fidelity the router can choose:
        # dispatch sizes prompts as 16·(1+r) with r < n_res
        return DispatchExecutor(self.pools,
                                max_prefill_len=16 * self.sys_cfg.n_res)

    @property
    def executor(self) -> DispatchExecutor:
        """The lazily built continuous-batching executor over the pools."""
        if self.pools is None:
            raise ValueError("session has no pools attached")
        if self._executor is None:
            self._executor = self._make_executor()
        return self._executor

    def dispatch(self, sol, decode_tokens: int = 8, serial: bool = False):
        """Execute a routed solution on the attached tier pools.

        Default: every routed segment becomes a :class:`Request` of
        ``16·(1+r_i)`` prompt tokens (its own fidelity) and the executor
        serves them; dead lanes (``route == -1``) are never enqueued.
        Returns {tier: stats dict} (``DispatchExecutor.serve``).

        ``serial=True`` is the reference's deprecated path, kept as its
        scheduling oracle: one prefill + decode per tier, every segment
        sized by the tier-mean fidelity.  Returns {tier: n_segments}.
        """
        if self.pools is None:
            raise ValueError("session has no pools attached")
        route = sol["route"].cpu().numpy()
        r = sol["r"].cpu().numpy()
        if serial:
            served = {}
            for tier in (0, 1):
                idx = np.where(route == tier)[0]
                if len(idx) == 0:
                    continue
                # token budget scales with chosen fidelity (resolution x fps)
                n_tok = 16 * (1 + int(r[idx].mean()))
                toks = np.ones((len(idx), n_tok), np.int32)
                self.pools[tier].serve_segment(toks,
                                               decode_tokens=decode_tokens)
                served[tier] = len(idx)
            return served

        reqs = []
        for i in range(route.shape[0]):
            tier = int(route[i])
            if tier < 0:        # churned / dead lane — never enqueued
                continue
            n_tok = 16 * (1 + int(r[i]))     # per-segment fidelity sizing
            vocab = self.pools[tier].cfg.vocab_size
            toks = (i * 131 + np.arange(n_tok)) % vocab
            reqs.append(Request(stream=i, tier=tier,
                                tokens=toks.astype(np.int32),
                                decode_tokens=decode_tokens))
        return self.executor.serve(reqs)

    def feedback(self):
        """The executor's measured per-tier serving state
        (``DispatchExecutor.feedback``)."""
        return self.executor.feedback()

    def apply_feedback(self, obs: Observation) -> Observation:
        """Fold the measured per-tier multiplier into an observation: on
        ``bw_mult`` (realization) and, capacity-weighted across the tiers,
        on ``bw_scale`` (the C6 repair's budget).  Pools that kept up leave
        the observation's values unchanged."""
        fb = self.feedback()
        dev = obs.z.device
        mult = torch.as_tensor(fb["bw_mult"][:2], dtype=torch.float32,
                               device=dev)
        sys = self.sys_cfg
        cap = sys.edge_bw_mbps + sys.cloud_bw_mbps
        scale = (sys.edge_bw_mbps * mult[0]
                 + sys.cloud_bw_mbps * mult[1]) / cap
        if obs.z.dim() >= 2:
            # round-stacked stream: the measured state is tiled per round
            r = obs.z.shape[0]
            mult_seq = torch.broadcast_to(mult, (r, 2))
            scale_seq = torch.broadcast_to(scale, (r,))
        else:
            mult_seq, scale_seq = mult, scale
        return dataclasses.replace(
            obs,
            bw_mult=mult_seq if obs.bw_mult is None else obs.bw_mult * mult,
            bw_scale=scale_seq if obs.bw_scale is None
            else obs.bw_scale * scale)
