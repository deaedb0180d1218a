"""ServeSession: the serve driver — port of ``repro/serving/session.py``:
``__init__`` :572, ``reset``, ``gate_params``, the decide-only ``route`` /
``route_many`` :625-660 (the reference's ``_decide_step`` / ``_decide_scan``
:131-141), ``step`` :705, ``run`` :717 with the round body ``_serve_step``
:160 and the scenario inputs of ``_realize_obs`` :143; slot-pool churn
with SLA-aware admission (``AdmissionConfig`` and ``_churn_admit``
:62-117, ``_churn_round`` :180, ``_churn_init`` / ``_check_churn``
:636-662); and the live model pools (``dispatch``, ``feedback``,
``apply_feedback`` :870-972).

The reference runs each run under one ``lax.scan`` (``_serve_run``,
``_decide_scan``, ``_serve_run_churn``), one compiled program.  Here every
run goes through a :class:`~repro_torch.serving.graphs.RoundGraph` of its
kind of round (serve, churn, finetune or decide): on the card it captures
the round once as a CUDA graph and replays it a round; with
``capture=False``, and on the CPU, it calls the same round function from
Python a round.  Either way no round reads back to the host: the churn
bookkeeping (alive, degrade pins, queue, admitted, dropped) and the
finetune's round counter stay in device tensors across rounds.

Online gate fine-tuning (``finetune=FinetuneConfig(...)``, the reference's
``_serve_run_finetune`` :233-282 and its wiring :606-619, :629-634,
:656-658, :749-756): every ``resync_period`` rounds of ``run`` take one
gradient step on the gate parameters, the BCE of τ against the round's SLA
misses plus a proximal anchor at the offline parameters, inside the round
(``_finetune_round``).

Stream-sharded serving (``run_sharded`` :762, ``run_elastic`` :808, the
round of ``_serve_run_sharded`` :285-525): one rank per device on
``torch.distributed``, the streams split over a ``DeviceMesh``'s
``"data"`` dim.  Every rank calls with the same full inputs and serves its
own slice (M padded to a multiple of the ranks with inert dummy streams)
through a round graph of the sharded kind (:func:`_sharded_round`).  The
cross-task tail runs gathered (the decisions all-gathered to the real M,
then ``Policy.repair`` and the realization, replicated: the dense run's
arithmetic) or hierarchical (``Policy.repair_local`` against the shard's
C6 sub-budget and a realization on the shard's slice of the server pool,
with only O(ranks) scalars exchanged a round).  The carry stays local; it
is gathered to the full M once, after the last round, as are the
hierarchical mode's per-task outputs.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.gating import batch_volatility
from repro_torch.device import resolve_device
from repro_torch.kernels.temporal_gate.ops import gate_cell_vjp
from repro_torch.serving.dispatch import DispatchExecutor, Request
from repro_torch.serving.graphs import RoundGraph, assign, signature
from repro_torch.serving.policy import Observation, Policy, capacity_budget
from repro_torch.serving.simulator import (
    SimConfig,
    clamp_route_by_avail,
    realize_rounds,
)
from repro_torch.serving.tree import tree_leaves, tree_map
from repro_torch.sharding import collectives
from repro_torch.sharding.collectives import (
    all_gather,
    psum,
    shard_count,
    shard_index,
)
from repro_torch.sharding.compat import pad_leading

_MET_KEYS = ("delay", "energy", "cost", "accuracy")
_SOL_KEYS = ("route", "r", "p", "v", "tau")


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """Online gate fine-tuning knobs (off unless passed to the session)."""
    lr: float = 1e-3
    resync_period: int = 4     # apply one gradient step every this many rounds
    mu: float = 0.1            # proximal anchor weight (catastrophic-forgetting guard)


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
                 n_cloud: int, hedge, task_mask=None, n_tier=None,
                 tier_frac=None):
    """The one realization call every round shares: the scenario's fault
    inputs (per-server availability, latency draws) ride on the
    observation; None fields realize the nominal round.  ``n_tier`` /
    ``tier_frac`` are the hierarchical sharded round's fleet-wide tier
    counts and alive fractions (partitioned server pools)."""
    return realize_rounds(policy.lat, obs.z, obs.bw_mult, obs.u, sol["route"],
                          sol["r"], sol["p"], sol["v"], n_edge=n_edge,
                          n_cloud=n_cloud, force=policy.force,
                          avail=obs.avail, lat_mult=obs.lat_mult, hedge=hedge,
                          task_mask=task_mask, n_tier=n_tier,
                          tier_frac=tier_frac)


def _serve_step(policy: Policy, state, obs: Observation, n_edge: int,
                n_cloud: int, hedge=None):
    """One round: decide (policy) then realize (simulator)."""
    state, sol = policy.decide(state, obs)
    met = _realize_obs(policy, obs, sol, n_edge, n_cloud, hedge)
    return state, _round_output(sol, met)


def _flat_params(params: dict):
    """One flat float32 copy of the gate parameters, in the dict's order,
    and a dict of views of it shaped as ``params`` (the finetune round
    updates all of them with a few elementwise ops on the flat tensor)."""
    flat = torch.cat([v.detach().reshape(-1) for v in params.values()])
    views = flat.split([v.numel() for v in params.values()])
    return flat, {k: t.view(v.shape)
                  for (k, v), t in zip(params.items(), views)}


def _finetune_round(policy: Policy, n_edge: int, n_cloud: int, hedge,
                    ft: FinetuneConfig, params, anchor, carry,
                    obs: Observation):
    """One serving round that also tunes the gate (the body of the
    reference's ``_serve_run_finetune``).  ``carry`` is (policy state,
    rounds done: a 0-d int64 tensor on the device); ``params`` is the flat
    tensor whose views (``_flat_params``, in their dict's order) are
    ``policy.gate_params``, ``anchor`` the offline parameters in the same
    layout.

    The round decides and realizes as :func:`_serve_step`; on every
    ``ft.resync_period``-th round it then takes one SGD step on the BCE of
    the round's τ against its SLA misses (accuracy < aq) plus μ/2·‖θ −
    θ_offline‖².  The gradient is truncated to this round's gate cell: its
    inputs are this round's dx, the carried hidden state before the round
    (the carry is written back only after the round) and the volatility the
    step fed the cell (:func:`~repro_torch.core.gating.batch_volatility` of
    the new state's sums), and ``gate_cell_vjp`` takes dτ of the BCE (the
    backward kernel on the card).  The parameters are updated in place (a
    round graph reads them by address): every round computes the step and
    keeps it or the old values with ``torch.where`` on the device counter,
    so a round without an update leaves them bit-unchanged and no round
    reads back to the host."""
    st, done = carry
    p = policy.gate_params
    h_prev = st.gate.h
    new_st, sol = policy.decide(st, obs)
    met = _realize_obs(policy, obs, sol, n_edge, n_cloud, hedge)
    fail = (met["accuracy"] < obs.aq).to(torch.float32)        # SLA misses
    tau = sol["tau"]
    eps = 1e-6
    # d/dτ of −mean(fail·log(τ + ε) + (1 − fail)·log(1 − τ + ε))
    dtau = ((1.0 - fail) / (1.0 - tau + eps) - fail / (tau + eps)) \
        / tau.shape[0]
    vol = batch_volatility(policy.gate_cfg, new_st.gate.var_sum,
                           new_st.gate.var_sumsq)
    grads, _ = gate_cell_vjp(obs.dx, h_prev, vol, p, dtau=dtau,
                             need_dh=False, force=policy.force)
    grad = torch.cat([grads[k].reshape(-1) for k in p])
    step = params - ft.lr * (grad + ft.mu * (params - anchor))
    params.copy_(torch.where((done + 1) % ft.resync_period == 0, step,
                             params))
    return (new_st, done + 1), _round_output(sol, met)


def _zero_fidelity(sol, pinned):
    """``sol`` with r = p = v = 0 where ``pinned`` (degraded slots)."""
    return dict(sol, **{k: torch.where(pinned, torch.zeros_like(sol[k]),
                                       sol[k]) for k in ("r", "p", "v")})


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
    sol = _zero_fidelity(sol, degr)
    sol = policy.repair(sol, obs.z, obs.aq, tier_ok=obs.tier_ok,
                        bw_scale=obs.bw_scale, task_mask=alive)
    met = _realize_obs(policy, obs, sol, n_edge, n_cloud, None,
                       task_mask=alive)
    out = _round_output(sol, met)
    out["route"] = met["route"]        # masked: -1 marks the dead slots
    out.update(alive=alive, queue_depth=queue, admitted=admitted,
               dropped=dropped)
    return (st, alive, degr, queue), out


def _churn_consts(policy: Policy, alive):
    """The round-invariant operands of :func:`_churn_round`, made on the
    device once a round graph: the per-stream minimum-fidelity
    draw the admission cap is computed against (the worst tier's (r = 0,
    p = 0) draw), the nominal budget as a 0-d float32 tensor (a fill, not
    a copy from the host) and the all-valid slot mask."""
    lat = policy.lat
    return (lat.bw[0, 0, :].max(),
            torch.full((), lat.sys.total_bw_mbps, dtype=torch.float32,
                       device=lat.device),
            torch.ones_like(alive))


def _slice_rounds(stream: Observation, start: int, stop: int) -> Observation:
    """Rounds ``start:stop`` of a round-stacked stream (views)."""
    return Observation(**{f.name: None if getattr(stream, f.name) is None
                          else getattr(stream, f.name)[start:stop]
                          for f in dataclasses.fields(stream)})


@dataclasses.dataclass(frozen=True)
class _ShardPlan:
    """What a sharded round graph is built for: the mesh dim and this
    rank's slice of the streams, the tail mode, the pools (whole, and this
    rank's slice of each in hierarchical mode), and the round-invariant
    device tensors (the padded and the local valid-slot masks; under churn
    the admission's minimum-fidelity draw and nominal budget)."""
    mesh: DeviceMesh
    axis: str
    index: int            # this rank's shard
    m: int                # real streams
    pad: int              # dummy streams appended
    m_l: int              # streams a shard
    hierarchical: bool
    n_edge: int
    n_cloud: int
    hedge: tuple | None
    acfg: AdmissionConfig | None
    valid: torch.Tensor   # (m + pad,) bool: real slots
    bw_floor: torch.Tensor
    total_bw: torch.Tensor

    @classmethod
    def build(cls, policy: Policy, mesh, axis: str, m: int, *, n_edge: int,
              n_cloud: int, hedge, acfg, hierarchical: bool) -> "_ShardPlan":
        n_dev = shard_count(mesh, axis)
        pad = (-m) % n_dev
        dev = policy.device
        valid = torch.arange(m + pad, device=dev) < m
        bw_floor, total_bw, _ = _churn_consts(policy, valid)
        return cls(mesh=mesh, axis=axis, index=shard_index(mesh, axis), m=m,
                   pad=pad, m_l=(m + pad) // n_dev, hierarchical=hierarchical,
                   n_edge=n_edge, n_cloud=n_cloud, hedge=hedge, acfg=acfg,
                   valid=valid, bw_floor=bw_floor, total_bw=total_bw)

    @property
    def n_dev(self) -> int:
        return (self.m + self.pad) // self.m_l

    @property
    def local(self) -> slice:
        """This rank's streams in the padded batch."""
        return slice(self.index * self.m_l, (self.index + 1) * self.m_l)

    def shard(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's slice of the padded ``x`` along ``axis``."""
        return pad_leading(x, self.pad, axis=axis).narrow(
            axis, self.index * self.m_l, self.m_l)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The real-M batch from every rank's (m_l, ...) slice."""
        return all_gather(x, self.mesh, self.axis)[:self.m]


def _shard_stream(stream: Observation, plan: _ShardPlan) -> Observation:
    """The round-stacked stream a rank's sharded round reads: its slice of
    the per-stream fields (z, aq, dx; lat_mult in hierarchical mode, which
    the gathered mode realizes on the real batch), the departures padded
    for the replicated admission, the rest replicated."""
    per_rank = lambda x: None if x is None else plan.shard(x, axis=1)
    return dataclasses.replace(
        stream, z=per_rank(stream.z), aq=per_rank(stream.aq),
        dx=per_rank(stream.dx),
        lat_mult=per_rank(stream.lat_mult) if plan.hierarchical
        else stream.lat_mult,
        depart=None if stream.depart is None
        else pad_leading(stream.depart, plan.pad, axis=1))


def _sharded_round(policy: Policy, plan: _ShardPlan, carry,
                   obs: Observation):
    """One round of a rank's slice of a sharded run (the body of the
    reference's ``_serve_run_sharded``).  ``carry`` is the rank's policy
    state, with the slot pool's replicated (alive, degr, queue) at padded
    width under churn; ``obs`` the rank's round (:func:`_shard_stream`).

    Under churn the admission runs replicated over the padded pool (the
    dummy slots are never valid) and only this rank's slice of the reset
    mask touches its carry.  The per-stream decision runs on the slice;
    then the gathered tail (z, aq and the decisions all-gathered to the
    real M, ``repair`` and the realization replicated) or the hierarchical
    one (``repair_local`` against the shard's C6 target, the realization on
    the shard's ``n_edge / D`` edge and ``n_cloud / D`` cloud servers and
    its slice of ``avail``, the fleet's tier counts as one 2-int ``psum``
    and its tier alive fractions from the replicated ``avail``)."""
    with collectives.in_round():
        return _sharded_round_body(policy, plan, carry, obs)


def _sharded_round_body(policy: Policy, plan: _ShardPlan, carry,
                        obs: Observation):
    local = plan.local
    churn = plan.acfg is not None
    task_mask = None
    churn_out = {}
    st = carry
    if churn:
        st, alive, degr, queue = carry
        budget = capacity_budget(policy.lat.sys, tier_ok=obs.tier_ok,
                                 bw_scale=obs.bw_scale)
        budget = plan.total_bw if budget is None else budget
        alive, degr, queue, newly, admitted, dropped = _churn_admit(
            alive, degr, queue, obs.arrive_n, obs.depart, budget,
            plan.total_bw, plan.bw_floor, plan.acfg, plan.valid)
        st = policy.reset_streams(st, newly[local])
        task_mask = alive[:plan.m]
        churn_out = dict(queue_depth=queue, admitted=admitted,
                         dropped=dropped)
    st, sol = policy.decide_stream(st, Observation(
        z=obs.z, aq=obs.aq, dx=obs.dx, tier_ok=obs.tier_ok))
    new_carry = (st, alive, degr, queue) if churn else st

    if plan.hierarchical:
        mask_l = alive[local] if churn else plan.valid[local]
        if churn:
            sol = _zero_fidelity(sol, degr[local])
        sol = policy.repair_local(sol, obs.z, obs.aq, mesh=plan.mesh,
                                  mesh_axis=plan.axis, tier_ok=obs.tier_ok,
                                  bw_scale=obs.bw_scale, task_mask=mask_l)
        e_l, c_l = plan.n_edge // plan.n_dev, plan.n_cloud // plan.n_dev
        avail_l = tier_frac = None
        route_c = sol["route"]
        if obs.avail is not None:
            # this shard's statically partitioned slice of the pool
            i, av = plan.index, obs.avail
            avail_l = torch.cat([av[i * e_l:(i + 1) * e_l],
                                 av[plan.n_edge + i * c_l:
                                    plan.n_edge + (i + 1) * c_l]])
            route_c = clamp_route_by_avail(route_c, avail_l, e_l, c_l)
            tier_frac = torch.stack([av[:plan.n_edge].sum() / plan.n_edge,
                                     av[plan.n_edge:].sum() / plan.n_cloud])
        # the fleet's tier counts: one psum of two ints a shard
        n_cloud_l = (route_c * mask_l).sum()
        n_tier = psum(torch.stack([mask_l.sum() - n_cloud_l, n_cloud_l]),
                      plan.mesh, plan.axis)
        met = _realize_obs(policy, dataclasses.replace(obs, avail=avail_l),
                           sol, e_l, c_l, None, task_mask=mask_l,
                           n_tier=n_tier, tier_frac=tier_frac)
        out = _round_output(sol, met)
        if churn:
            out.update(route=met["route"], alive=mask_l, **churn_out)
        return new_carry, out

    # gathered: the real batch on every rank, the dense round's arithmetic
    z_g, aq_g = plan.gather(obs.z), plan.gather(obs.aq)
    sol_g = {k: plan.gather(sol[k]) for k in _SOL_KEYS if k in sol}
    if churn:
        sol_g = _zero_fidelity(sol_g, degr[:plan.m])
    sol_g = policy.repair(sol_g, z_g, aq_g, tier_ok=obs.tier_ok,
                          bw_scale=obs.bw_scale, task_mask=task_mask)
    met = _realize_obs(policy, dataclasses.replace(obs, z=z_g, aq=aq_g),
                       sol_g, plan.n_edge, plan.n_cloud, plan.hedge,
                       task_mask=task_mask)
    out = _round_output(sol_g, met)
    if churn:
        out.update(route=met["route"], alive=task_mask, **churn_out)
    return new_carry, out


def _check_mesh(mesh, axis: str) -> None:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has dims {mesh.mesh_dim_names}, no "
                         f"{axis!r} to shard the streams over")


def _one_round(obs: Observation) -> Observation:
    """One round's observation as a round-stacked stream of length 1."""
    return Observation(**{f.name: None if getattr(obs, f.name) is None
                          else getattr(obs, f.name).unsqueeze(0)
                          for f in dataclasses.fields(obs)})


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

    ``finetune=FinetuneConfig(...)`` (gate-mode R2E-VID only) tunes the
    gate while ``run`` serves.  The session takes its own copy of the gate
    parameters (the caller's are never written) and a copy as the proximal
    anchor; the tuning updates its copy in place, which ``gate_params``
    returns and every later round reads.  The count of tuned rounds
    persists across runs and :meth:`reset` zeroes it, keeping the tuned
    parameters; :meth:`step`, ``route`` and ``route_many`` neither tune nor
    count.

    ``capture`` pins how rounds run, as ``force`` pins the kernels: each
    kind of round runs through one
    :class:`~repro_torch.serving.graphs.RoundGraph`, which captures it as
    a CUDA graph and replays it when ``capture`` is true (the default on
    the card: None means "on CUDA") and calls the same round function a
    round when it is false (the default on the CPU, which cannot capture).
    A graph holds the session's carry by address: :meth:`reset` refills it
    in place, and a carry assigned to ``state`` from outside is adopted
    anew (copied) by the next run.

    ``mesh`` (a ``torch.distributed`` ``DeviceMesh``) makes :meth:`run`
    serve stream-sharded over its ``mesh_axis`` dim (:meth:`run_sharded`),
    in the gathered mode or, with ``hierarchical=True``, the hierarchical
    one.  A sharded round is captured when the mesh's backend is NCCL
    (``capture=None``); over gloo it runs uncaptured, and ``capture=True``
    there raises.
    """

    def __init__(self, policy: Policy, n_streams: int, *,
                 sim: SimConfig | None = None, n_edge: int | None = None,
                 n_cloud: int | None = None, device="cuda", state=None,
                 mesh=None, mesh_axis: str = "data",
                 hierarchical: bool = False, finetune=None, hedge=None,
                 admission=None, force: str | None = None, pools=None,
                 capture: bool | None = None):
        if mesh is not None:
            _check_mesh(mesh, mesh_axis)
        dev = resolve_device(device)
        if policy.device.type != dev.type:
            raise ValueError(f"ServeSession(device={device!r}) but the "
                             f"policy lives on {policy.device}")
        if capture not in (None, True, False):
            raise ValueError(f"capture must be None, True or False, got "
                             f"{capture!r}")
        self._capture_arg = capture
        if capture is None:
            capture = dev.type == "cuda"
        elif capture and dev.type != "cuda":
            raise ValueError(f"capture=True needs the card; a session on "
                             f"{dev} runs its rounds uncaptured")
        if force is not None:
            policy = dataclasses.replace(policy, force=force)
        self._params = self._anchor = None
        if finetune is not None:
            if getattr(policy, "gate_params", None) is None:
                raise ValueError(
                    "finetune requires a gate-mode r2evid policy "
                    "(gate_params must be set)")
            # the session tunes its own copy in place, one flat tensor that
            # the policy's parameters view; the proximal anchor is the
            # offline parameters at session start
            self._params, params = _flat_params(policy.gate_params)
            self._anchor = self._params.clone()
            policy = dataclasses.replace(policy, gate_params=params)
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
        self.finetune = finetune
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.hierarchical = hierarchical
        self.capture = capture
        self.state = policy.init(n_streams) if state is None else state
        self._churn_carry = None
        # rounds served by finetune runs (the tuning cadence's counter)
        self._rounds_done = torch.zeros((), dtype=torch.int64,
                                        device=policy.device)
        self.graphs = {}            # (kind, stream signature) -> RoundGraph
        self._plans = {}            # sharded graph key -> its _ShardPlan
        self.pools = pools
        self._executor = None

    @property
    def sys_cfg(self):
        return self.policy.lat.sys

    @property
    def gate_params(self):
        """The gate-mode policy's gate parameters (None for the others)."""
        return getattr(self.policy, "gate_params", None)

    def reset(self, n_streams: int | None = None):
        """A fresh carry (an empty slot pool, a zero finetune round count;
        tuned gate parameters stay).  A carry that the session's graphs
        hold is refilled in place, so they stay valid; any other (one no
        run has adopted yet) is replaced.  A new size drops the graphs."""
        if n_streams is not None and n_streams != self.n_streams:
            self.n_streams = n_streams
            self.graphs.clear()
            self._plans.clear()
        held = self._held()
        fresh = self.policy.init(self.n_streams)
        old = tree_leaves(self.state)
        if all(id(t) in held for t in old):
            assign(old, tree_leaves(fresh))
        else:
            self.state = fresh
        if self._churn_carry is not None:
            if all(id(t) in held for t in self._churn_carry):
                assign(list(self._churn_carry), list(self._churn_init()))
            else:
                self._churn_carry = None
        if id(self._rounds_done) in held:
            self._rounds_done.zero_()
        else:
            self._rounds_done = torch.zeros_like(self._rounds_done)

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
        if has_churn and self.finetune is not None:
            raise NotImplementedError(
                "online fine-tuning under stream churn is not supported")
        if has_churn and self.hedge is not None:
            raise ValueError(
                "hedged dispatch is not supported under churn (the hedge "
                "fair-share model has no alive-lane masking)")
        return has_churn

    def _check_obs(self, obs: Observation, rounds: bool):
        want = (2, 3) if rounds else (1, 2)
        if obs.z.dim() not in want:
            raise ValueError(f"Observation.z has rank {obs.z.dim()}; "
                             f"expected a {'round-stacked ' if rounds else ''}"
                             f"stream batch")
        if obs.z.shape[-1] != self.n_streams:
            raise ValueError(
                f"Observation carries {obs.z.shape[-1]} streams but the "
                f"session was sized for {self.n_streams}")

    # -- the round graphs ---------------------------------------------------
    def _carry(self, kind: str):
        """The carry a kind of round reads and updates: the policy state,
        with the slot pool's (alive, degrade pins, queue) under churn and
        the round count under finetune."""
        if kind == "finetune":
            return (self.state, self._rounds_done)
        if kind != "churn":
            return self.state
        if self._churn_carry is None:
            self._churn_carry = self._churn_init()
        return (self.state, *self._churn_carry)

    def _step(self, kind: str):
        """``step(carry, obs) -> (carry, out)`` of a kind of round: the
        function a graph captures, or calls a round uncaptured."""
        pol = self.policy
        if kind == "decide":
            return pol.decide
        if kind == "serve":
            # no reference back to the session: a graph that the session
            # holds and that holds the session would be freed by the cyclic
            # collector at any moment, a capture of another graph included
            n_edge, n_cloud, hedge = self.n_edge, self.n_cloud, self.hedge
            return lambda st, obs: _serve_step(pol, st, obs, n_edge, n_cloud,
                                               hedge)
        if kind == "finetune":
            return functools.partial(_finetune_round, pol, self.n_edge,
                                     self.n_cloud, self.hedge, self.finetune,
                                     self._params, self._anchor)
        bw_floor, total_bw, valid = _churn_consts(pol, self._churn_carry[0])
        return functools.partial(_churn_round, pol, bw_floor, total_bw,
                                 self.admission, self.n_edge, self.n_cloud,
                                 valid)

    def _held(self) -> set:
        """The ids of the carry tensors the session's graphs hold."""
        return {id(t) for g in self.graphs.values() for t in g.leaves}

    def _rounds(self, kind: str, stream: Observation) -> dict:
        """Serve a round-stacked stream through the session's graph of
        this kind of round, making one first where there is none for this
        stream's fields and shapes, or only a shorter one, or one on a
        carry the session no longer holds.  A new graph gets carry tensors
        of its own: each tensor no graph holds yet is copied, so the
        rounds' in-place writes reach no tensor of the caller's."""
        carry = self._carry(kind)
        key = (kind, signature(stream))
        graph = self.graphs.get(key)
        if graph is None or graph.capacity < stream.n_rounds or \
                not graph.holds(carry):
            held = self._held()
            mine = lambda t: t if id(t) in held else t.clone()
            self.state = tree_map(mine, self.state)
            if self._churn_carry is not None:
                self._churn_carry = tuple(map(mine, self._churn_carry))
            self._rounds_done = mine(self._rounds_done)
            carry = self._carry(kind)
            graph = RoundGraph(self._step(kind), carry, stream,
                               capture=self.capture)
            out = graph.run(stream)     # a failed capture raises here
            self.graphs[key] = graph
            return out
        return graph.run(stream)

    # -- decide-only paths --------------------------------------------------
    def route(self, obs: Observation):
        """Route one segment batch (no realization): the solution."""
        return {k: v[0] for k, v in
                self._rounds("decide", _one_round(obs)).items()}

    def route_many(self, dx_seq, difficulty, acc_req):
        """Route S segment batches in one run of the decide round.

        dx_seq: (S, M, d) (or None for gate-free policies); difficulty /
        acc_req: (M,) or (S, M).  Returns the stacked solutions."""
        if dx_seq is not None:
            s = dx_seq.shape[0]
        elif difficulty.dim() > 1:
            s = difficulty.shape[0]
        else:
            raise ValueError(
                "route_many cannot infer the segment count: pass dx_seq or "
                "round-stacked (S, M) difficulty/acc_req")
        if difficulty.dim() == 1:
            difficulty = torch.broadcast_to(difficulty,
                                            (s,) + difficulty.shape)
        if acc_req.dim() == 1:
            acc_req = torch.broadcast_to(acc_req, (s,) + acc_req.shape)
        return self._rounds("decide", Observation(z=difficulty, aq=acc_req,
                                                  dx=dx_seq))

    # -- serve (decide + realize) ------------------------------------------
    def step(self, obs: Observation):
        """One serving round -> dict of (M,) metrics and decisions; without
        ``bw_mult``/``u`` on the observation this is :meth:`route`.  Churn
        runs through :meth:`run`."""
        self._check_obs(obs, rounds=False)
        if obs.u is None or obs.bw_mult is None:
            return self.route(obs)
        if self._check_churn(obs):
            raise ValueError("churn traces (arrive_n/depart) are served by "
                             "ServeSession.run, not step")
        return {k: v[0] for k, v in
                self._rounds("serve", _one_round(obs)).items()}

    def run(self, stream: Observation, n_rounds: int | None = None,
            mesh=None, mesh_axis: str | None = None):
        """Serve R rounds; returns the per-round dict of (R, M) tensors
        (deterministic delay / energy / cost / accuracy + decisions + τ).
        ``n_rounds`` serves a prefix.  A stream with churn traces runs the
        slot pool and also returns ``alive`` (R, M) and ``queue_depth`` /
        ``admitted`` / ``dropped`` (R,); its ``route`` is -1 on dead
        slots.  A finetune session tunes the gate as it serves.  With a
        mesh (here or the session's) the run is :meth:`run_sharded`."""
        self._check_obs(stream, rounds=True)
        if stream.u is None or stream.bw_mult is None:
            raise ValueError("session.run needs bw_mult and u on the stream "
                             "(use route_many for decide-only scans)")
        if n_rounds is not None:
            stream = _slice_rounds(stream, 0, n_rounds)
        mesh = self.mesh if mesh is None else mesh
        if mesh is not None:
            return self.run_sharded(mesh, stream,
                                    mesh_axis=mesh_axis or self.mesh_axis)
        if self._check_churn(stream):
            return self._rounds("churn", stream)
        return self._rounds("serve" if self.finetune is None else "finetune",
                            stream)

    # -- stream-sharded serving ---------------------------------------------
    def _sharded_capture(self, mesh, axis: str) -> bool:
        """Whether sharded rounds over ``mesh`` are captured: on NCCL by
        default, never on gloo (its collectives go through the host)."""
        nccl = dist.get_backend(mesh.get_group(axis)) == "nccl"
        if nccl and self.policy.device.type != "cuda":
            raise ValueError(f"an NCCL mesh exchanges CUDA tensors; the "
                             f"session is on {self.policy.device}")
        if self._capture_arg and not nccl:
            raise ValueError(
                "capture=True needs an NCCL mesh: a round over gloo stages "
                "its collectives through the host, which a CUDA graph "
                "cannot hold (gloo rounds run uncaptured)")
        return nccl if self._capture_arg is None else self._capture_arg

    def _local_carry(self, plan: _ShardPlan, local: Observation,
                     has_churn: bool):
        """This rank's carry at the start of a sharded run: its slice of
        the padded per-stream state, or the whole replicated state
        preseeded from the gathered round 0; under churn with the slot
        pool padded to the padded width."""
        pol = self.policy
        if pol.state_replicated:
            # the one O(M) gather of a replicated carry, before the rounds
            st = pol.preseed_sharded(
                self.state, plan.gather(local.z[0]), plan.gather(local.aq[0]),
                tier_ok=None if local.tier_ok is None else local.tier_ok[0])
        else:
            st = tree_map(lambda x: x[plan.local],
                          pol.pad_state(self.state, plan.pad))
        if not has_churn:
            return st
        if self._churn_carry is None:
            self._churn_carry = self._churn_init()
        alive, degr, queue = self._churn_carry
        return (st, pad_leading(alive, plan.pad),
                pad_leading(degr, plan.pad), queue)

    def run_sharded(self, mesh, stream: Observation,
                    n_rounds: int | None = None, mesh_axis: str = "data",
                    hierarchical: bool | None = None):
        """The run with the streams split over ``mesh_axis`` of ``mesh``
        (one rank per device; every rank calls with the same full stream).

        The gathered mode (default, or the session's ``hierarchical``) gives
        the dense :meth:`run`'s metrics and final carry, for any M.
        ``hierarchical=True`` repairs and realizes each shard on its own
        (exact C6, queueing on the shard's slice of the pools; ``n_edge``
        and ``n_cloud`` must divide by the shard count; no hedge).  Every
        rank returns the full (R, M) outputs, and ``state`` holds the full
        carry after the run."""
        self._check_obs(stream, rounds=True)
        _check_mesh(mesh, mesh_axis)
        if hierarchical is None:
            hierarchical = self.hierarchical
        if stream.u is None or stream.bw_mult is None:
            raise ValueError("session.run_sharded needs bw_mult and u on "
                             "the stream")
        if not self.policy.shardable:
            raise ValueError(
                f"policy {self.policy.name!r} couples tasks globally in "
                f"decide_stream and cannot run stream-sharded")
        if self.finetune is not None:
            raise NotImplementedError(
                "online fine-tuning is single-mesh only for now")
        if hierarchical and self.hedge is not None:
            raise ValueError(
                "hierarchical sharding cannot hedge: the deadline quantile "
                "is a global order statistic (use the gathered mode)")
        n_dev = shard_count(mesh, mesh_axis)
        if hierarchical and (self.n_edge % n_dev or self.n_cloud % n_dev):
            raise ValueError(
                f"hierarchical sharding partitions the server pool "
                f"statically: n_edge={self.n_edge} and n_cloud="
                f"{self.n_cloud} must both divide by the {n_dev}-device "
                f"mesh")
        if n_rounds is not None:
            stream = _slice_rounds(stream, 0, n_rounds)
        has_churn = self._check_churn(stream)
        capture = self._sharded_capture(mesh, mesh_axis)
        key = ("sharded", id(mesh), mesh_axis, hierarchical, has_churn,
               signature(stream))
        plan = self._plans.get(key)
        if plan is None:
            plan = _ShardPlan.build(
                self.policy, mesh, mesh_axis, self.n_streams,
                n_edge=self.n_edge, n_cloud=self.n_cloud, hedge=self.hedge,
                acfg=self.admission if has_churn else None,
                hierarchical=hierarchical)
        local = _shard_stream(stream, plan)
        carry = self._local_carry(plan, local, has_churn)
        graph = self.graphs.get(key)
        if graph is None or graph.capacity < stream.n_rounds:
            graph = RoundGraph(
                functools.partial(_sharded_round, self.policy, plan),
                tree_map(torch.clone, carry), local, capture=capture)
            self.graphs[key], self._plans[key] = graph, plan
        else:
            assign(graph.leaves, tree_leaves(carry))
        out = graph.run(local)

        # the carry and the hierarchical per-task outputs, gathered once
        st = graph.carry[0] if has_churn else graph.carry
        self.state = tree_map(torch.clone, st) if \
            self.policy.state_replicated else tree_map(plan.gather, st)
        if has_churn:
            alive, degr, queue = graph.carry[1:]
            self._churn_carry = (alive[:plan.m].clone(),
                                 degr[:plan.m].clone(), queue.clone())
        if hierarchical:
            out = {k: plan.gather(v.movedim(1, 0).contiguous()).movedim(
                       0, 1).contiguous() if v.dim() >= 2 else v
                   for k, v in out.items()}
        return out

    def run_elastic(self, stream: Observation, failures: dict, *,
                    mesh_axis: str = "data", n_nodes: int | None = None):
        """Serve through the loss of ranks: one sharded run a segment.

        ``failures``: {round: node ids} killed before that round.  At each
        boundary the dead nodes are registered with a :class:`ClusterSim`,
        ``elastic_remesh(alive, prefer="data")`` builds the survivor mesh
        (ranks ``0..alive-1``; every rank of the world makes the call) and
        the next segment continues on it with the carry, which the last
        segment gathered to the full M and the next re-pads and re-slices.
        A rank outside a segment's mesh sits it out and receives its
        metrics from rank 0.  Every rank returns the per-round outputs
        concatenated over the segments; the meshes are kept on
        ``mesh_history``.  ``n_nodes`` defaults to the world size."""
        from repro_torch.runtime.cluster import ClusterSim, elastic_remesh

        self._check_obs(stream, rounds=True)
        r_total = stream.n_rounds
        world = dist.get_world_size()
        cluster = ClusterSim(n_nodes or world)
        # a malformed plan silently skipped here would make the run look
        # healthier than the experiment the caller asked for
        for r, nodes in failures.items():
            if not isinstance(r, (int, np.integer)) or not 0 < r < r_total:
                raise ValueError(
                    f"failures round {r!r} is outside the valid boundary "
                    f"range 1..{r_total - 1} (failures fire *before* a "
                    f"round; round 0 has no prior segment)")
            for node in nodes:
                if not 0 <= int(node) < cluster.n_nodes:
                    raise ValueError(
                        f"failures[{r}] names unknown node {node!r}; "
                        f"cluster has nodes 0..{cluster.n_nodes - 1}")
        bounds = sorted(failures)
        mesh = elastic_remesh(cluster.alive, prefer="data")
        self.mesh_history = [(0, mesh)]
        parts, start = [], 0
        for b in bounds + [r_total]:
            seg = _slice_rounds(stream, start, b)
            mets = None
            if mesh.get_coordinate() is not None:
                mets = self.run_sharded(mesh, seg, mesh_axis=mesh_axis)
            parts.append(self._from_rank_zero(mesh, mets))
            if b < r_total:
                for node in failures[b]:
                    cluster.kill(int(node))
                if cluster.alive <= 0:
                    raise RuntimeError(
                        f"all {cluster.n_nodes} nodes dead at round {b}; "
                        f"no survivor mesh to continue on")
                mesh = elastic_remesh(cluster.alive, prefer="data")
                self.mesh_history.append((b, mesh))
            start = b
        self.state, self._churn_carry = self._from_rank_zero(
            mesh, (self.state, self._churn_carry))
        return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}

    def _from_rank_zero(self, mesh, obj):
        """``obj`` (tensors in tuples, dataclasses or a dict) as rank 0
        holds it, on every rank of the world: a broadcast through the host
        when ranks sat out ``mesh``."""
        if mesh.size() == dist.get_world_size():
            return obj
        box = [tree_map(torch.Tensor.cpu, obj) if dist.get_rank() == 0
               else None]
        dist.broadcast_object_list(box, src=0)
        return tree_map(lambda t: t.to(self.policy.device), box[0])

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
