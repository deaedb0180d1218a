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
(``_finetune_round``).  The mesh is a later slice of the port (ROADMAP
queue A.15).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.gating import batch_volatility
from repro_torch.device import resolve_device
from repro_torch.kernels.temporal_gate.ops import gate_cell_vjp
from repro_torch.serving.dispatch import DispatchExecutor, Request
from repro_torch.serving.graphs import (
    RoundGraph,
    assign,
    signature,
    tree_leaves,
    tree_map,
)
from repro_torch.serving.policy import Observation, Policy, capacity_budget
from repro_torch.serving.simulator import SimConfig, realize_rounds

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


def _prefix(stream: Observation, n_rounds: int) -> Observation:
    """The first ``n_rounds`` rounds of a round-stacked stream (views)."""
    return Observation(**{f.name: None if getattr(stream, f.name) is None
                          else getattr(stream, f.name)[:n_rounds]
                          for f in dataclasses.fields(stream)})


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
    """

    def __init__(self, policy: Policy, n_streams: int, *,
                 sim: SimConfig | None = None, n_edge: int | None = None,
                 n_cloud: int | None = None, device="cuda", state=None,
                 mesh=None, finetune=None, hedge=None, admission=None,
                 force: str | None = None, pools=None,
                 capture: bool | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "ServeSession(mesh=...) is ROADMAP queue A.15")
        dev = resolve_device(device)
        if policy.device.type != dev.type:
            raise ValueError(f"ServeSession(device={device!r}) but the "
                             f"policy lives on {policy.device}")
        if capture not in (None, True, False):
            raise ValueError(f"capture must be None, True or False, got "
                             f"{capture!r}")
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
        self.capture = capture
        self.state = policy.init(n_streams) if state is None else state
        self._churn_carry = None
        # rounds served by finetune runs (the tuning cadence's counter)
        self._rounds_done = torch.zeros((), dtype=torch.int64,
                                        device=policy.device)
        self.graphs = {}            # (kind, stream signature) -> RoundGraph
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

    def run(self, stream: Observation, n_rounds: int | None = None):
        """Serve R rounds; returns the per-round dict of (R, M) tensors
        (deterministic delay / energy / cost / accuracy + decisions + τ).
        ``n_rounds`` serves a prefix.  A stream with churn traces runs the
        slot pool and also returns ``alive`` (R, M) and ``queue_depth`` /
        ``admitted`` / ``dropped`` (R,); its ``route`` is -1 on dead
        slots.  A finetune session tunes the gate as it serves."""
        self._check_obs(stream, rounds=True)
        if stream.u is None or stream.bw_mult is None:
            raise ValueError("session.run needs bw_mult and u on the stream "
                             "(use route_many for decide-only scans)")
        if n_rounds is not None:
            stream = _prefix(stream, n_rounds)
        if self._check_churn(stream):
            return self._rounds("churn", stream)
        return self._rounds("serve" if self.finetune is None else "finetune",
                            stream)

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
