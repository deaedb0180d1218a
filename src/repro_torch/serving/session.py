"""ServeSession: the serve driver — port of the dense path of
``repro/serving/session.py`` (``__init__`` :572, ``reset``, ``step`` :705,
``run`` :717 and the round body ``_serve_step`` / ``_serve_run`` :160/:169)
and of its live model pools (``dispatch``, ``feedback``, ``apply_feedback``
:870-972).

The reference runs the rounds under one ``lax.scan``; here ``run`` is a
Python loop over rounds, each of which launches its work on the policy's
device and never reads back to the host.  Mesh, churn, finetune and hedging
are later slices of the port (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serving.dispatch import DispatchExecutor, Request
from repro_torch.serving.policy import Observation, Policy
from repro_torch.serving.simulator import SimConfig, realize_rounds

_MET_KEYS = ("delay", "energy", "cost", "accuracy")
_SOL_KEYS = ("route", "r", "p", "v", "tau")


def _round_output(sol, met):
    """The per-round output: deterministic metrics + the decisions."""
    out = {k: met[k] for k in _MET_KEYS}
    out.update({k: sol[k] for k in _SOL_KEYS if k in sol})
    return out


def _serve_step(policy: Policy, state, obs: Observation, n_edge: int,
                n_cloud: int):
    """One round: decide (policy) then realize (simulator)."""
    state, sol = policy.decide(state, obs)
    met = realize_rounds(policy.lat, obs.z, obs.bw_mult, obs.u, sol["route"],
                         sol["r"], sol["p"], sol["v"], n_edge=n_edge,
                         n_cloud=n_cloud, force=policy.force)
    return state, _round_output(sol, met)


def _serve_run(policy: Policy, state, obs_seq: Observation, n_edge: int,
               n_cloud: int):
    """R rounds of :func:`_serve_step`; outputs stacked to (R, M)."""
    outs = []
    for i in range(obs_seq.n_rounds):
        state, out = _serve_step(policy, state, obs_seq.round(i), n_edge,
                                 n_cloud)
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


class ServeSession:
    """Owns the policy, the per-stream carry, the server pool sizes and,
    optionally, the live tier model ``pools`` ({tier: ModelPool}) that
    :meth:`dispatch` executes routed solutions on.

    The device is the policy's (``make_policy(..., device=...)``); a
    ``device`` given here must agree with it.  With no card and no
    ``device="cpu"`` the constructor raises.
    """

    def __init__(self, policy: Policy, n_streams: int, *,
                 sim: SimConfig | None = None, n_edge: int | None = None,
                 n_cloud: int | None = None, device="cuda", state=None,
                 mesh=None,
                 finetune=None, hedge=None, admission=None, pools=None):
        for key, val, item in (("mesh", mesh, "A.15"),
                               ("finetune", finetune, "A.11"),
                               ("hedge", hedge, "A.9"),
                               ("admission", admission, "A.10")):
            if val is not None:
                raise NotImplementedError(
                    f"ServeSession({key}=...) is ROADMAP queue {item}")
        dev = resolve_device(device)
        if policy.device.type != dev.type:
            raise ValueError(f"ServeSession(device={device!r}) but the "
                             f"policy lives on {policy.device}")
        sim = sim or SimConfig()
        self.policy = policy
        self.n_streams = n_streams
        self.n_edge = sim.n_edge_servers if n_edge is None else n_edge
        self.n_cloud = sim.n_cloud_servers if n_cloud is None else n_cloud
        self.state = policy.init(n_streams) if state is None else state
        self.pools = pools
        self._executor = None

    @property
    def sys_cfg(self):
        return self.policy.lat.sys

    def reset(self, n_streams: int | None = None):
        if n_streams is not None:
            self.n_streams = n_streams
        self.state = self.policy.init(self.n_streams)

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
        for key in ("tier_ok", "avail", "lat_mult"):
            if getattr(obs, key) is not None:
                raise NotImplementedError(
                    f"Observation.{key} (scenarios) is ROADMAP queue A.9")
        if obs.arrive_n is not None or obs.depart is not None:
            raise NotImplementedError("churn is ROADMAP queue A.10")

    def step(self, obs: Observation):
        """One serving round -> dict of (M,) metrics and decisions."""
        self._check_obs(obs, rounds=False)
        self.state, out = _serve_step(self.policy, self.state, obs,
                                      self.n_edge, self.n_cloud)
        return out

    def run(self, stream: Observation):
        """Serve R rounds; returns the per-round dict of (R, M) tensors
        (deterministic delay / energy / cost / accuracy + decisions + τ)."""
        self._check_obs(stream, rounds=True)
        self.state, mets = _serve_run(self.policy, self.state, stream,
                                      self.n_edge, self.n_cloud)
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
