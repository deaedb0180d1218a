"""ServeSession: the serve driver — port of the dense path of
``repro/serving/session.py`` (``__init__`` :572, ``reset``, ``step`` :705,
``run`` :717 and the round body ``_serve_step`` / ``_serve_run`` :160/:169).

The reference runs the rounds under one ``lax.scan``; here ``run`` is a
Python loop over rounds, each of which launches its work on the policy's
device and never reads back to the host.  Mesh, churn, finetune, hedging,
dispatch and pools are later slices of the port (ROADMAP queue A).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
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
    """Owns the policy, the per-stream carry and the server pool sizes.

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
                               ("admission", admission, "A.10"),
                               ("pools", pools, "A.13")):
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
        for key in ("tier_ok", "avail", "lat_mult", "bw_scale"):
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
