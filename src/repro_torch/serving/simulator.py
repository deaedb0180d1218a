"""Round-based edge-cloud serving simulator (paper §4 evaluation substrate)
— port of ``repro/serving/simulator.py`` (``clamp_route_by_avail`` :112,
``realize_rounds`` :122-265 with the sharded session's ``n_tier`` /
``tier_frac`` overrides :127-200, and the host-numpy stream generator).

``realize_rounds`` realizes a round's decisions: fair-share transmission on
the tier uplink, LPT queueing on 4 edge / 1 cloud servers (the ``lpt_queue``
CUDA helper on the card), compute time under the realized deviation u,
energy, cost and the pointwise accuracy; under a scenario also dead
servers, hedged stragglers and a slot pool's dead lanes.
:class:`Simulator` keeps the reference's host-numpy stream generator and
observation-noise model, copied, so a stream can be made and a run scored
without JAX; for one seed its numbers are the reference's.
``Simulator.run`` serves a policy through ``ServeSession.run`` and returns
the paper's scalars (delay, energy, cost, accuracy, success, cloud_frac),
as ``benchmarks/paper_tables.run_method`` reads them from the reference;
``realize`` / ``realize_batch`` (:294-320, :374-398) realize the host's
round dicts and decisions on the simulator's device and return numpy.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.cost_model import SystemConfig, accuracy_at
from repro_torch.core.gating import feature_dim
from repro_torch.core.lattice import DecisionLattice, gflops_table
from repro_torch.device import resolve_device
from repro_torch.kernels.lpt_queue.ops import lpt_queue
from repro_torch.runtime.straggler import hedged_dispatch


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_rounds: int = 20
    n_tasks: int = 60
    requirement: str = "stable"        # stable | fluctuating
    bw_fluctuation: float = 0.0        # 0..0.3: bandwidth dips up to this frac
    n_edge_servers: int = 4
    n_cloud_servers: int = 1
    seed: int = 0
    adversarial_u: bool = True         # realize u at a worst-ish pole of U

    def __post_init__(self):
        if not 0.0 <= self.bw_fluctuation <= 0.3:
            raise ValueError(
                f"bw_fluctuation must be in [0, 0.3], got "
                f"{self.bw_fluctuation!r}")
        if self.requirement not in ("stable", "fluctuating"):
            raise ValueError(
                f"unknown requirement {self.requirement!r}; expected "
                f"'stable' or 'fluctuating'")


@functools.lru_cache(maxsize=32)
def _tables(sys: SystemConfig, device):
    """Realization constants on the device, built once per (config, device):
    the (N, Z, K, 2) GFLOPs table and the per-tier uplink, throughput and
    power.  Cached and shared: callers must not write to them."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return (torch.from_numpy(gflops_table(sys).astype(np.float32)).to(device),
            f32([sys.edge_bw_mbps, sys.cloud_bw_mbps]),
            f32([sys.edge_gflops, sys.cloud_gflops]),
            f32([sys.edge_power_w, sys.cloud_power_w]))


def clamp_route_by_avail(route, avail, n_edge: int, n_cloud: int):
    """Route clamp against a server pool's availability (``avail`` (..., S),
    edge servers first): never realize on a tier with no live server;
    edge-down wins when both tiers are dead, as the router's
    ``clamp_route_available``."""
    alive_e = avail[..., :n_edge].sum(-1, keepdim=True)
    alive_c = avail[..., n_edge:].sum(-1, keepdim=True)
    route = torch.where(alive_c > 0, route, torch.zeros_like(route))
    return torch.where(alive_e > 0, route, torch.ones_like(route))


def realize_rounds(lat: DecisionLattice, z, bw_mult, u, route, r, p, v, *,
                   n_edge: int, n_cloud: int, force: str = "auto",
                   avail=None, lat_mult=None, hedge=None, task_mask=None,
                   n_tier=None, tier_frac=None):
    """Deterministic realization (no observation noise).

    z/route/r/p/v: (..., M) with at most one leading round axis; bw_mult:
    (..., 2); u: (..., K).  Returns per-task delay / energy / cost /
    accuracy / route.  ``force`` pins the LPT helper.  The scenario inputs,
    as the reference's (None leaves the nominal path):

    ``avail``      (..., S) per-server availability: routes on a tier with
                   no live server are clamped to the other, the tier
                   uplink shrinks by its alive fraction and LPT starts a
                   dead server at +inf load.
    ``lat_mult``   (..., M, 2) latency multipliers: column 0 scales the
                   primary dispatch, column 1 the hedged backup.
    ``hedge``      (quantile, cost): a backup fires at the ``quantile``
                   deadline of the round's primary times and finishes at
                   deadline + backup + cost; the earlier of the two wins
                   (``runtime.straggler.hedged_dispatch``).  Needs
                   ``lat_mult``.
    ``task_mask``  (..., M) bool alive mask (slot-pool churn): dead lanes
                   are out of the tier counts, take zero compute time into
                   LPT (they sort after every alive lane and add no load)
                   and come out with zeroed metrics and route -1.  Not
                   with ``hedge``.
    ``n_tier`` / ``tier_frac``  (2,) the fleet's task count and alive
                   fraction of each tier, for a caller that packs its
                   shard's segments onto its slice of the server pool (the
                   hierarchical sharded session): the uplink's fair share
                   is the fleet's, while the clamp and the queue stay on
                   the slice.  None derives both here.
    """
    if task_mask is not None and hedge is not None:
        raise ValueError("hedged dispatch is not supported with task_mask "
                         "(the deadline quantile would mix dead lanes)")
    if hedge is not None and lat_mult is None:
        raise ValueError("hedge requires lat_mult (per-task latency draws)")
    sys = lat.sys
    dev = z.device
    gtab, tier_bw, thr, power = _tables(sys, dev)
    m = route.shape[-1]

    alive_frac = None
    if avail is not None:
        alive_frac = torch.stack([avail[..., :n_edge].sum(-1) / n_edge,
                                  avail[..., n_edge:].sum(-1) / n_cloud],
                                 dim=-1)
        route = clamp_route_by_avail(route, avail, n_edge, n_cloud)
    if tier_frac is not None:
        alive_frac = tier_frac

    # transmission: fair-share the tier uplink among its tasks
    bw = tier_bw * bw_mult                                     # (..., 2)
    if alive_frac is not None:
        bw = bw * alive_frac
    data_mbit = lat.bw[r, p, route]                            # (..., M)
    if n_tier is None and task_mask is not None:
        n_cloud_tasks = (route * task_mask).sum(dim=-1, keepdim=True)
        n_live = task_mask.sum(dim=-1, keepdim=True)
        n_tier = torch.cat([n_live - n_cloud_tasks, n_cloud_tasks], dim=-1)
    elif n_tier is None:
        n_cloud_tasks = route.sum(dim=-1, keepdim=True)
        n_tier = torch.cat([m - n_cloud_tasks, n_cloud_tasks], dim=-1)
    n_tier = torch.clamp_min(n_tier, 1)
    share = bw.gather(-1, route) / n_tier.gather(-1, route)
    t_trans = data_mbit / torch.clamp_min(share, 1e-6)

    # compute: GFLOPs table + realized deviation u_v
    gf = gtab[r, p, v, route]
    t_comp = gf / thr[route] * (1.0 + u.gather(-1, v))
    if task_mask is not None:
        t_comp = torch.where(task_mask, t_comp, 0.0)
    if lat_mult is not None:
        draws = t_comp[..., None] * lat_mult       # (..., M, 2) replicas
        if hedge is not None:
            t_comp = hedged_dispatch(draws, hedge_quantile=hedge[0],
                                     hedge_cost=hedge[1])
        else:
            t_comp = draws[..., 0]

    # queueing: LPT packing (stable longest-first order, serial walk)
    t_queue = lpt_queue(t_comp, route.to(torch.int32), n_edge, n_cloud,
                        avail=avail, force=force)

    delay = t_trans + t_queue + t_comp
    energy = power[route] * t_comp + sys.transmit_power_w * t_trans
    cost = delay + sys.beta * energy
    acc = accuracy_at(sys, z, r, p, v, route)
    if task_mask is not None:
        zero = lambda x: torch.where(task_mask, x, 0.0)
        return {"delay": zero(delay), "energy": zero(energy),
                "cost": zero(cost), "accuracy": zero(acc),
                "route": torch.where(task_mask, route, -1)}
    return {"delay": delay, "energy": energy, "cost": cost,
            "accuracy": acc, "route": route}


class Simulator:
    """Stream generator, observation noise and run scoring of the reference
    simulator (host numpy, copied)."""

    def __init__(self, sys: SystemConfig, sim: SimConfig, device="cuda"):
        self.sys = sys
        self.sim = sim
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(sim.seed)

    def sample_round(self):
        sim, rng = self.sim, self.rng
        z = np.clip(rng.beta(2.0, 2.5, sim.n_tasks) * 1.2, 0.02, 1.0)
        if sim.requirement == "stable":
            aq = rng.uniform(0.6, 0.7, sim.n_tasks)
        else:
            aq = rng.uniform(0.5, 0.8, sim.n_tasks)
        bw_mult = 1.0 - rng.uniform(0.0, sim.bw_fluctuation, 2)  # per tier
        # realized compute deviation in U (Γ largest versions get hit)
        u = np.zeros(self.sys.num_versions)
        if sim.adversarial_u:
            hit = rng.choice(self.sys.num_versions, self.sys.gamma, replace=False)
            u[hit] = self.sys.u_dev * (0.6 + 0.4 * hit / (self.sys.num_versions - 1))
        else:
            u = rng.uniform(0, self.sys.u_dev, self.sys.num_versions)
        return {"z": z.astype(np.float32), "aq": aq.astype(np.float32),
                "bw_mult": bw_mult, "u": u}

    def sample_stream(self, n_rounds=None, dx_seq=None, feature_seed=None):
        """R rounds as one round-stacked ``Observation`` on the device.

        ``feature_seed`` draws the (R, M, d) motion features from a
        dedicated numpy rng, as the reference does."""
        from repro_torch.serving.policy import Observation

        n = n_rounds or self.sim.n_rounds
        rnds = [self.sample_round() for _ in range(n)]
        if dx_seq is None and feature_seed is not None:
            frng = np.random.default_rng(feature_seed)
            dx_seq = frng.normal(size=(n, self.sim.n_tasks, feature_dim()))
        f32 = lambda a: torch.from_numpy(
            np.asarray(a).astype(np.float32)).to(self.device)
        return Observation(
            z=f32(np.stack([rd["z"] for rd in rnds])),
            aq=f32(np.stack([rd["aq"] for rd in rnds])),
            dx=None if dx_seq is None else f32(dx_seq),
            bw_mult=f32(np.stack([rd["bw_mult"] for rd in rnds])),
            u=f32(np.stack([rd["u"] for rd in rnds])),
        )

    @functools.cached_property
    def lat(self) -> DecisionLattice:
        return DecisionLattice.build(self.sys, self.device)

    def _realize(self, z, bw_mult, u, cfg):
        """``realize_rounds`` of host arrays on the simulator's device ->
        numpy metrics."""
        f32 = lambda a: torch.from_numpy(
            np.asarray(a, dtype=np.float32)).to(self.device)
        i64 = lambda k: torch.from_numpy(
            np.asarray(cfg[k]).astype(np.int64)).to(self.device)
        met = realize_rounds(self.lat, f32(z), f32(bw_mult), f32(u),
                             i64("route"), i64("r"), i64("p"), i64("v"),
                             n_edge=self.sim.n_edge_servers,
                             n_cloud=self.sim.n_cloud_servers)
        return {k: v.cpu().numpy() for k, v in met.items()}

    def _realize_deterministic(self, rnd, cfg):
        """One round's realization without observation noise: ``rnd`` a
        round dict (``sample_round``), ``cfg`` the (M,) route/r/p/v."""
        return self._realize(rnd["z"], rnd["bw_mult"], rnd["u"], cfg)

    def realize(self, rnd, cfg):
        """One round's per-task metrics with the observation noise drawn
        from ``self.rng`` (``observe``) and the SLA success."""
        met = self._realize_deterministic(rnd, cfg)
        acc, success = self.observe(met["accuracy"], rnd["aq"])
        return dict(met, accuracy=acc, success=success)

    def realize_batch(self, rnds, cfgs):
        """``realize`` of R rounds in one pass: lists of round dicts and
        of decision dicts -> (R, M) metrics, the noise drawn for all R
        rounds at once."""
        stack = lambda key, ds: np.stack([np.asarray(d[key]) for d in ds])
        met = self._realize(stack("z", rnds), stack("bw_mult", rnds),
                            stack("u", rnds),
                            {k: stack(k, cfgs) for k in ("route", "r", "p",
                                                         "v")})
        acc, success = self.observe(met["accuracy"], stack("aq", rnds))
        return dict(met, accuracy=acc, success=success)

    def observe(self, acc, aq):
        """Observation noise (σ = 0.008, from ``self.rng``) and SLA success:
        ``(noisy accuracy, success)`` as float64 numpy arrays."""
        acc = np.clip(np.asarray(acc) + self.rng.normal(0, 0.008,
                                                        np.shape(acc)), 0, 1)
        return acc, (acc >= np.asarray(aq) - 1e-6).astype(np.float32)

    def aggregate(self, mets, aq) -> dict:
        """Scalar run metrics from the per-round (R, M) metrics of
        ``ServeSession.run``: draws the observation noise and averages over
        streams, then over rounds."""
        host = lambda x: x.cpu().numpy()
        acc, success = self.observe(host(mets["accuracy"]), host(aq))
        out = {k: float(host(mets[k]).mean(axis=1).mean())
               for k in ("delay", "energy", "cost")}
        out["accuracy"] = float(acc.mean(axis=1).mean())
        out["success"] = float(success.mean(axis=1).mean())
        out["cloud_frac"] = float(host(mets["route"]).mean(axis=1).mean())
        return out

    def run(self, policy, n_rounds=None, dx_seq=None,
            feature_seed=None) -> dict:
        """Serve a sampled stream through ``ServeSession.run`` on the
        simulator's device and score it with :meth:`aggregate`.  All rounds
        are sampled before any observation noise is drawn, as in the
        reference."""
        from repro_torch.serving.session import ServeSession

        stream = self.sample_stream(n_rounds, dx_seq, feature_seed)
        session = ServeSession(policy, n_streams=self.sim.n_tasks,
                               sim=self.sim, device=self.device)
        return self.aggregate(session.run(stream), stream.aq)

    def run_batch(self, policy, n_rounds=None) -> dict:
        """The reference's deprecated alias of :meth:`run`."""
        return self.run(policy, n_rounds)
