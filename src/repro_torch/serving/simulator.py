"""Round-based edge-cloud serving simulator (paper §4 evaluation substrate)
— port of the nominal path of ``repro/serving/simulator.py``.

``realize_rounds`` realizes a round's decisions: fair-share transmission on
the tier uplink, LPT queueing on 4 edge / 1 cloud servers (the ``lpt_queue``
CUDA helper on the card), compute time under the realized deviation u,
energy, cost and the pointwise accuracy.  :class:`Simulator` keeps the
reference's host-numpy stream generator and observation-noise model, copied,
so a stream can be made and a run scored without JAX; for one seed its
numbers are the reference's.  ``Simulator.run`` serves a policy through
``ServeSession.run`` and returns the paper's scalars (delay, energy, cost,
accuracy, success, cloud_frac), as ``benchmarks/paper_tables.run_method``
reads them from the reference.
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


def realize_rounds(lat: DecisionLattice, z, bw_mult, u, route, r, p, v, *,
                   n_edge: int, n_cloud: int, force: str = "auto",
                   avail=None, lat_mult=None, hedge=None, task_mask=None):
    """Deterministic realization (no observation noise), nominal path.

    z/route/r/p/v: (..., M) with at most one leading round axis; bw_mult:
    (..., 2); u: (..., K).  Returns per-task delay / energy / cost /
    accuracy / route.  ``force`` pins the LPT helper.
    """
    if avail is not None or lat_mult is not None or hedge is not None:
        raise NotImplementedError(
            "avail / lat_mult / hedge (scenario realization) are ROADMAP "
            "queue A.9")
    if task_mask is not None:
        raise NotImplementedError("task_mask (churn) is ROADMAP queue A.10")
    sys = lat.sys
    dev = z.device
    gtab, tier_bw, thr, power = _tables(sys, dev)
    m = route.shape[-1]

    # transmission: fair-share the tier uplink among its tasks
    bw = tier_bw * bw_mult                                     # (..., 2)
    data_mbit = lat.bw[r, p, route]                            # (..., M)
    n_cloud_tasks = route.sum(dim=-1, keepdim=True)
    n_tier = torch.clamp_min(torch.cat([m - n_cloud_tasks, n_cloud_tasks],
                                       dim=-1), 1)
    share = bw.gather(-1, route) / n_tier.gather(-1, route)
    t_trans = data_mbit / torch.clamp_min(share, 1e-6)

    # compute: GFLOPs table + realized deviation u_v
    gf = gtab[r, p, v, route]
    t_comp = gf / thr[route] * (1.0 + u.gather(-1, v))

    # queueing: LPT packing (stable longest-first order, serial walk)
    t_queue = lpt_queue(t_comp, route.to(torch.int32), n_edge, n_cloud,
                        force=force)

    delay = t_trans + t_queue + t_comp
    energy = power[route] * t_comp + sys.transmit_power_w * t_trans
    cost = delay + sys.beta * energy
    acc = accuracy_at(sys, z, r, p, v, route)
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
