"""Unified decision lattice for the two-stage router (paper §3.1) — port of
``repro/core/lattice.py``.

Per task the router searches y = (route, r, p), F = 2·N·Z first-stage
options in the route-major flat order y = (route·N + r)·Z + p, and a
second-stage version v ∈ K.  :class:`DecisionLattice` holds the cost tables in
the natural (N, Z, [K,] 2) and flat (F[, K]) layouts on one device, plus the
normalized accuracy coordinates of every flat option.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cost_model import (
    SystemConfig,
    cost_tables,
    fps_norm,
    res_norm,
    version_flops,
)
from repro_torch.device import resolve_device

# infeasible-option sentinel (the reference keeps it in
# repro/kernels/ccg_master/ref.py); the CUDA kernels hard-code the same value
BIG = 1e9


def version_deviations(sys: SystemConfig, device="cuda") -> torch.Tensor:
    """Max relative compute deviation ũ_k per version (K,), float32."""
    k = torch.arange(sys.num_versions, dtype=torch.float32, device=device)
    return sys.u_dev * (0.6 + 0.4 * k / (sys.num_versions - 1))


def gflops_table(sys: SystemConfig) -> np.ndarray:
    """GFLOPs per segment for every (r, p, v, tier): (N, Z, K, 2), float64
    (host-side)."""
    fps = np.asarray(sys.fps_options, np.float32)
    gf = np.zeros((sys.n_res, sys.num_versions, 2))
    for i, res in enumerate(sys.resolutions):
        for k in range(sys.num_versions):
            for t in range(2):
                gf[i, k, t] = version_flops(sys, t, k, int(res))
    return gf[:, None, :, :] * fps[None, :, None, None] * sys.segment_sec


@dataclasses.dataclass(frozen=True)
class DecisionLattice:
    sys: SystemConfig
    c1: torch.Tensor       # (N, Z, 2)    first-stage cost
    b2: torch.Tensor       # (N, Z, K, 2) second-stage nominal cost
    bw: torch.Tensor       # (N, Z, 2)    bandwidth draw (Mbps)
    c1_flat: torch.Tensor  # (F,)         route-major flat first-stage cost
    b2_flat: torch.Tensor  # (F, K)       route-major flat second-stage cost
    bw_flat: torch.Tensor  # (F,)         route-major flat bandwidth draw
    u_dev: torch.Tensor    # (K,)         version deviation vector ũ
    rn_flat: torch.Tensor    # (F,) resolution / 1080
    pn_flat: torch.Tensor    # (F,) fps / 50
    tier_flat: torch.Tensor  # (F,) route as float (0 = edge, 1 = cloud)

    @classmethod
    def build(cls, sys: SystemConfig, device="cuda") -> "DecisionLattice":
        dev = resolve_device(device)
        c1, b2, bw = cost_tables(sys, dev)
        k = sys.num_versions
        f = 2 * sys.n_res * sys.n_fps
        nz = sys.n_res * sys.n_fps
        ys = torch.arange(f, device=dev)
        route = ys // nz
        r_idx = (ys % nz) // sys.n_fps
        p_idx = ys % sys.n_fps
        return cls(
            sys=sys, c1=c1, b2=b2, bw=bw,
            c1_flat=torch.movedim(c1, -1, 0).reshape(f),
            b2_flat=torch.movedim(b2, -1, 0).reshape(f, k),
            bw_flat=torch.movedim(bw, -1, 0).reshape(f),
            u_dev=version_deviations(sys, dev),
            rn_flat=res_norm(sys, dev)[r_idx],
            pn_flat=fps_norm(sys, dev)[p_idx],
            tier_flat=route.to(torch.float32),
        )

    @property
    def device(self) -> torch.device:
        return self.c1.device

    @property
    def n_flat(self) -> int:
        """F = 2·N·Z first-stage options."""
        return 2 * self.sys.n_res * self.sys.n_fps

    def flatten_index(self, route, r, p):
        """(route, r, p) -> flat first-stage index y (route-major)."""
        return (route * self.sys.n_res + r) * self.sys.n_fps + p

    def unflatten_index(self, y):
        """Flat first-stage index y -> (route, r, p)."""
        nz = self.sys.n_res * self.sys.n_fps
        route = y // nz
        rp = y % nz
        return route, rp // self.sys.n_fps, rp % self.sys.n_fps

    def solution_bandwidth(self, sol):
        """Per-task bandwidth draw (Mbps) of a (route, r, p) solution."""
        return self.bw[sol["r"], sol["p"], sol["route"]]
