"""Delay / energy / accuracy model (paper §3.1, §4.1.2) — port of
``repro/core/cost_model.py``.

``SystemConfig`` is copied field for field.  The accuracy surface keeps the
reference's elementwise op order exactly (``repro/core/cost_model.py:86``):
every feasibility bit of the router is an ``f >= thr`` test on it, so the
order of float32 operations decides routes.  All arithmetic is float32 on
tensors; scalar coefficients enter as Python floats, which PyTorch casts to
float32 before the op, as JAX's weak typing does.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    resolutions: tuple = (360, 540, 720, 900, 1080)      # p
    fps_options: tuple = (10, 20, 30, 40, 50)
    num_versions: int = 5
    beta: float = 0.06
    segment_sec: float = 1.0
    bits_per_pixel: float = 0.12          # H.264-ish compressed
    edge_bw_mbps: float = 50.0
    cloud_bw_mbps: float = 100.0
    edge_power_w: float = 15.0
    cloud_power_w: float = 100.0
    transmit_power_w: float = 2.5
    # per-tier sustained throughput in GFLOP/s (paper profile)
    edge_gflops: float = 800.0            # Jetson Xavier NX effective
    cloud_gflops: float = 6000.0          # Xeon 4214R effective
    # version ladder: FLOPs per frame at 1080p, edge tier (GFLOP)
    v1_gflops_per_frame: float = 1.2      # YOLOv5n-ish
    version_scale: float = 1.9            # v_{k+1} = scale * v_k
    cloud_model_factor: float = 10.0      # cloud models ~10x edge (paper §4.1.1)
    total_bw_mbps: float = 600.0          # C6 budget across tasks
    gamma: int = 2                        # Γ uncertainty budget
    u_dev: float = 0.35                   # max relative deviation ũ_k
    acc_margin_nominal: float = 0.005     # baselines' feasibility slack
    acc_margin_robust: float = 0.02       # ours: robustly protected C1

    @property
    def n_res(self):
        return len(self.resolutions)

    @property
    def n_fps(self):
        return len(self.fps_options)


def _pixels(res_p):
    return (res_p * 16 // 9) * res_p


def version_flops(sys: SystemConfig, tier: int, k: int, res_p: int) -> float:
    """GFLOP per frame for version k (0-based) on tier (0=edge, 1=cloud)."""
    base = sys.v1_gflops_per_frame * (sys.version_scale ** k)
    if tier == 1:
        base *= sys.cloud_model_factor
    return base * _pixels(res_p) / _pixels(1080)


# the normalized coordinates are cached per (config, device): every round
# reads them, and building them anew would copy host memory to the device
@functools.lru_cache(maxsize=32)
def res_norm(sys: SystemConfig, device="cuda") -> torch.Tensor:
    """(N,) resolutions / 1080 in float32 — the accuracy formula's r.
    Cached and shared: callers must not write to it."""
    return torch.tensor(sys.resolutions, dtype=torch.float32,
                        device=device) / 1080.0


@functools.lru_cache(maxsize=32)
def fps_norm(sys: SystemConfig, device="cuda") -> torch.Tensor:
    """(Z,) frame rates / 50 in float32 — the accuracy formula's p.
    Cached and shared: callers must not write to it."""
    return torch.tensor(sys.fps_options, dtype=torch.float32,
                        device=device) / 50.0


def _accuracy_formula(z, r, p, k, tier):
    """Accuracy surface f(r, p, v, tier | z), elementwise on float32 tensors.

    ``k`` and ``tier`` must be float32 tensors (0-dim is fine), never Python
    numbers: ``0.045 * k`` has to round in float32, as it does in JAX and in
    the CUDA kernels.  Same ops in the same order as the reference."""
    a_max = 0.60 + 0.045 * k + 0.04 * tier           # bigger model, higher ceiling
    sat = 1.0 - torch.exp(-(2.5 + 0.3 * k) * r)
    f = a_max * sat
    f = f - 0.10 * z * (1.0 - p) - 0.06 * z * (1.0 - r)
    return torch.clamp(f, 0.0, 1.0)


def accuracy_table(sys: SystemConfig, difficulty):
    """f(r, p, v, tier | z): (..., N, Z, K, 2) accuracy for difficulty z
    (...,), the full surface (port of ``cost_model.py:98``)."""
    dev = difficulty.device
    z = difficulty[..., None, None, None, None]
    r = res_norm(sys, dev)[:, None, None, None]
    p = fps_norm(sys, dev)[None, :, None, None]
    k = torch.arange(sys.num_versions, dtype=torch.float32,
                     device=dev)[None, None, :, None]
    tier = torch.arange(2, dtype=torch.float32, device=dev)[None, None, None]
    return _accuracy_formula(z, r, p, k, tier)


def accuracy_at(sys: SystemConfig, difficulty, r, p, v, route):
    """Accuracy at chosen (r, p, v, route) index tensors (pointwise)."""
    dev = difficulty.device
    rn = res_norm(sys, dev)[r]
    pn = fps_norm(sys, dev)[p]
    return _accuracy_formula(difficulty, rn, pn, v.to(torch.float32),
                             route.to(torch.float32))


def accuracy_stage1(sys: SystemConfig, difficulty):
    """(M, N) accuracy of the smallest model on edge at max fps."""
    dev = difficulty.device
    z = difficulty[..., None]
    rn = res_norm(sys, dev)
    pn = fps_norm(sys, dev)[-1]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return _accuracy_formula(z, rn, pn, zero, zero)


def cost_tables(sys: SystemConfig, device="cuda"):
    """Returns float32 tensors (c1, b2, bw_mb) on ``device``:

      c1   : (N, Z, 2) first-stage cost  — transmission delay + β·tx energy
      b2   : (N, Z, K, 2) second-stage   — compute delay + β·compute energy
      bw_mb: (N, Z, 2) bandwidth consumed (Mbps) per config

    The reference's numpy arithmetic is copied, so the tables are
    bit-identical to its own.
    """
    fps = np.array(sys.fps_options, np.float32)
    pix = np.array([_pixels(int(r)) for r in sys.resolutions], np.float32)

    data_mbit = (pix[:, None] * fps[None, :] * sys.segment_sec * sys.bits_per_pixel) / 1e6
    bw = np.array([sys.edge_bw_mbps, sys.cloud_bw_mbps], np.float32)
    trans_delay = data_mbit[..., None] / bw  # (N, Z, 2) seconds
    trans_energy = sys.transmit_power_w * trans_delay
    c1 = trans_delay + sys.beta * trans_energy

    gf = np.zeros((sys.n_res, sys.num_versions, 2), np.float32)
    for i, r in enumerate(sys.resolutions):
        for k in range(sys.num_versions):
            for t in range(2):
                gf[i, k, t] = version_flops(sys, t, k, int(r))
    thr = np.array([sys.edge_gflops, sys.cloud_gflops], np.float32)
    power = np.array([sys.edge_power_w, sys.cloud_power_w], np.float32)
    comp_delay = (
        gf[:, None, :, :] * fps[None, :, None, None] * sys.segment_sec / thr
    )  # (N, Z, K, 2)
    comp_energy = power * comp_delay
    b2 = comp_delay + sys.beta * comp_energy
    bw_mb = data_mbit[..., None] * np.ones(2)
    return tuple(torch.from_numpy(t.astype(np.float32)).to(device)
                 for t in (c1, b2, bw_mb))
