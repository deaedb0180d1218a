"""R2E-VID two-stage router (paper Alg. 1 + Alg. 2 glue) — port of the
streaming path of ``repro/core/router.py:48-351``.

Stage 1 (Alg. 1) picks the smallest edge resolution whose smallest model
meets the accuracy requirement, escalates to cloud on the gate score τ or
when no edge config is feasible, and keeps the temporal-consistency
constraint; Stage 2 (Alg. 2) is the warm-started fused CCG solve; the C6
bandwidth budget is enforced by a fixed-round top-k demotion repair whose
per-task tail is the ``c6_tail`` kernel.

Every step runs on the device without reading back to the host: the
reference's ``lax.cond`` skip of dead repair rounds becomes a
``torch.where`` select of the unchanged (r, p), which is exact because the
skipped round is a no-op.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cost_model import accuracy_stage1, fps_norm, res_norm
from repro_torch.core.gating import (
    GateBatchState,
    GateConfig,
    gate_step_batch,
    init_batch_state,
)
from repro_torch.core.lattice import DecisionLattice
from repro_torch.core.robust import RobustProblem, solve_ccg_fused
from repro_torch.device import resolve_device
from repro_torch.kernels.c6_tail.ops import c6_tail


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    tau_cloud: float = 0.55       # Stage-1 warm-start cloud threshold
    delta0: float = 0.0           # temporal consistency: δ(x) = δ0 + δ1·x
    delta1: float = 4.0
    repair_rounds: int = 8        # C6 demotion passes


def _no_tier_ok(tier_ok):
    if tier_ok is not None:
        raise NotImplementedError(
            "tier_ok (scenario outages) is ROADMAP queue A.9")


def temporal_flip_allowed(taus, prev_tau, rcfg: RouterConfig):
    """A route flip is allowed only when δ(|τ_t − τ_{t−1}|) ≥ 1."""
    return (torch.abs(taus - prev_tau) * rcfg.delta1 + rcfg.delta0) >= 1.0


def apply_temporal_consistency(route, prev_route, taus, prev_tau,
                               rcfg: RouterConfig):
    """Suppress forbidden flips; ``prev_route < 0`` means no history."""
    allowed = temporal_flip_allowed(taus, prev_tau, rcfg)
    flip = route != prev_route
    return torch.where(flip & ~allowed & (prev_route >= 0), prev_route, route)


def clamp_route_available(route, tier_ok):
    """Force routes off outaged tiers (``tier_ok`` (..., 2), <= 0 = down)."""
    route = torch.where(tier_ok[..., 1] > 0, route, torch.zeros_like(route))
    return torch.where(tier_ok[..., 0] > 0, route, torch.ones_like(route))


# ---------------------------------------------------------------------------
# Stage 1: adaptive edge-cloud configuration (Alg. 1)
# ---------------------------------------------------------------------------
def stage1_configure(lat: DecisionLattice, taus, difficulty, acc_req,
                     prev_route, prev_tau, rcfg: RouterConfig = RouterConfig(),
                     tier_ok=None):
    """Vectorized Alg. 1.  All inputs (M,).  Returns (route, r_idx) int64."""
    _no_tier_ok(tier_ok)
    sys = lat.sys
    f_edge_v1 = accuracy_stage1(sys, difficulty)                  # (M, N)
    feasible_edge = f_edge_v1 >= acc_req[:, None]
    # smallest feasible resolution (first True; argmax on int8 like jnp)
    first_ok = torch.argmax(feasible_edge.to(torch.int8), dim=1)
    any_ok = feasible_edge.any(dim=1)
    r_idx = torch.where(any_ok, first_ok, sys.n_res - 1)
    route = torch.where(any_ok, (taus > rcfg.tau_cloud).long(), 1)
    route = apply_temporal_consistency(route, prev_route, taus, prev_tau, rcfg)
    return route, r_idx


# ---------------------------------------------------------------------------
# C6 bandwidth repair
# ---------------------------------------------------------------------------
def enforce_bandwidth(lat: DecisionLattice, sol, difficulty, acc_req,
                      total_budget=None, rounds: int = 8, force: str = "auto",
                      task_mask=None):
    """Demote (r, p) of over-budget tasks with the largest reclaimable draw
    that stay feasible; ``rounds`` fixed top-k demotion rounds.

    Each round demotes, in descending-gain order (stable argsort), the
    prefix of tasks whose cumulative gain is still short of the excess.  A
    round runs unconditionally and its (r, p) are kept only while the
    repair is active and over budget, so no round reads a flag back to the
    host.  The budget sum is ``torch.sum`` over the (M,) draws: float32 in
    PyTorch's reduction order, not XLA's, so an excess within an ulp of 0
    can decide differently from the reference.  Returns
    ``(sol with repaired r/p, bw_history (rounds,))``.
    """
    if task_mask is not None:
        raise NotImplementedError("task_mask (churn) is ROADMAP queue A.10")
    sys = lat.sys
    budget = sys.total_bw_mbps if total_budget is None else total_budget
    dev = difficulty.device
    nz = sys.n_fps
    m = sol["r"].shape[0]
    # C6 never flips a route: the (M, N·Z) panel of each task's route is
    # round-invariant, built once
    bw_panel = torch.movedim(lat.bw, -1, 0)[sol["route"]].reshape(m, -1)
    acc_thr = acc_req + sys.acc_margin_robust
    rn = res_norm(sys, dev)
    pn = fps_norm(sys, dev)
    v32 = sol["v"].to(torch.int32)
    route32 = sol["route"].to(torch.int32)
    r, p = sol["r"], sol["p"]
    active = torch.ones((), dtype=torch.bool, device=dev)
    zero = torch.zeros((1,), dtype=torch.float32, device=dev)
    hist = []
    for _ in range(rounds):
        bw = bw_panel.gather(1, (r * nz + p)[:, None])[:, 0]
        excess = bw.sum() - budget
        hist.append(excess + budget)
        run = active & (excess > 0)
        _, gain, can_p = c6_tail(bw_panel, r.to(torch.int32),
                                 p.to(torch.int32), v32, route32, difficulty,
                                 acc_thr, rn, pn, n_fps=nz, force=force)
        order = torch.argsort(-gain, stable=True)
        gain_sorted = gain[order]
        cum_before = torch.cat([zero, torch.cumsum(gain_sorted, 0)[:-1]])
        demote_sorted = (cum_before < excess) & (gain_sorted > 0)
        demote = torch.zeros((m,), dtype=torch.bool, device=dev)
        demote[order] = demote_sorted
        r = torch.where(run & demote & ~can_p, torch.clamp_min(r - 1, 0), r)
        p = torch.where(run & demote & can_p, torch.clamp_min(p - 1, 0), p)
        active = run & demote.any()
    return dict(sol, r=r, p=p), torch.stack(hist)


# ---------------------------------------------------------------------------
# Streaming engine: stateful per-segment routing
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RouterState:
    """Carry of the streaming router: per-stream gate recurrence + history."""
    prev_route: torch.Tensor   # (M,) int64, -1 = no previous segment
    prev_tau: torch.Tensor     # (M,) float32
    gate: GateBatchState       # h (M, m), ring buffer + running Σ/Σ²


def init_router_state(gate_cfg: GateConfig, n_streams: int,
                      device="cuda") -> RouterState:
    dev = resolve_device(device)
    return RouterState(
        prev_route=torch.full((n_streams,), -1, dtype=torch.int64, device=dev),
        prev_tau=torch.zeros((n_streams,), dtype=torch.float32, device=dev),
        gate=init_batch_state(gate_cfg, n_streams, dev),
    )


def _two_stage_select(prob: RobustProblem, taus, difficulty, acc_req,
                      prev_route, prev_tau, rcfg: RouterConfig,
                      force: str = "auto", tier_ok=None):
    """Stage-1 → warm-started CCG → temporal consistency.  Returns the
    pre-C6 solution with tau / warm diagnostics."""
    _no_tier_ok(tier_ok)
    lat = prob.lat
    warm_route, warm_r = stage1_configure(
        lat, taus, difficulty, acc_req, prev_route, prev_tau, rcfg)
    # Stage-1 picks (route, r) at max fps: seed CCG with that configuration
    warm_y = lat.flatten_index(warm_route, warm_r, lat.sys.n_fps - 1)
    sol = solve_ccg_fused(prob, difficulty, acc_req, warm_y=warm_y,
                          force=force)
    route = apply_temporal_consistency(sol["route"], prev_route, taus,
                                       prev_tau, rcfg)
    sol = dict(sol, route=route)
    sol["tau"] = taus
    sol["warm_route"] = warm_route
    sol["warm_r"] = warm_r
    return sol


def route_segment(prob: RobustProblem, gate_cfg: GateConfig, gate_params,
                  state: RouterState, dx, difficulty, acc_req,
                  rcfg: RouterConfig = RouterConfig(), force: str = "auto",
                  tier_ok=None):
    """Per-stream portion of the step: gate → Stage-1 → CCG → temporal
    consistency.  Returns ``(new_gate, taus, sol)`` with the pre-repair
    solution.  ``state.gate``'s ring buffer is updated in place, so an
    unported option is refused before it."""
    _no_tier_ok(tier_ok)
    new_gate, (taus, _g_mean) = gate_step_batch(
        gate_cfg, gate_params, state.gate, dx, force=force)
    sol = _two_stage_select(prob, taus, difficulty, acc_req,
                            state.prev_route, state.prev_tau, rcfg,
                            force=force, tier_ok=tier_ok)
    return new_gate, taus, sol
