"""R2E-VID two-stage router (paper Alg. 1 + Alg. 2 glue) — port of
``repro/core/router.py``: the streaming path (:48-351), the hierarchical
C6 sub-budgets of the sharded session (``subbudget_from_stats`` :206,
``shard_bandwidth_target`` :236), the stateful step
``route_step`` and its scan ``route_scan`` (:351-420) and the windowed,
stateless ``route`` (:478-516).

Stage 1 (Alg. 1) picks the smallest edge resolution whose smallest model
meets the accuracy requirement, escalates to cloud on the gate score τ or
when no edge config is feasible, and keeps the temporal-consistency
constraint; Stage 2 (Alg. 2) is the warm-started fused CCG solve; the C6
bandwidth budget is enforced by a fixed-round top-k demotion repair, the
``c6_repair`` kernel.

Every step runs on the device without reading back to the host.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cost_model import accuracy_stage1, fps_norm, res_norm
from repro_torch.core.gating import (
    GateBatchState,
    GateConfig,
    gate_step_batch,
    gate_window_scan,
    init_batch_state,
)
from repro_torch.core.lattice import DecisionLattice
from repro_torch.core.robust import RobustProblem, solve_ccg_fused
from repro_torch.device import resolve_device
from repro_torch.kernels.c6_tail.ops import c6_repair
from repro_torch.sharding.collectives import all_gather, shard_index


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    tau_cloud: float = 0.55       # Stage-1 warm-start cloud threshold
    delta0: float = 0.0           # temporal consistency: δ(x) = δ0 + δ1·x
    delta1: float = 4.0
    repair_rounds: int = 8        # C6 demotion passes


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
    """Force routes off outaged tiers (``tier_ok`` (..., 2), <= 0 = down).
    Availability beats every other constraint, temporal consistency
    included, so this runs last; edge-down wins when both are down."""
    route = torch.where(tier_ok[..., 1] > 0, route, torch.zeros_like(route))
    return torch.where(tier_ok[..., 0] > 0, route, torch.ones_like(route))


# ---------------------------------------------------------------------------
# Stage 1: adaptive edge-cloud configuration (Alg. 1)
# ---------------------------------------------------------------------------
def stage1_configure(lat: DecisionLattice, taus, difficulty, acc_req,
                     prev_route, prev_tau, rcfg: RouterConfig = RouterConfig(),
                     tier_ok=None):
    """Vectorized Alg. 1.  All inputs (M,).  Returns (route, r_idx) int64.
    ``tier_ok``: optional (2,) tier availability; an outaged tier is never
    selected (clamped after temporal consistency)."""
    sys = lat.sys
    f_edge_v1 = accuracy_stage1(sys, difficulty)                  # (M, N)
    feasible_edge = f_edge_v1 >= acc_req[:, None]
    # smallest feasible resolution (first True; argmax on int8 like jnp)
    first_ok = torch.argmax(feasible_edge.to(torch.int8), dim=1)
    any_ok = feasible_edge.any(dim=1)
    r_idx = torch.where(any_ok, first_ok, sys.n_res - 1)
    route = torch.where(any_ok, (taus > rcfg.tau_cloud).long(), 1)
    route = apply_temporal_consistency(route, prev_route, taus, prev_tau, rcfg)
    if tier_ok is not None:
        route = clamp_route_available(route, tier_ok)
    return route, r_idx


# ---------------------------------------------------------------------------
# C6 bandwidth repair
# ---------------------------------------------------------------------------
def enforce_bandwidth(lat: DecisionLattice, sol, difficulty, acc_req,
                      total_budget=None, rounds: int = 8, force: str = "auto",
                      task_mask=None):
    """Demote (r, p) of over-budget tasks with the largest reclaimable draw
    that stay feasible; ``rounds`` fixed top-k demotion rounds.

    Each round demotes, in descending-gain order, the prefix of tasks whose
    cumulative gain is still short of the excess; a round after the repair
    stopped demoting, or after the budget held, changes nothing and records
    the same draw.  The rounds are ``c6_repair``: one kernel launch for all
    of them on the card, nothing read back to the host.  ``total_budget``
    is a float or a 0-d tensor on the device.  ``task_mask``: optional (M,)
    bool alive mask (slot-pool churn): dead lanes add 0 to the draw and are
    never demoted, so the repair is the repair on the compacted alive
    batch.  Returns ``(sol with repaired r/p, bw_history (rounds,))``.
    """
    sys = lat.sys
    budget = sys.total_bw_mbps if total_budget is None else total_budget
    dev = difficulty.device
    m = sol["r"].shape[0]
    # C6 never flips a route: the (M, N·Z) panel of each task's route is
    # round-invariant, built once
    bw_panel = torch.movedim(lat.bw, -1, 0)[sol["route"]].reshape(m, -1)
    r, p, hist = c6_repair(bw_panel, sol["r"], sol["p"], sol["v"],
                           sol["route"], difficulty,
                           acc_req + sys.acc_margin_robust, res_norm(sys, dev),
                           fps_norm(sys, dev), budget, n_fps=sys.n_fps,
                           rounds=rounds, force=force, task_mask=task_mask)
    return dict(sol, r=r, p=p), hist


def subbudget_from_stats(bw_d, w_d, budget):
    """Per-shard C6 sub-budgets from the fleet's (draw, weight) vectors.

    ``bw_d``: (D,) each shard's pre-repair bandwidth draw; ``w_d``: (D,)
    each shard's alive-lane weight; ``budget``: the global C6 budget B (a
    float or a 0-d tensor).  The fair share is weight-proportional; a shard
    under it keeps its whole draw and grants its headroom to the shards
    over theirs, so only the true global shortfall max(Σbw − B, 0) is
    demoted, pro-rated over the shards that own excess:

        fair_d   = B · w_d / Σw
        excess_d = max(bw_d − fair_d, 0);  head_d = max(fair_d − bw_d, 0)
        target_d = bw_d − excess_d · max(Σexcess − Σhead, 0) / Σexcess

    The targets sum to min(Σbw, B); with one shard, min(bw, B).  float32,
    in the reference's order of operations.
    """
    bw_d = torch.as_tensor(bw_d, dtype=torch.float32)
    w_d = torch.as_tensor(w_d, dtype=torch.float32, device=bw_d.device)
    fair = budget * w_d / torch.clamp_min(w_d.sum(), 1e-9)
    excess = torch.clamp_min(bw_d - fair, 0.0)
    head = torch.clamp_min(fair - bw_d, 0.0)
    shortfall = torch.clamp_min(excess.sum() - head.sum(), 0.0)
    scale = shortfall / torch.clamp_min(excess.sum(), 1e-9)
    return bw_d - excess * scale


def shard_bandwidth_target(local_bw, local_weight, budget, mesh,
                           axis: str = "data"):
    """This shard's C6 repair target from one exchange of two scalars a
    shard: the (draw, weight) of every shard along ``axis`` of ``mesh`` is
    all-gathered (the only traffic the hierarchical repair makes) and this
    shard's :func:`subbudget_from_stats` entry returned, a 0-d tensor."""
    stats = torch.stack([local_bw.to(torch.float32),
                         local_weight.to(torch.float32)])
    stats = all_gather(stats[None], mesh, axis)                 # (D, 2)
    target = subbudget_from_stats(stats[:, 0], stats[:, 1], budget)
    return target[shard_index(mesh, axis)]


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
    pre-C6 solution with tau / warm diagnostics.  ``tier_ok``: optional
    (2,) tier availability: outaged tiers are infeasible in the CCG solve
    and clamped away after temporal consistency."""
    lat = prob.lat
    warm_route, warm_r = stage1_configure(
        lat, taus, difficulty, acc_req, prev_route, prev_tau, rcfg,
        tier_ok=tier_ok)
    # Stage-1 picks (route, r) at max fps: seed CCG with that configuration
    warm_y = lat.flatten_index(warm_route, warm_r, lat.sys.n_fps - 1)
    sol = solve_ccg_fused(prob, difficulty, acc_req, warm_y=warm_y,
                          force=force, tier_ok=tier_ok)
    route = apply_temporal_consistency(sol["route"], prev_route, taus,
                                       prev_tau, rcfg)
    if tier_ok is not None:
        route = clamp_route_available(route, tier_ok)
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
    solution.  ``state.gate``'s ring buffer is updated in place."""
    new_gate, (taus, _g_mean) = gate_step_batch(
        gate_cfg, gate_params, state.gate, dx, force=force)
    sol = _two_stage_select(prob, taus, difficulty, acc_req,
                            state.prev_route, state.prev_tau, rcfg,
                            force=force, tier_ok=tier_ok)
    return new_gate, taus, sol


def route_step(prob: RobustProblem, gate_cfg: GateConfig, gate_params,
               state: RouterState, dx, difficulty, acc_req,
               rcfg: RouterConfig = RouterConfig(), force: str = "auto",
               tier_ok=None):
    """One streaming step: (state, segment batch) -> (state, sol).

    :func:`route_segment` (gate, Stage 1, warm CCG, temporal consistency),
    then the C6 repair against the nominal budget.  dx: (M, d) features of
    this segment; difficulty / acc_req: (M,).  ``state``'s ring buffer is
    written in place (the reference donates the state): thread the
    returned state, never the old one.  ``sol`` carries the repair's
    ``bw_history``."""
    new_gate, taus, sol = route_segment(prob, gate_cfg, gate_params, state,
                                        dx, difficulty, acc_req, rcfg,
                                        force=force, tier_ok=tier_ok)
    sol, bw_hist = enforce_bandwidth(prob.lat, sol, difficulty, acc_req,
                                     rounds=rcfg.repair_rounds, force=force)
    sol["bw_history"] = bw_hist
    return RouterState(prev_route=sol["route"], prev_tau=taus,
                       gate=new_gate), sol


def route_scan(prob: RobustProblem, gate_cfg: GateConfig, gate_params,
               state: RouterState, dx_seq, difficulty, acc_req,
               rcfg: RouterConfig = RouterConfig(), force: str = "auto"):
    """:func:`route_step` over S segments -> (state, sols stacked to (S,
    ...)).  dx_seq: (S, M, d); difficulty / acc_req: (M,) or (S, M).  A
    session's ``route_many`` is the same scan replayed as a CUDA graph
    that the session keeps across calls."""
    s = dx_seq.shape[0]
    if difficulty.dim() == 1:
        difficulty = torch.broadcast_to(difficulty, (s,) + difficulty.shape)
    if acc_req.dim() == 1:
        acc_req = torch.broadcast_to(acc_req, (s,) + acc_req.shape)
    sols = []
    for i in range(s):
        state, sol = route_step(prob, gate_cfg, gate_params, state,
                                dx_seq[i], difficulty[i], acc_req[i], rcfg,
                                force=force)
        sols.append(sol)
    return state, {k: torch.stack([x[k] for x in sols]) for k in sols[0]}


def route(prob: RobustProblem, gate_cfg: GateConfig, gate_params,
          dx_segments, difficulty, acc_req, prev_route=None, prev_tau=None,
          rcfg: RouterConfig = RouterConfig(), force: str = "auto",
          tier_ok=None):
    """Windowed, stateless routing: :func:`gate_window_scan` over the
    (M, T, d) feature window from a fresh gate state, the last step's τ,
    then the same two-stage selection and C6 repair as the streaming step.
    ``prev_route`` defaults to -1 (no history), ``prev_tau`` to 0."""
    m = dx_segments.shape[0]
    dev = dx_segments.device
    if prev_route is None:
        prev_route = torch.full((m,), -1, dtype=torch.int64, device=dev)
    if prev_tau is None:
        prev_tau = torch.zeros((m,), dtype=torch.float32, device=dev)
    taus_seq, _, _ = gate_window_scan(gate_cfg, gate_params, dx_segments,
                                      force=force)
    taus = taus_seq[:, -1]
    sol = _two_stage_select(prob, taus, difficulty, acc_req, prev_route,
                            prev_tau, rcfg, force=force, tier_ok=tier_ok)
    sol, bw_hist = enforce_bandwidth(prob.lat, sol, difficulty, acc_req,
                                     rounds=rcfg.repair_rounds, force=force)
    sol["bw_history"] = bw_hist
    return sol
