"""Two-stage robust optimization (paper §3.1/§3.3, Eq. 2-10, Alg. 2) —
port of ``repro/core/robust.py``: the pole set, :class:`RobustProblem`, the
fused CCG solve that serves every round, the unrolled solver
:func:`solve_ccg`, the stream-sharded :func:`solve_ccg_sharded` (:433) and
the brute-force :func:`exact_oracle`.

The Γ-budget uncertainty set U = { u : u_k = g_k·ũ_k, g_k∈[0,1], Σ g_k ≤ Γ }
scales the second-stage cost of model k by (1+u_k); its worst case sits at a
pole (Eq. 10), so the adversary enumerates the P subset poles with
|S| ≤ Γ.  :func:`solve_ccg_fused` runs the CCG alternation (Alg. 2) entirely
inside the ``ccg_solve`` kernel; :func:`solve_ccg` runs it as one
``ccg_encode`` call and min(max_iters, P+1) master steps, each a
``ccg_master`` call on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cost_model import SystemConfig
from repro_torch.core.lattice import BIG, DecisionLattice
from repro_torch.kernels.ccg_encode.ops import ccg_encode
from repro_torch.kernels.ccg_master.ops import ccg_master
from repro_torch.kernels.ccg_solve.ops import ccg_solve
from repro_torch.sharding.collectives import (
    all_gather,
    shard_count,
    shard_index,
)
from repro_torch.sharding.compat import pad_leading


def _poles(num_versions: int, gamma: int, device="cpu"):
    """All subset poles of U with |S| <= gamma: (P, K) in {0,1}, float32."""
    k = num_versions
    masks = []
    for bits in range(2 ** k):
        s = [(bits >> i) & 1 for i in range(k)]
        if sum(s) <= gamma:
            masks.append(s)
    return torch.tensor(masks, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class RobustProblem:
    """The lattice, the pole set and the task-independent recourse tables
    of the unrolled solver."""
    lat: DecisionLattice
    poles: torch.Tensor       # (P, K) pole indicators
    # (P, F, 2^K): min_v b2·(1+u_v) over the feasible-version subset encoded
    # as a bitmask, BIG for the empty subset (the plain encode gathers it)
    rec_table: torch.Tensor
    # (P, F, K) pole-scaled second-stage costs b2·(1+u), the unexpanded form
    # of the same lookup (the ccg_encode kernel min-folds it)
    b2_scaled: torch.Tensor

    @classmethod
    def build(cls, sys: SystemConfig, device="cuda") -> "RobustProblem":
        lat = DecisionLattice.build(sys, device)
        dev = lat.device
        poles = _poles(sys.num_versions, sys.gamma, dev)
        u_all = poles * lat.u_dev                                   # (P, K)
        b2_scaled = lat.b2_flat[None] * (1.0 + u_all[:, None, :])  # (P, F, K)
        k = sys.num_versions
        masks = ((torch.arange(2 ** k, device=dev)[:, None]
                  >> torch.arange(k, device=dev)[None]) & 1).bool()
        rec_table = torch.where(masks[None, None], b2_scaled[:, :, None, :],
                                BIG).amin(dim=-1)               # (P, F, 2^K)
        return cls(lat=lat, poles=poles, rec_table=rec_table,
                   b2_scaled=b2_scaled)

    @property
    def u_all(self) -> torch.Tensor:
        """(P, K) pole deviations poles · ũ."""
        return self.poles * self.lat.u_dev


def solve_ccg_fused(prob: RobustProblem, difficulty, acc_req,
                    max_iters: int = 8, theta: float = 1e-4, warm_y=None,
                    force: str = "auto", tier_ok=None):
    """Alg. 2 as one fused solve: encode → master argmin → SP pole → η update
    over min(max_iters, P+1) steps, in the ``ccg_solve`` kernel.

    difficulty/acc_req: (M,) float32; warm_y: optional (M,) flat warm
    starts (-1 = cold); tier_ok: optional (2,) per-tier availability,
    lowered to the kernel's (F,) ``y_ok``: an outaged tier's options are
    infeasible and out of the all-infeasible fallback.  Returns a dict of
    (M,) tensors: route/r/p/v (int64), o_up/o_down, iters, infeasible.
    """
    lat = prob.lat
    m = difficulty.shape[0]
    if warm_y is None:
        warm_y = torch.full((m,), -1, dtype=torch.int32, device=lat.device)
    y_f, v_star, o_up, o_down, iters, none_ok = ccg_solve(
        difficulty, acc_req, lat.rn_flat, lat.pn_flat, lat.tier_flat,
        lat.b2_flat, prob.u_all, lat.c1_flat, warm_y.to(torch.int32),
        margin=lat.sys.acc_margin_robust, num_versions=lat.sys.num_versions,
        max_iters=max_iters, theta=theta, force=force,
        y_ok=None if tier_ok is None else lat.tier_y_ok(tier_ok))
    route, r_idx, p_idx = lat.unflatten_index(y_f.long())
    return {
        "route": route, "r": r_idx, "p": p_idx, "v": v_star.long(),
        "o_up": o_up, "o_down": o_down, "iters": iters, "infeasible": none_ok,
    }


def _encode_tasks(prob: RobustProblem, difficulty, acc_req, tier_ok=None):
    """Table-based per-task CCG inputs, the encode oracle: the full (M, F, K)
    accuracy tensor, its feasibility, the first-stage mask and the recourse
    slab gathered at the subset codes.  Returns ``(f_flat, feas_f, fs_ok,
    rec_all)``, shapes ((M, F, K), (M, F, K), (M, F), (M, P, F))."""
    lat = prob.lat
    sys = lat.sys
    f_flat, feas_f = lat.feasible_flat(difficulty, acc_req,
                                       sys.acc_margin_robust, tier_ok=tier_ok)
    pow2 = 2 ** torch.arange(sys.num_versions, device=lat.device)
    code = (feas_f * pow2[None, None]).sum(dim=-1)            # (M, F)
    rec_all = torch.take_along_dim(
        prob.rec_table[None], code[:, None, :, None], dim=-1)[..., 0]
    return f_flat, feas_f, feas_f.any(dim=-1), rec_all


def _encode_tasks_fused(prob: RobustProblem, difficulty, acc_req,
                        force: str = "auto", tier_ok=None):
    """Table-free per-task CCG inputs through ``ccg_encode``: the (M, F)
    bitmask, the (M, P, F) recourse slab and the (M,) flat accuracy argmax,
    bit-identical to :func:`_encode_tasks`.  ``tier_ok``: optional (2,)
    per-tier availability, lowered to the kernel's (F,) ``y_ok``."""
    lat = prob.lat
    y_ok = None if tier_ok is None else lat.tier_y_ok(tier_ok)
    return ccg_encode(
        difficulty, acc_req, lat.rn_flat, lat.pn_flat, lat.tier_flat,
        prob.b2_scaled, prob.rec_table, margin=lat.sys.acc_margin_robust,
        num_versions=lat.sys.num_versions, force=force, y_ok=y_ok)


def _column(t, idx):
    """``t[m, :, idx[m]]`` for a (M, P, F) slab and (M,) indices: (M, P)."""
    return t.gather(2, idx[:, None, None].expand(-1, t.shape[1], 1))[..., 0]


def _finish_solution(prob: RobustProblem, code, best, rec_all, y_f):
    """Shared epilogue: v* at the worst pole of y_f, the all-infeasible
    fallback to the flat accuracy argmax, unflatten.  Returns
    ``(route, r, p, v, infeasible)``."""
    lat = prob.lat
    k = lat.sys.num_versions
    worst = _column(rec_all, y_f).argmax(dim=1)                  # (M,)
    u = prob.poles[worst] * lat.u_dev[None]                      # (M, K)
    code_y = code.gather(1, y_f[:, None])[:, 0]
    kbit = torch.arange(k, device=code.device)
    feas_y = ((code_y[:, None] >> kbit[None]) & 1) > 0
    vals = torch.where(feas_y, lat.b2_flat[y_f] * (1.0 + u), BIG)
    v_star = vals.argmin(dim=1)
    none_ok = ~(code > 0).any(dim=1)
    best = best.long()
    y_f = torch.where(none_ok, best // k, y_f)
    v_star = torch.where(none_ok, best % k, v_star)
    route, r_idx, p_idx = lat.unflatten_index(y_f)
    return route, r_idx, p_idx, v_star, none_ok


def solve_ccg(prob: RobustProblem, difficulty, acc_req, max_iters: int = 8,
              theta: float = 1e-4, warm_y=None, force: str = "auto",
              tier_ok=None, slab_master: bool | None = None):
    """Alg. 2 for a batch of tasks, unrolled: one encode, then
    min(max_iters, P+1) masked master/adversary steps over the whole batch,
    a ``done`` flag freezing converged lanes.  Decisions, bounds and
    iteration counts are bit-identical to :func:`solve_ccg_fused`.

    difficulty/acc_req: (M,) float32; warm_y: optional (M,) flat warm starts
    (-1 = cold): a usable one seeds the scenario set with its worst pole and
    O_up with its robust cost.  ``tier_ok``: optional (2,) availability,
    which becomes the encode's ``y_ok``.  ``force`` pins both kernels.

    The master step is either the slab form (``ccg_master`` over the
    (M, P, F) slab and an (M, P) scenario mask) or the running-η form (an
    (M, F) max folded in as each pole is generated; max is exact, so both
    give the same bits).  ``slab_master=None`` picks the slab form when
    ``force != "auto"`` or on the card, and the running form for ``"auto"``
    on the CPU, as the reference picks it by backend.  Returns a dict of
    (M,) tensors: route/r/p/v (int64), o_up/o_down, iters, infeasible.
    """
    lat = prob.lat
    dev = lat.device
    c1 = lat.c1_flat
    code, rec_all, best = _encode_tasks_fused(prob, difficulty, acc_req,
                                              force=force, tier_ok=tier_ok)
    fs_ok = code > 0                                           # (M, F)
    m = code.shape[0]
    n_poles = prob.poles.shape[0]
    if warm_y is None:
        warm_y = torch.full((m,), -1, dtype=torch.int64, device=dev)
    warm_y = warm_y.long()
    if slab_master is None:
        slab_master = force != "auto" or dev.type == "cuda"

    # warm start: the warm y's worst pole and its robust cost
    wy = torch.clamp_min(warm_y, 0)
    use_warm = (warm_y >= 0) & fs_ok.gather(1, wy[:, None])[:, 0]
    rec_wy = _column(rec_all, wy)                               # (M, P)
    q_w, warm_pole = rec_wy.max(dim=1)
    o_up = torch.where(use_warm, c1[wy] + q_w, BIG)
    o_down = torch.full((m,), -BIG, dtype=torch.float32, device=dev)
    y_best = wy
    done = torch.zeros((m,), dtype=torch.bool, device=dev)
    iters = torch.zeros((m,), dtype=torch.int32, device=dev)

    pole_iota = torch.arange(n_poles, device=dev)[None, :]      # (1, P)
    if slab_master:
        scen_mask = (use_warm[:, None] & (pole_iota == warm_pole[:, None])
                     ).to(torch.float32)
    else:
        rec_warm = rec_all.gather(
            1, warm_pole[:, None, None].expand(-1, 1, rec_all.shape[2]))[:, 0]
        eta_run = torch.where(use_warm[:, None], rec_warm, -BIG)
        has_scen = use_warm

    for _ in range(min(max_iters, n_poles + 1)):
        live = ~done
        # MP1: argmin over feasible y of c1 + η(y)
        if slab_master:
            y_star, od_new = ccg_master(rec_all, scen_mask, fs_ok, c1,
                                        force=force)
            y_star = y_star.long()
        else:
            eta = torch.where(has_scen[:, None], eta_run, 0.0)
            obj = torch.where(fs_ok, c1[None] + eta, BIG)
            od_new, y_star = obj.min(dim=1)
        # SP: the exact worst pole of y_star (Eq. 10)
        q, worst_pole = _column(rec_all, y_star).max(dim=1)
        cand = c1[y_star] + q
        # the decision is the incumbent achieving O_up, not the last argmin
        up_new = torch.minimum(o_up, cand)
        y_best = torch.where(live & (cand < o_up), y_star, y_best)
        o_down = torch.where(live, od_new, o_down)
        o_up = torch.where(live, up_new, o_up)
        if slab_master:
            new_col = (pole_iota == worst_pole[:, None]).to(torch.float32)
            mask_new = torch.maximum(scen_mask, new_col)
            scen_mask = torch.where(live[:, None], mask_new, scen_mask)
        else:
            rec_new = rec_all.gather(1, worst_pole[:, None, None].expand(
                -1, 1, rec_all.shape[2]))[:, 0]                 # (M, F)
            eta_run = torch.where(live[:, None],
                                  torch.maximum(eta_run, rec_new), eta_run)
            has_scen = has_scen | live
        iters = iters + live.to(torch.int32)
        done = torch.where(live, (up_new - od_new) <= theta, done)

    route, r_idx, p_idx, v_star, none_ok = _finish_solution(
        prob, code, best, rec_all, y_best)
    return {
        "route": route, "r": r_idx, "p": p_idx, "v": v_star,
        "o_up": o_up, "o_down": o_down, "iters": iters, "infeasible": none_ok,
    }


def solve_ccg_sharded(prob: RobustProblem, difficulty, acc_req, mesh,
                      axis: str = "data", max_iters: int = 8,
                      theta: float = 1e-4, warm_y=None, force: str = "auto"):
    """:func:`solve_ccg_fused` with the task batch split over the ranks of
    ``mesh`` along ``axis``: every rank passes the same full (M,) inputs,
    solves its own slice and the slices are all-gathered back, so every
    rank returns the whole solution.  M pads to a multiple of the shard
    count with the reference's dummies (difficulty and requirement 0, warm
    start -1) that are sliced off.  The solve is per task, so the
    decisions are the unsharded solve's."""
    m = difficulty.shape[0]
    n_dev = shard_count(mesh, axis)
    pad = (-m) % n_dev
    m_l = (m + pad) // n_dev
    start = shard_index(mesh, axis) * m_l
    if warm_y is None:
        warm_y = torch.full((m,), -1, dtype=torch.int64,
                            device=difficulty.device)
    local = lambda x, value=0: pad_leading(x, pad, value)[start:start + m_l]
    sol = solve_ccg_fused(prob, local(difficulty), local(acc_req),
                          max_iters=max_iters, theta=theta,
                          warm_y=local(warm_y, -1), force=force)
    return {k: all_gather(v, mesh, axis)[:m] for k, v in sol.items()}


def exact_oracle(prob: RobustProblem, difficulty, acc_req, tier_ok=None):
    """Brute force min_y max_{u∈poles} min_v -> ((M,) flat y, (M,) robust
    objective); a test oracle."""
    lat = prob.lat
    _, feas_f = lat.feasible_flat(difficulty, acc_req,
                                  lat.sys.acc_margin_robust, tier_ok=tier_ok)
    u = prob.poles[:, None, :] * lat.u_dev                      # (P, 1, K)
    vals = torch.where(feas_f[:, None],
                       (lat.b2_flat[None] * (1.0 + u))[None], BIG)
    worst = vals.amin(dim=-1).amax(dim=1)                       # (M, F)
    obj = torch.where(feas_f.any(dim=-1), lat.c1_flat + worst, BIG)
    best, y = obj.min(dim=1)
    return y, best


def total_cost(prob: RobustProblem, sol, difficulty, acc_req, u=None):
    """Realized cost of a solution under deviation u ((K,) or None for the
    nominal cost)."""
    return prob.lat.solution_cost(sol, u=u)
