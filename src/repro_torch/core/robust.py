"""Two-stage robust optimization (paper §3.1/§3.3, Eq. 2-10, Alg. 2) —
port of ``repro/core/robust.py``: the pole set, :class:`RobustProblem` and
the fused CCG solve that serves every round.

The Γ-budget uncertainty set U = { u : u_k = g_k·ũ_k, g_k∈[0,1], Σ g_k ≤ Γ }
scales the second-stage cost of model k by (1+u_k); its worst case sits at a
pole (Eq. 10), so the adversary enumerates the P subset poles with
|S| ≤ Γ, and the CCG alternation (Alg. 2) runs entirely inside the
``ccg_solve`` kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cost_model import SystemConfig
from repro_torch.core.lattice import DecisionLattice
from repro_torch.kernels.ccg_solve.ops import ccg_solve


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
    """The lattice and the pole set.

    The reference also carries ``rec_table`` and ``b2_scaled``; they feed
    only its unrolled oracle solver ``solve_ccg`` (ROADMAP queue A.12) and
    are left out here."""
    lat: DecisionLattice
    poles: torch.Tensor     # (P, K) pole indicators

    @classmethod
    def build(cls, sys: SystemConfig, device="cuda") -> "RobustProblem":
        lat = DecisionLattice.build(sys, device)
        return cls(lat=lat, poles=_poles(sys.num_versions, sys.gamma,
                                         lat.device))

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
    starts (-1 = cold).  Returns a dict of (M,) tensors: route/r/p/v
    (int64), o_up/o_down, iters, infeasible.
    """
    if tier_ok is not None:
        raise NotImplementedError(
            "tier_ok (scenario outages) is ROADMAP queue A.9")
    lat = prob.lat
    m = difficulty.shape[0]
    if warm_y is None:
        warm_y = torch.full((m,), -1, dtype=torch.int32, device=lat.device)
    y_f, v_star, o_up, o_down, iters, none_ok = ccg_solve(
        difficulty, acc_req, lat.rn_flat, lat.pn_flat, lat.tier_flat,
        lat.b2_flat, prob.u_all, lat.c1_flat, warm_y.to(torch.int32),
        margin=lat.sys.acc_margin_robust, num_versions=lat.sys.num_versions,
        max_iters=max_iters, theta=theta, force=force)
    route, r_idx, p_idx = lat.unflatten_index(y_f.long())
    return {
        "route": route, "r": r_idx, "p": p_idx, "v": v_star.long(),
        "o_up": o_up, "o_down": o_down, "iters": iters, "infeasible": none_ok,
    }
