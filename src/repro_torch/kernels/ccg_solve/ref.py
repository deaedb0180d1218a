"""Plain PyTorch version of the fully fused CCG solve (paper Alg. 2), port
of ``repro/kernels/ccg_solve/ref.py``.

The alternation runs as a masked full unroll of min(max_iters, P+1) steps
over the whole batch: a done lane is frozen by live-gating every state write,
which is exact by the reference kernel's own contract.  The reference ref's
live-lane compaction is an optimisation and is not carried over.  Every
argmin/argmax is min/max followed by the first index achieving it, and every
recourse value is a K-fold masked min over the (F, K) costs, so the CUDA
kernel (``csrc/ccg_solve.cu``) reproduces these float32 operations one for
one.
"""
from __future__ import annotations

import torch

from repro_torch.core.cost_model import _accuracy_formula
from repro_torch.core.lattice import BIG


def _first_index(mask, size: int):
    """Index of the first True per row (``size`` where none is)."""
    iota = torch.arange(size, device=mask.device)
    return torch.where(mask, iota[None], size).amin(dim=1)


def ccg_solve_ref(z, aq, rn_flat, pn_flat, tier_flat, b2_flat, u_all, c1,
                  warm_y, margin: float, num_versions: int, max_iters: int,
                  theta: float, y_ok=None):
    """Fused CCG solve for a task batch.

    z/aq: (M,) difficulty and accuracy requirement; rn/pn/tier_flat: (F,)
    normalized option coordinates; b2_flat: (F, K); u_all: (P, K) pole
    deviations; c1: (F,); warm_y: (M,) flat warm starts (-1 = cold);
    y_ok: optional (F,) availability mask.

    Returns ``(y_f, v_star, o_up, o_down, iters, infeasible)``: int32 flat
    option and version (all-infeasible fallback applied), float32 bounds,
    int32 iteration counts and a bool infeasibility flag, all (M,).
    """
    dev = z.device
    m = z.shape[0]
    F = rn_flat.shape[0]
    K = num_versions
    P = u_all.shape[0]
    opu = 1.0 + u_all                                     # (P, K)

    # ---- encode: feasibility bitmask + flat accuracy argmax, K-folded ----
    z2 = z[:, None]
    thr = (aq + margin)[:, None]
    rn, pn, tf = rn_flat[None, :], pn_flat[None, :], tier_flat[None, :]
    okm = None if y_ok is None else (y_ok > 0)[None, :]
    code = torch.zeros((m, F), dtype=torch.int32, device=dev)
    bv = bk = None
    for k in range(K):
        kf = torch.full((), float(k), dtype=torch.float32, device=dev)
        f_k = _accuracy_formula(z2, rn, pn, kf, tf)               # (M, F)
        if okm is not None:
            f_k = torch.where(okm, f_k, -BIG)
        code = code | torch.where(f_k >= thr, 1 << k, 0).to(torch.int32)
        if k == 0:
            bv = f_k
            bk = torch.zeros((m, F), dtype=torch.int64, device=dev)
        else:
            up = f_k > bv
            bv = torch.where(up, f_k, bv)
            bk = torch.where(up, k, bk)
    bmax = bv.amax(dim=1)
    by = _first_index(bv == bmax[:, None], F)
    best = by * K + bk.gather(1, by[:, None])[:, 0]
    fs_ok = code > 0                                      # (M, F)

    def sp_at(y):
        """(M, P) recourse of option y at every pole."""
        b2y = b2_flat[y]                                  # (M, K)
        cy = code.gather(1, y[:, None])[:, 0]
        sp = torch.full((m, P), BIG, dtype=torch.float32, device=dev)
        for k in range(K):
            term = b2y[:, k][:, None] * opu[None, :, k]   # (M, P)
            bit = ((cy >> k) & 1) > 0
            sp = torch.where(bit[:, None], torch.minimum(sp, term), sp)
        return sp

    def rec_at(pole):
        """(M, F) recourse row of each lane's pole."""
        uw = opu[pole]                                    # (M, K)
        rec = torch.full((m, F), BIG, dtype=torch.float32, device=dev)
        for k in range(K):
            term = b2_flat[None, :, k] * uw[:, k][:, None]
            bit = ((code >> k) & 1) > 0
            rec = torch.where(bit, torch.minimum(rec, term), rec)
        return rec

    def worst(sp):
        q = sp.amax(dim=1)
        return q, _first_index(sp == q[:, None], P)

    # ---- warm start: seed the scenario set with the warm y's worst pole ----
    warm_y = warm_y.to(torch.int64)
    wyc = torch.clamp_min(warm_y, 0)
    use_warm = (warm_y >= 0) & fs_ok.gather(1, wyc[:, None])[:, 0]
    q_w, warm_pole = worst(sp_at(wyc))
    o_up = torch.where(use_warm, c1[wyc] + q_w, BIG)
    eta_run = torch.where(use_warm[:, None], rec_at(warm_pole), 0.0)
    o_down = torch.full((m,), -BIG, dtype=torch.float32, device=dev)
    y_best = wyc
    iters = torch.zeros((m,), dtype=torch.int32, device=dev)
    done = torch.zeros((m,), dtype=torch.bool, device=dev)

    # ---- masked CCG alternation (done lanes frozen) ----
    for _ in range(min(max_iters, P + 1)):
        live = ~done
        obj = torch.where(fs_ok, c1[None, :] + eta_run, BIG)
        od_new = obj.amin(dim=1)
        y_star = _first_index(obj == od_new[:, None], F)
        q, worst_pole = worst(sp_at(y_star))
        cand = c1[y_star] + q
        up_new = torch.minimum(o_up, cand)
        # the decision is the incumbent achieving O_up, not the last argmin
        y_best = torch.where(live & (cand < o_up), y_star, y_best)
        o_down = torch.where(live, od_new, o_down)
        o_up = torch.where(live, up_new, o_up)
        eta_run = torch.maximum(eta_run, rec_at(worst_pole))
        iters = iters + live.to(torch.int32)
        done = torch.where(live, (up_new - od_new) <= theta, done)

    # ---- epilogue: final worst pole, v*, all-infeasible fallback ----
    _, wp = worst(sp_at(y_best))
    u = u_all[wp]                                         # (M, K)
    code_y = code.gather(1, y_best[:, None])[:, 0]
    kbit = torch.arange(K, device=dev)
    feas_y = ((code_y[:, None] >> kbit[None]) & 1) > 0
    vals = torch.where(feas_y, b2_flat[y_best] * (1.0 + u), BIG)
    vmin = vals.amin(dim=1)
    v_star = _first_index(vals == vmin[:, None], K)
    none_ok = ~fs_ok.any(dim=1)
    y_f = torch.where(none_ok, best // K, y_best)
    v_star = torch.where(none_ok, best % K, v_star)
    return (y_f.to(torch.int32), v_star.to(torch.int32), o_up, o_down, iters,
            none_ok)
