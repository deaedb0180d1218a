"""Plain PyTorch versions of the fused C6 repair tail (one demotion round's
per-task gains), port of ``repro/kernels/c6_tail/ref.py``, and of the whole
repair around it (``repro/core/router.py:enforce_bandwidth``'s rounds)."""
from __future__ import annotations

import torch

from repro_torch.core.cost_model import _accuracy_formula
from repro_torch.core.lattice import BIG


def c6_tail_ref(bw_panel, r, p, v, route, z, acc_thr, rn, pn, n_fps: int):
    """One repair round's demotion candidates for a task batch.

    bw_panel: (M, N·Z) route-indexed bandwidth panel (flat r·Z + p minor);
    r/p/v/route: (M,) integer decisions; z: (M,) difficulty; acc_thr: (M,)
    accuracy floor (A^q + robust margin); rn: (N,) / pn: (Z,) normalized
    coordinates.

    Returns ``(bw, gain, can_p)``: the current draw, the bandwidth the
    preferred feasible demotion reclaims (-BIG when neither the fps nor the
    resolution demotion stays feasible), and whether it is the fps drop.
    """
    r = r.long()
    p = p.long()

    def take_bw(ri, pi):
        return bw_panel.gather(1, (ri * n_fps + pi)[:, None])[:, 0]

    bw = take_bw(r, p)
    p_dn = torch.clamp_min(p - 1, 0)
    r_dn = torch.clamp_min(r - 1, 0)
    vf = v.to(torch.float32)
    tf = route.to(torch.float32)
    f_pdn = _accuracy_formula(z, rn[r], pn[p_dn], vf, tf)
    f_rdn = _accuracy_formula(z, rn[r_dn], pn[p], vf, tf)
    can_p = (p > 0) & (f_pdn >= acc_thr)
    can_r = (r > 0) & (f_rdn >= acc_thr)
    gain_p = bw - take_bw(r, p_dn)
    gain_r = bw - take_bw(r_dn, p)
    gain = torch.where(can_p, gain_p, torch.where(can_r, gain_r, -BIG))
    return bw, gain, can_p


SCAN_ROW = 1024     # entries a row of prefix_sum's scan on CUDA


def prefix_sum(x):
    """``torch.cumsum(x, 0)`` of a 1-D float tensor, with the same bits on
    every call.  On the CPU torch's own scan, which runs in order.  On
    CUDA torch scans a 1-D tensor in one pass whose float association
    depends on which tiles' sums are ready first, so a call may give other
    bits than the last (on an H100 every one of 100 calls at 262,144
    entries differed from the first), and a repair could demote a task at
    the boundary on one call and not on the next.  There the entries are
    scanned in rows of ``SCAN_ROW`` (a scan along a tensor's last dim with
    at least two rows: each row in a fixed order), the rows' totals
    scanned the same way, and each row's prefix added
    (:func:`row_scan`)."""
    return row_scan(x) if x.device.type == "cuda" else torch.cumsum(x, 0)


def row_scan(x):
    """The inclusive prefix sum of a 1-D tensor by rows of ``SCAN_ROW``
    (:func:`prefix_sum`'s order on CUDA; on any device)."""
    n = x.shape[0]
    rows = max(2, -(-n // SCAN_ROW))
    pad = torch.zeros(rows * SCAN_ROW, dtype=x.dtype, device=x.device)
    pad[:n] = x
    scan = pad.view(rows, SCAN_ROW).cumsum(1)
    totals = torch.stack([scan[:, -1], torch.zeros_like(scan[:, -1])])
    ends = totals.cumsum(1)[0]                      # each row's inclusive end
    before = torch.cat([ends.new_zeros(1), ends[:-1]])
    return (scan + before[:, None]).reshape(-1)[:n]


def repair_rounds(tail, bw_panel, r, p, v, route, z, acc_thr, rn, pn, budget,
                  n_fps: int, rounds: int, task_mask=None):
    """``rounds`` C6 demotion rounds with ``tail`` (``c6_tail_ref`` or the
    ``c6_tail`` kernel) for each round's gains -> (r, p, bw_history).

    Each round demotes, in descending-gain order (stable argsort), the
    prefix of tasks whose cumulative gain is still short of the excess
    over ``budget`` (a float or a 0-d tensor).  A round runs
    unconditionally and its (r, p) are kept only while the repair is
    active and over budget, so no round reads a flag back to the host: the
    reference's ``lax.cond`` skip, exact because a skipped round is a
    no-op.  The budget sum is ``torch.sum`` over the (M,) draws and the
    prefix :func:`prefix_sum`: float32 in PyTorch's order, not XLA's, and
    the same bits on every call.
    ``task_mask``: optional (M,) bool alive mask; a dead lane draws 0 and
    its gain is 0, so it is never demoted (the reference's masked repair).
    """
    dev = bw_panel.device
    m = r.shape[0]
    dtype = r.dtype
    r, p = r.long(), p.long()
    v32 = v.to(torch.int32)
    route32 = route.to(torch.int32)
    active = torch.ones((), dtype=torch.bool, device=dev)
    zero = torch.zeros((1,), dtype=torch.float32, device=dev)
    hist = []
    for _ in range(rounds):
        bw = bw_panel.gather(1, (r * n_fps + p)[:, None])[:, 0]
        if task_mask is not None:
            bw = torch.where(task_mask, bw, 0.0)
        excess = bw.sum() - budget
        hist.append(excess + budget)
        run = active & (excess > 0)
        _, gain, can_p = tail(bw_panel, r.to(torch.int32), p.to(torch.int32),
                              v32, route32, z, acc_thr, rn, pn, n_fps=n_fps)
        if task_mask is not None:
            gain = torch.where(task_mask, gain, 0.0)
        order = torch.argsort(-gain, stable=True)
        gain_sorted = gain[order]
        cum_before = torch.cat([zero, prefix_sum(gain_sorted)[:-1]])
        demote_sorted = (cum_before < excess) & (gain_sorted > 0)
        demote = torch.zeros((m,), dtype=torch.bool, device=dev)
        demote[order] = demote_sorted
        r = torch.where(run & demote & ~can_p, torch.clamp_min(r - 1, 0), r)
        p = torch.where(run & demote & can_p, torch.clamp_min(p - 1, 0), p)
        active = run & demote.any()
    hist = torch.stack(hist) if hist else torch.zeros((0,), device=dev)
    return r.to(dtype), p.to(dtype), hist


def c6_repair_ref(bw_panel, r, p, v, route, z, acc_thr, rn, pn, budget,
                  n_fps: int, rounds: int, task_mask=None):
    """Plain version of the whole C6 repair: :func:`repair_rounds` with the
    plain tail.  Returns (r, p) in the dtype of the given r and p, and the
    draw of each round before its demotion (rounds,)."""
    return repair_rounds(c6_tail_ref, bw_panel, r, p, v, route, z, acc_thr,
                         rn, pn, budget, n_fps, rounds, task_mask)


EPS = 2.0 ** -24    # float32 unit roundoff


def repair_boundary(bw_panel, r, p, v, route, z, acc_thr, rn, pn, budget,
                    n_fps: int, task_mask=None):
    """The tasks whose demotion in the round from (r, p) two orders of the
    float32 sums may decide differently: a positive gain whose exclusive
    prefix (float64, stable descending order) lies within
    2·M·ε·Σ bw + 2·n·ε·Σ g of the excess, for M draws and n positive gains
    g (twice the first-order bound of a float32 sum in any order, once for
    each of the two orders compared); dead lanes of ``task_mask`` draw 0
    and gain 0.  A set of indices."""
    bw, gain, _ = c6_tail_ref(bw_panel, r, p, v, route, z, acc_thr, rn, pn,
                              n_fps)
    if task_mask is not None:
        bw = torch.where(task_mask, bw, 0.0)
        gain = torch.where(task_mask, gain, 0.0)
    g = gain.double()
    order = torch.argsort(-gain, stable=True)
    pos = order[g[order] > 0]
    gp = g[pos]
    cum = torch.cumsum(gp, 0) - gp
    total = float(bw.double().sum())
    bound = 2 * EPS * (len(bw) * total + len(gp) * float(gp.sum()))
    return set(pos[(cum - (total - float(budget))).abs() <= bound].tolist())


def compare_repairs(run_a, run_b, rounds: int, args, budget, n_fps: int,
                    exempt=(), task_mask=None):
    """Two repairs ``run_x(k) -> (r, p, bw_history)`` of k rounds on the
    operands ``args`` (bw_panel, r, p, v, route, z, acc_thr, rn, pn) held
    to c6_repair's tolerance: whole runs equal on r and p; else the first
    round that differs differs only on ``exempt`` or boundary tasks of that
    round (:func:`repair_boundary`; later rounds start from different
    states and are not compared).  The histories are compared up to that
    round.  Returns a dict: ``within`` (the verdict), ``hist_max_rel``,
    ``first_differing_round`` (None when equal), ``outside`` (differing
    tasks outside the exemption) and ``rounds_demoting`` (of run_a, when
    the runs are equal).  ``task_mask``: the alive mask both runs took."""
    def rel(ha, hb):
        if ha.numel() == 0:
            return 0.0
        return float(((ha.double() - hb.double()).abs()
                      / hb.double().abs().clamp_min(1e-30)).max())

    ra, pa, ha = run_a(rounds)
    rb, pb, hb = run_b(rounds)
    out = {"first_differing_round": None, "outside": []}
    if torch.equal(ra, rb) and torch.equal(pa, pb):
        out["hist_max_rel"] = rel(ha, hb)
        out["rounds_demoting"] = int((ha[1:] < ha[:-1]).sum())
        out["within"] = out["hist_max_rel"] <= 1e-6
        return out
    prev = (args[1], args[2])
    for k in range(1, rounds + 1):
        ra, pa, ha = run_a(k)
        rb, pb, hb = run_b(k)
        bad = set(torch.nonzero((ra != rb) | (pa != pb)).flatten().tolist())
        if bad:
            allowed = set(exempt) | repair_boundary(*args[:1], *prev,
                                                    *args[3:], budget, n_fps,
                                                    task_mask)
            out.update(first_differing_round=k, hist_max_rel=rel(ha, hb),
                       outside=sorted(bad - allowed))
            out["within"] = not out["outside"] and out["hist_max_rel"] <= 1e-6
            return out
        prev = (ra, pa)
    raise AssertionError("whole repairs differ but no round does")
