"""Plain PyTorch version of the fused C6 repair tail (one demotion round's
per-task gains), port of ``repro/kernels/c6_tail/ref.py``."""
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
