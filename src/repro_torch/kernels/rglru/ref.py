"""Plain PyTorch version of the RG-LRU scan kernel: port of
``repro/models/rglru.py`` ``rglru_scan_ref`` at ``chunk=1``, the scan the
reference model runs, with its order of float32 operations:
``a = exp(la·r)``, ``h = a·h + sqrt(max(1 − a², 1e-12))·(i·x)``."""
from __future__ import annotations

import torch


def rglru_scan_ref(x, rgate, igate, log_a_base, h0=None):
    """x, rgate, igate: (B, S, W); log_a_base: (W,) = −c·softplus(Λ) < 0;
    h0: (B, W) or None (zeros).  Computed in float32.

    Returns (y (B, S, W) float32, the states h_t; h_final (B, W) float32)."""
    b, s, w = x.shape
    h = (torch.zeros((b, w), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, rf, gf = (t.float() for t in (x, rgate, igate))
    la = log_a_base.float()
    ys = []
    for t in range(s):
        a = torch.exp(la[None] * rf[:, t])
        h = a * h + torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
            gf[:, t] * xf[:, t])
        ys.append(h)
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((b, 0, w), dtype=torch.float32, device=x.device))
    return y, h
