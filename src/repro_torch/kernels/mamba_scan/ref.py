"""Plain PyTorch version of the selective-scan kernel (Mamba-1): port of
``repro/models/ssm.py`` ``selective_scan_ref`` at ``chunk=1``, the scan the
reference model runs, with its order of float32 operations:
``dA = exp(dt·A)``, ``dBx = (dt·B)·x``, ``h = dA·h + dBx``,
``y = Σ_n h·C + D·x``."""
from __future__ import annotations

import torch


def selective_scan_ref(x, dt, B, C, A, D, h0=None):
    """x, dt: (b, S, Di); B, C: (b, S, N); A: (Di, N); D: (Di,); h0:
    (b, Di, N) or None (zeros).  Any float dtypes, computed in float32.

    Returns (y (b, S, Di) float32, h_final (b, Di, N) float32)."""
    b, s, di = x.shape
    n = A.shape[1]
    h = (torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, dtf, bf, cf = (t.float() for t in (x, dt, B, C))
    a, d = A.float(), D.float()
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * a[None])
        dbx = dtf[:, t, :, None] * bf[:, t, None, :] * xf[:, t, :, None]
        h = da * h + dbx
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]) + d[None] * xf[:, t])
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((b, 0, di), dtype=torch.float32, device=x.device))
    return y, h
