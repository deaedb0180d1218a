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


def selective_scan_vjp_ref(x, dt, B, C, A, D, h0, dy, dh=None):
    """The vector-Jacobian product of :func:`selective_scan_ref` (what
    ``jax.vjp`` of the reference scan computes), in float32.

    ``dy`` (b, S, Di) and ``dh`` (b, Di, N) or None are the cotangents of y
    and of the final state.  The states h_t are recomputed forward first,
    with dA_t = exp(dt_t·A); then the cotangent of h_t walks backward,
    g_t = dy_t·C_t + dA_{t+1}·g_{t+1} (plus ``dh`` at t = S − 1), and with
    z = (g·h_{t−1})·dA_t (the cotangent of dt·A) and gx = g·x:
    dC_t = Σ_d dy·h_t, dB_t = Σ_d gx·dt, ddt = Σ_n (z·A + gx·B),
    dx = dt·Σ_n g·B + D·dy, dA = Σ_{b,t} z·dt, dD = Σ_{b,t} dy·x and
    dh0 = dA_0·g_0.

    Returns (dx in x's dtype, ddt (b, S, Di), dB, dC (b, S, N) in B's and
    C's dtypes, dA (Di, N), dD (Di,), dh0 (b, Di, N)), the rest float32."""
    b, s, di = x.shape
    n = A.shape[1]
    dev = x.device
    xf, dtf, bf, cf, dyf = (t.float() for t in (x, dt, B, C, dy))
    a, d = A.float(), D.float()
    h = (torch.zeros((b, di, n), dtype=torch.float32, device=dev)
         if h0 is None else h0.float())
    hs, das = [h], []
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * a[None])
        dbx = dtf[:, t, :, None] * bf[:, t, None, :] * xf[:, t, :, None]
        h = da * h + dbx
        hs.append(h)
        das.append(da)
    carry = (torch.zeros((b, di, n), dtype=torch.float32, device=dev)
             if dh is None else dh.float())
    dx = torch.empty((b, s, di), dtype=torch.float32, device=dev)
    ddt = torch.empty_like(dx)
    db = torch.empty((b, s, n), dtype=torch.float32, device=dev)
    dc = torch.empty_like(db)
    d_a = torch.zeros((di, n), dtype=torch.float32, device=dev)
    for t in reversed(range(s)):
        dyt = dyf[:, t]
        g = dyt[..., None] * cf[:, t, None, :] + carry
        dc[:, t] = (dyt[..., None] * hs[t + 1]).sum(dim=1)
        z = g * hs[t] * das[t]
        gx = g * xf[:, t, :, None]
        db[:, t] = (gx * dtf[:, t, :, None]).sum(dim=1)
        ddt[:, t] = (z * a[None] + gx * bf[:, t, None, :]).sum(dim=-1)
        dx[:, t] = dtf[:, t] * (g * bf[:, t, None, :]).sum(dim=-1) + d * dyt
        d_a += (z * dtf[:, t, :, None]).sum(dim=0)
        carry = das[t] * g
    return (dx.to(x.dtype), ddt, db.to(B.dtype), dc.to(C.dtype), d_a,
            (dyf * xf).sum(dim=(0, 1)), carry)
