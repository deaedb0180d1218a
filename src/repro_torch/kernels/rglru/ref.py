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


def rglru_scan_vjp_ref(x, rgate, igate, log_a_base, h0, y, dy, dh=None):
    """The vector-Jacobian product of :func:`rglru_scan_ref` (what
    ``jax.vjp`` of the reference scan computes), in float32.

    ``y`` (B, S, W) are the forward's states h_t; ``dy`` (B, S, W) and
    ``dh`` (B, W) or None the cotangents of y and of the final state.  The
    cotangent of h_t walks backward: g_t = dy_t + a_{t+1}·g_{t+1}, plus
    ``dh`` at t = S − 1.  With s = sqrt(max(1 − a², 1e-12)) and u = i·x:
    dx = (g·s)·i, di = (g·s)·x, da = g·h_{t−1} + (g·u)·ds/da where
    ds/da = −a/s while 1 − a² > 1e-12 and 0 where the clamp holds (as
    ``jnp.maximum`` passes it), dr = (da·a)·la, dla = Σ_{b,t} (da·a)·r,
    dh0 = a_0·g_0.

    Returns (dx (B, S, W) in x's dtype, dr, di (B, S, W), dla (W,), dh0
    (B, W)), all but dx float32."""
    b, s, w = x.shape
    xf, rf, gf = (t.float() for t in (x, rgate, igate))
    la = log_a_base.float()
    yf, dyf = y.float(), dy.float()
    first = (torch.zeros((b, 1, w), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float()[:, None])
    h_prev = torch.cat([first, yf[:, :-1]], dim=1)[:, :s]
    a = torch.exp(la[None, None] * rf)
    carry = (torch.zeros((b, w), dtype=torch.float32, device=x.device)
             if dh is None else dh.float())
    g = torch.empty_like(dyf)
    for t in reversed(range(s)):
        g[:, t] = dyf[:, t] + carry
        carry = a[:, t] * g[:, t]
    one_m = 1.0 - a * a
    root = torch.sqrt(torch.clamp_min(one_m, 1e-12))
    gs = g * root
    dsa = torch.where(one_m > 1e-12, -a / root, torch.zeros_like(a))
    da = g * h_prev + (g * (gf * xf)) * dsa
    dla_r = da * a
    return ((gs * gf).to(x.dtype), dla_r * la, gs * xf,
            (dla_r * rf).sum(dim=(0, 1)), carry)
