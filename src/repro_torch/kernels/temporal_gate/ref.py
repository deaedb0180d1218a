"""Plain PyTorch version of the fused temporal-gating cell (paper Eq. 5-6),
port of ``repro/kernels/temporal_gate/ref.py``."""
from __future__ import annotations

import torch


def pack_weights(p):
    """(W_x (d, 3m), U_gr (m, 2m)): the three dx-projections and the two
    h-projections packed column-wise, g | r | h."""
    w_x = torch.cat([p["w_g"], p["w_r"], p["w_h"]], dim=1)
    u_gr = torch.cat([p["u_g"], p["u_r"]], dim=1)
    return w_x, u_gr


def gate_cell_ref(dx, h, vol, p):
    """One gating step for a batch of streams.

    dx: (B, d); h: (B, m); vol: (B,) volatility Var(Δx_{t-T:t}); p: dict of
    w_g,u_g,b_g,alpha,w_r,u_r,b_r,w_h,u_h,b_h,w_o,b_o.
    Returns (h_new (B, m), tau (B,), g_mean (B,)).
    """
    m = h.shape[1]
    w_x, u_gr = pack_weights(p)
    xw = dx @ w_x                                                   # (B, 3m)
    hu = h @ u_gr                                                   # (B, 2m)
    g = torch.sigmoid(xw[:, :m] + hu[:, :m] + p["b_g"]
                      + (p["alpha"] * vol)[:, None])
    r = torch.sigmoid(xw[:, m:2 * m] + hu[:, m:] + p["b_r"])
    cand = torch.tanh(xw[:, 2 * m:] + (r * h) @ p["u_h"] + p["b_h"])
    h_new = (1.0 - g) * h + g * cand
    tau = torch.sigmoid(h_new @ p["w_o"] + p["b_o"])[:, 0]
    return h_new, tau, g.mean(dim=-1)
