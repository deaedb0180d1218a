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


# the gate's parameters in the order of ``core/gating.py`` ``gate_specs``
# (also the order of the backward kernel's flat gradient)
PARAM_NAMES = ("w_g", "u_g", "b_g", "alpha", "w_r", "u_r", "b_r", "w_h",
               "u_h", "b_h", "w_o", "b_o")


def gate_cell_vjp_ref(dx, h, vol, p, dh_new=None, dtau=None, dg_mean=None,
                      need_dh: bool = True):
    """The vector-Jacobian product of :func:`gate_cell_ref`, written out.

    Recomputes the forward from ``(dx, h, vol, p)`` and applies the chain
    rule to the incoming gradients ``dh_new (B, m)``, ``dtau (B,)`` and
    ``dg_mean (B,)`` (None for zero).  Returns ``(grads, dh)``: the gradient
    of every parameter (a dict keyed as ``p``, each of its parameter's
    shape) and ``dh (B, m)``, or None unless ``need_dh``.  ``dx`` and
    ``vol`` get none (the gate's inputs are data).  The weight gradients
    are sums over the B streams.
    """
    b, m = h.shape
    zeros = lambda *shape: torch.zeros(shape, dtype=h.dtype, device=h.device)
    dh_new = zeros(b, m) if dh_new is None else dh_new
    dtau = zeros(b) if dtau is None else dtau
    dg_mean = zeros(b) if dg_mean is None else dg_mean
    w_x, u_gr = pack_weights(p)
    xw = dx @ w_x
    hu = h @ u_gr
    g = torch.sigmoid(xw[:, :m] + hu[:, :m] + p["b_g"]
                      + (p["alpha"] * vol)[:, None])
    r = torch.sigmoid(xw[:, m:2 * m] + hu[:, m:] + p["b_r"])
    rh = r * h
    cand = torch.tanh(xw[:, 2 * m:] + rh @ p["u_h"] + p["b_h"])
    h_new = (1.0 - g) * h + g * cand
    tau = torch.sigmoid(h_new @ p["w_o"] + p["b_o"])[:, 0]
    # τ = σ(h_new·w_o + b_o), g_mean = mean_j g_j
    da_o = dtau * tau * (1.0 - tau)                                   # (B,)
    dhn = dh_new + da_o[:, None] * p["w_o"][:, 0]
    dg = dhn * (cand - h) + (dg_mean / m)[:, None]
    da_c = dhn * g * (1.0 - cand * cand)
    drh = da_c @ p["u_h"].T
    da_r = drh * h * r * (1.0 - r)
    da_g = dg * g * (1.0 - g)
    grads = {
        "w_g": dx.T @ da_g, "u_g": h.T @ da_g, "b_g": da_g.sum(0),
        "alpha": (da_g * vol[:, None]).sum(),
        "w_r": dx.T @ da_r, "u_r": h.T @ da_r, "b_r": da_r.sum(0),
        "w_h": dx.T @ da_c, "u_h": rh.T @ da_c, "b_h": da_c.sum(0),
        "w_o": (h_new * da_o[:, None]).sum(0)[:, None],
        "b_o": da_o.sum().reshape(1),
    }
    grads = {k: grads[k].reshape(p[k].shape) for k in PARAM_NAMES}
    if not need_dh:
        return grads, None
    dh = (dhn * (1.0 - g) + drh * r + da_g @ p["u_g"].T
          + da_r @ p["u_r"].T)
    return grads, dh
