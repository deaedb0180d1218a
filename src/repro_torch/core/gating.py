"""Temporal gating unit (paper §3.2, Eq. 5-6) — port of
``repro/core/gating.py``: the batched streaming gate (:27-155), its window
scan ``gate_window_scan`` (:176-194), and the per-stream recurrence with
its training loss (``GateState`` … ``gate_scan_batch`` :58-174,
``gate_loss`` :205-220).

    g_t = σ( W_g Δx_t + U_g h_{t-1} + b_g + α · Var(Δx_{t-T:t}) )      (5)
    r_t = σ( W_r Δx_t + U_r h_{t-1} + b_r )
    h_t = (1-g_t) ⊙ h_{t-1} + g_t ⊙ tanh( W_h Δx_t + U_h (r_t ⊙ h_{t-1}) + b_h )  (6)
    τ_t = σ( W_o h_t + b_o ) ∈ [0,1]      — temporal significance score

The cell itself is ``kernels/temporal_gate`` (CUDA kernel on the card);
the training path runs it through ``GateCellFn``, whose backward is the
backward kernel on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.features import feature_dim  # noqa: F401
from repro_torch.device import resolve_device
from repro_torch.kernels.temporal_gate.ops import gate_cell, gate_cell_autograd


@dataclasses.dataclass(frozen=True)
class GateConfig:
    d_feature: int
    d_hidden: int = 32
    var_window: int = 8          # T in Eq. (5)
    alpha_init: float = 1.0
    # every how many steps the running Σ/Σ² are recomputed from the exact
    # ring buffer; 0 = once per window (var_window), 1 = every step
    resync_period: int = 0


def gate_specs(cfg: GateConfig) -> dict:
    """name -> (shape, init, stddev) of every gate parameter, in the
    reference's order (``init`` is "normal", "zeros" or "ones")."""
    d, m = cfg.d_feature, cfg.d_hidden
    sd, sm = d ** -0.5, m ** -0.5
    return {
        "w_g": ((d, m), "normal", sd),
        "u_g": ((m, m), "normal", sm),
        "b_g": ((m,), "zeros", 0.0),
        "alpha": ((), "ones", 0.0),
        "w_r": ((d, m), "normal", sd),
        "u_r": ((m, m), "normal", sm),
        "b_r": ((m,), "zeros", 0.0),
        "w_h": ((d, m), "normal", sd),
        "u_h": ((m, m), "normal", sm),
        "b_h": ((m,), "zeros", 0.0),
        "w_o": ((m, 1), "normal", sm),
        "b_o": ((1,), "zeros", 0.0),
    }


def init_gate_params(cfg: GateConfig, generator: torch.Generator,
                     device="cuda") -> dict:
    """Random gate parameters from ``generator`` (normal·stddev, zeros, ones).

    The draws are made on the CPU, so one seed gives the same parameters on
    every device; they differ from ``jax.random`` draws of the reference
    (tests carry the reference's parameters over with ``convert``)."""
    dev = resolve_device(device)
    out = {}
    for name, (shape, init, std) in gate_specs(cfg).items():
        if init == "zeros":
            t = torch.zeros(shape, dtype=torch.float32)
        elif init == "ones":
            t = torch.ones(shape, dtype=torch.float32)
        else:
            t = torch.randn(shape, generator=generator,
                            dtype=torch.float32) * std
        out[name] = t.to(dev)
    return out


@dataclasses.dataclass
class GateBatchState:
    h: torch.Tensor          # (M, m) hidden
    var_buf: torch.Tensor    # (M, T, d) Δx ring buffer
    var_idx: torch.Tensor    # (M,) int64 steps taken
    var_sum: torch.Tensor    # (M, d) running Σ Δx over the buffer
    var_sumsq: torch.Tensor  # (M, d) running Σ Δx² over the buffer


def init_batch_state(cfg: GateConfig, n_streams: int,
                     device="cuda") -> GateBatchState:
    dev = resolve_device(device)
    m, t, d = cfg.d_hidden, cfg.var_window, cfg.d_feature
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    return GateBatchState(
        h=z(n_streams, m), var_buf=z(n_streams, t, d),
        var_idx=torch.zeros((n_streams,), dtype=torch.int64, device=dev),
        var_sum=z(n_streams, d), var_sumsq=z(n_streams, d))


def batch_volatility(cfg: GateConfig, var_sum, var_sumsq):
    """Var(Δx_{t-T:t}) of each stream from its running sums over the ring:
    mean over the d features of max(Σ²/T − (Σ/T)², 0).  ``gate_step_batch``
    computes it from the sums it stores in the new state, so the volatility
    a step fed to the cell is this function of that state's sums (the
    finetune round takes it from there after the step)."""
    t = cfg.var_window
    mean = var_sum / t
    return torch.clamp_min(var_sumsq / t - mean * mean, 0.0).mean(dim=-1)


def gate_step_batch(cfg: GateConfig, p, state: GateBatchState, dx, *,
                    force: str = "auto"):
    """One recurrence step for all streams. dx: (M, d) float32.

    Returns ``(new_state, (tau (M,), g_mean (M,)))``.  The ring buffer is
    updated IN PLACE: the new state shares ``state.var_buf`` with its
    slot overwritten by ``dx`` (copying the (M, T, d) buffer every round
    would move T·d floats per stream to change d of them), so ``state``
    must not be used again.  The running sums take the reference's order:
    (Σ + dx) − evicted, and Σ over the T buffer rows when resyncing.  The
    resync round is selected on the device (both sums computed, one kept
    with ``torch.where``) so the step never reads back to the host.
    """
    t = cfg.var_window
    m = state.var_buf.shape[0]
    rows = torch.arange(m, device=dx.device)
    slot = state.var_idx % t                                       # (M,)
    old = state.var_buf[rows, slot]                                # (M, d)
    var_sum = state.var_sum + dx - old
    var_sumsq = state.var_sumsq + dx * dx - old * old
    buf = state.var_buf
    buf[rows, slot] = dx
    period = cfg.resync_period or t
    resync = (state.var_idx[:1] + 1) % period == 0                 # (1,)
    var_sum = torch.where(resync[:, None], buf.sum(dim=1), var_sum)
    var_sumsq = torch.where(resync[:, None], torch.square(buf).sum(dim=1),
                            var_sumsq)
    vol = batch_volatility(cfg, var_sum, var_sumsq)

    h, tau, g_mean = gate_cell(dx, state.h, vol, p, force=force)
    new_state = GateBatchState(h=h, var_buf=buf, var_idx=state.var_idx + 1,
                               var_sum=var_sum, var_sumsq=var_sumsq)
    return new_state, (tau, g_mean)


def gate_window_scan(cfg: GateConfig, p, dxs,
                     state: GateBatchState | None = None, *,
                     force: str = "auto"):
    """dxs: (M, T, d) -> (taus (M, T), g_means (M, T), final_state).

    :func:`gate_step_batch` over the T axis: the whole stream batch advances
    one segment a step, from a fresh :func:`init_batch_state` or from a copy
    of ``state`` (the step writes its ring buffer in place, so the caller's
    state is never written)."""
    if state is None:
        state = init_batch_state(cfg, dxs.shape[0], dxs.device)
    else:
        state = GateBatchState(**{f.name: getattr(state, f.name).clone()
                                  for f in dataclasses.fields(state)})
    taus, gs = [], []
    for dx in dxs.movedim(1, 0).contiguous():             # (M, d) a step
        state, (tau, g_mean) = gate_step_batch(cfg, p, state, dx,
                                               force=force)
        taus.append(tau)
        gs.append(g_mean)
    return torch.stack(taus, dim=1), torch.stack(gs, dim=1), state


# ---------------------------------------------------------------------------
# The per-stream recurrence (the reference's ``gate_step`` / ``gate_scan`` /
# ``gate_scan_batch``), batched natively over any leading stream axes: the
# volatility is recomputed from the whole ring every step, and the cell runs
# through ``GateCellFn`` so that ``gate_loss`` differentiates through it.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class GateState:
    h: torch.Tensor          # (..., m) hidden
    var_buf: torch.Tensor    # (..., T, d) recent Δx ring buffer
    var_idx: torch.Tensor    # (...,) int64 steps taken


def init_state(cfg: GateConfig, n_streams: int | None = None,
               device="cuda") -> GateState:
    """A fresh state: one stream's (the reference's shapes) with
    ``n_streams`` None, else ``n_streams`` of them stacked."""
    dev = resolve_device(device)
    lead = () if n_streams is None else (n_streams,)
    z = lambda *shape: torch.zeros(lead + shape, dtype=torch.float32,
                                   device=dev)
    return GateState(h=z(cfg.d_hidden),
                     var_buf=z(cfg.var_window, cfg.d_feature),
                     var_idx=torch.zeros(lead, dtype=torch.int64,
                                         device=dev))


def gate_step(cfg: GateConfig, p, state: GateState, dx, *,
              force: str = "auto"):
    """One recurrence step. dx: (..., d), the state's leading axes.
    Returns ``(new_state, (tau, g_mean))`` of the leading shape.

    The ring is written out of place (``state`` stays valid) and the
    volatility is the population variance over the whole (T, d) ring, zero
    rows included, averaged over d: ``jnp.var``'s estimator, so
    ``correction=0``."""
    t = cfg.var_window
    hit = (torch.arange(t, device=dx.device)
           == (state.var_idx % t)[..., None])                  # (..., T)
    buf = torch.where(hit[..., None], dx[..., None, :], state.var_buf)
    vol = torch.var(buf, dim=-2, correction=0).mean(dim=-1)
    lead = dx.shape[:-1]
    # the kernel takes contiguous rows (a step of a (B, T, d) batch is not)
    h, tau, g_mean = gate_cell_autograd(
        dx.reshape(-1, dx.shape[-1]).contiguous(),
        state.h.reshape(-1, cfg.d_hidden).contiguous(),
        vol.reshape(-1).contiguous(), p, force=force)
    new_state = GateState(h=h.reshape(lead + (cfg.d_hidden,)), var_buf=buf,
                          var_idx=state.var_idx + 1)
    return new_state, (tau.reshape(lead), g_mean.reshape(lead))


def gate_scan_batch(cfg: GateConfig, p, dxs, states: GateState | None = None,
                    *, force: str = "auto"):
    """dxs: (B, T, d) -> (taus (B, T), gate_means (B, T), final_state):
    :func:`gate_step` over T with the B streams advancing together (the
    reference vmaps ``gate_scan`` over them)."""
    if states is None:
        states = init_state(cfg, dxs.shape[0], dxs.device)
    taus, gs = [], []
    for i in range(dxs.shape[1]):
        states, (tau, g_mean) = gate_step(cfg, p, states, dxs[:, i],
                                          force=force)
        taus.append(tau)
        gs.append(g_mean)
    return torch.stack(taus, dim=1), torch.stack(gs, dim=1), states


def gate_scan(cfg: GateConfig, p, dxs, state: GateState | None = None, *,
              force: str = "auto"):
    """dxs: (T, d) -> (taus (T,), gate_means (T,), final_state): one
    stream's recurrence (a batch of one through :func:`gate_scan_batch`)."""
    if state is None:
        state = init_state(cfg, None, dxs.device)
    one = GateState(h=state.h[None], var_buf=state.var_buf[None],
                    var_idx=state.var_idx[None])
    taus, gs, fin = gate_scan_batch(cfg, p, dxs[None], one, force=force)
    return taus[0], gs[0], GateState(h=fin.h[0], var_buf=fin.var_buf[0],
                                     var_idx=fin.var_idx[0])


# ---------------------------------------------------------------------------
# Meta-training (offline warm-up): L = L_acc + λ1·L_lat + λ2·L_comp
#   L_acc : BCE of τ against the oracle cloud-benefit label
#   L_lat : mean τ      (cloud offloads cost latency)
#   L_comp: mean gate   (gate openness costs compute)
# Online fine-tuning adds a proximal term μ/2 ||θ - θ_offline||² against
# catastrophic forgetting (paper §3.2).
# ---------------------------------------------------------------------------
def gate_loss(cfg: GateConfig, p, dxs, benefit_labels, lam1=0.05, lam2=0.01,
              anchor=None, mu=0.0, *, force: str = "auto"):
    """The warm-up loss over ``dxs (B, T, d)`` and ``benefit_labels (B,
    T)`` -> ``(loss, {"bce", "l_lat", "l_comp"})``, differentiable in
    ``p`` (BPTT through every step's ``GateCellFn``); with ``anchor`` and
    ``mu > 0`` the proximal term over every parameter."""
    taus, gs, _ = gate_scan_batch(cfg, p, dxs, force=force)
    eps = 1e-6
    bce = -(benefit_labels * torch.log(taus + eps)
            + (1 - benefit_labels) * torch.log(1 - taus + eps)).mean()
    l_lat = taus.mean()
    l_comp = gs.mean()
    loss = bce + lam1 * l_lat + lam2 * l_comp
    if anchor is not None and mu > 0:
        # the reference's leaf order: the parameter names sorted
        prox = sum(torch.sum(torch.square(p[k] - anchor[k]))
                   for k in sorted(p))
        loss = loss + 0.5 * mu * prox
    return loss, {"bce": bce, "l_lat": l_lat, "l_comp": l_comp}
