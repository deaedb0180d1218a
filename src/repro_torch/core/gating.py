"""Temporal gating unit (paper §3.2, Eq. 5-6) — port of the batched
streaming gate in ``repro/core/gating.py:27-155`` and its window scan
``gate_window_scan`` (:176-194).

    g_t = σ( W_g Δx_t + U_g h_{t-1} + b_g + α · Var(Δx_{t-T:t}) )      (5)
    r_t = σ( W_r Δx_t + U_r h_{t-1} + b_r )
    h_t = (1-g_t) ⊙ h_{t-1} + g_t ⊙ tanh( W_h Δx_t + U_h (r_t ⊙ h_{t-1}) + b_h )  (6)
    τ_t = σ( W_o h_t + b_o ) ∈ [0,1]      — temporal significance score

The cell itself is ``kernels/temporal_gate`` (CUDA kernel on the card).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.temporal_gate.ops import gate_cell

# repro/core/features.py: GRID·GRID grid means + HIST_BINS histogram + 3 stats
_GRID, _HIST_BINS = 4, 16


def feature_dim() -> int:
    """Width d of the motion features Δx_t (35)."""
    return _GRID * _GRID + _HIST_BINS + 3


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
    mean = var_sum / t
    vol = torch.clamp_min(var_sumsq / t - mean * mean, 0.0).mean(dim=-1)

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
