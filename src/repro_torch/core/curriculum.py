"""Gate meta-training curriculum (paper §3.2) — port of
``repro/core/curriculum.py``.

Offline warm-up on diverse video categories minimizing
L_acc + λ1·L_lat + λ2·L_comp, then online fine-tuning with a proximal
regularizer (μ/2)·||θ − θ_offline||² against catastrophic forgetting.  The
gradients are ``torch.autograd.grad`` of ``gating.gate_loss``, through the
gate cell's ``GateCellFn`` (its backward kernel on the card).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.gating import GateConfig, gate_loss, init_gate_params


@dataclasses.dataclass(frozen=True)
class CurriculumConfig:
    warmup_steps: int = 300
    online_steps: int = 100
    lr: float = 3e-3
    lam1: float = 0.05
    lam2: float = 0.01
    mu: float = 0.1


def _sgd_step(params, grads, lr):
    return {k: p - lr * grads[k] for k, p in params.items()}


def _train_step(gate_cfg: GateConfig, params, dxs, labels, lr, lam1, lam2,
                anchor=None, mu=0.0, *, force: str = "auto"):
    """One SGD step on ``gate_loss`` -> ``(params, loss, metrics)``; the
    loss and metrics are 0-d tensors (no read back to the host)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, metrics = gate_loss(gate_cfg, leaves, dxs, labels, lam1, lam2,
                              anchor, mu, force=force)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    grads = dict(zip(leaves, grads))
    return (_sgd_step(params, grads, lr), loss.detach(),
            {k: v.detach() for k, v in metrics.items()})


def _batch(item, device):
    dxs, labels = item
    return (torch.as_tensor(dxs, dtype=torch.float32, device=device),
            torch.as_tensor(labels, dtype=torch.float32, device=device))


def offline_warmup(gate_cfg: GateConfig, data_iter, ccfg: CurriculumConfig,
                   generator: torch.Generator, device="cuda", *,
                   force: str = "auto"):
    """``data_iter`` yields (dxs (B, T, d), benefit_labels (B, T)), tensors
    or arrays; the parameters start from ``init_gate_params(gate_cfg,
    generator, device)``.  Returns (params, the loss of every step)."""
    params = init_gate_params(gate_cfg, generator, device)
    dev = params["w_g"].device
    losses = []
    for _, item in zip(range(ccfg.warmup_steps), data_iter):
        dxs, labels = _batch(item, dev)
        params, loss, _ = _train_step(gate_cfg, params, dxs, labels, ccfg.lr,
                                      ccfg.lam1, ccfg.lam2, force=force)
        losses.append(float(loss))
    return params, losses


def online_finetune(gate_cfg: GateConfig, params, data_iter,
                    ccfg: CurriculumConfig, *, force: str = "auto"):
    """Proximal online adaptation anchored at the offline solution, at 0.3
    of the warm-up's learning rate.  Returns (params, losses)."""
    anchor = {k: v.detach().clone() for k, v in params.items()}
    dev = anchor["w_g"].device
    losses = []
    for _, item in zip(range(ccfg.online_steps), data_iter):
        dxs, labels = _batch(item, dev)
        params, loss, _ = _train_step(
            gate_cfg, params, dxs, labels, ccfg.lr * 0.3, ccfg.lam1,
            ccfg.lam2, anchor=anchor, mu=ccfg.mu, force=force)
        losses.append(float(loss))
    return params, losses
