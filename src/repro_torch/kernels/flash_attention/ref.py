"""Plain PyTorch versions of the flash-attention kernel (GQA, causal,
optionally sliding-window): port of ``repro/kernels/flash_attention/ref.py``
— float32 scores and softmax, output in the input dtype —, of the row
log-sum-exp its training launch stores, and of its backward kernel, the
vector-Jacobian product of that function."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _scores(q, k, window, causal, positions):
    """Float32 scaled scores (B, KV, G, Sq, Sk), NEG_INF where masked."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) * (d ** -0.5)
    if positions is not None:
        if not causal or sq != sk:
            raise ValueError("attention_ref: positions mask causal "
                             "self-attention (causal=True, Sq = Sk)")
        pos = positions.to(torch.int64)
        q_pos, k_pos = pos[:, None, None, :, None], pos[:, None, None, None, :]
    else:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones_like(q_pos >= k_pos)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    return torch.where(mask, s, NEG_INF)


def attention_ref(q, k, v, *, window: Optional[int] = None,
                  causal: bool = True, positions=None):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) -> (B, H, Sq, D).

    Query i and key j are positions i and j of their own sequences (causal:
    j <= i; window: i - j < window).  ``positions`` (B, S), self-attention
    only (Sq = Sk): query i sees key j iff pos[i] >= pos[j] and, with a
    window, pos[i] - pos[j] < window — the reference model's
    ``chunked_attention`` mask; ``causal`` must then be True."""
    b, h, sq, d = q.shape
    p = torch.softmax(_scores(q, k, window, causal, positions), dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def attention_lse_ref(q, k, *, window: Optional[int] = None,
                      causal: bool = True, positions=None):
    """Each query row's log-sum-exp of its scaled, masked scores -> float32
    (B, H, Sq), natural log (masks as :func:`attention_ref`; a row that
    sees no key gets about NEG_INF).  The forward kernel's training launch
    stores the same in log2 units (this times log2 e)."""
    b, h, sq, _ = q.shape
    s = _scores(q, k, window, causal, positions)
    return torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def attention_vjp_ref(q, k, v, do, *, window: Optional[int] = None,
                      causal: bool = True, positions=None):
    """(dq, dk, dv) of :func:`attention_ref` at (q, k, v) for the output
    gradient ``do`` (B, H, Sq, D), by ``torch.autograd.grad``: float32
    arithmetic, each gradient rounded once to its input's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*leaves, window=window, causal=causal,
                            positions=positions)
        return torch.autograd.grad(out, leaves, do)
