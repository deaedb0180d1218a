"""Plain PyTorch version of the decode-attention kernel (one query token
against a KV cache): port of ``repro/kernels/decode_attention/ref.py`` —
float32 scores and softmax, output in the input dtype."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, length):
    """q: (B, H, D); k/v_cache: (B, KV, S, D); length: (B,) valid entries.

    Returns (B, H, D); cache positions >= length are masked."""
    b, h, d = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                          k_cache.float()) * (d ** -0.5)
    valid = torch.arange(s, device=q.device)[None, :] < length[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", w, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)
