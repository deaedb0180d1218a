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


def decode_attention_partial_ref(q, k_blk, v_blk, local_len):
    """One range of each row's cache (a rank's block of the sequence):
    q (B, H, D); k/v_blk (B, KV, S, D); local_len (B,) valid entries of the
    block, 0 to S.  Returns (out float32 (B, H, D), the range's normalised
    output; lse float32 (B, H), the natural-log log-sum-exp of its scaled
    scores).  An empty range gives out 0 and lse -inf, no NaN."""
    b, h, d = q.shape
    kv, s = k_blk.shape[1], k_blk.shape[2]
    qg = q.reshape(b, kv, h // kv, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                          k_blk.float()) * (d ** -0.5)
    valid = torch.arange(s, device=q.device)[None, :] < local_len[:, None]
    scores = torch.where(valid[:, None, None, :], scores, -torch.inf)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_blk.float()) / torch.clamp_min(
        l, torch.finfo(torch.float32).tiny)[..., None]
    lse = m[..., 0] + torch.log(l)
    return out.reshape(b, h, d), lse.reshape(b, h)
