"""int8 gradient compression with error feedback: port of
``repro/train/compression.py``'s ``compress``, ``decompress`` and
``ef_compress_grads``.

``compress``/``decompress`` define the wire format (per-tensor absmax
int8); ``ef_compress_grads`` quantizes each gradient plus its persistent
error-feedback buffer and keeps the residual for the next step
(Karimireddy et al. EF-SGD).  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 codes are the reference's.  The
collective over ranks (``compressed_allreduce``) comes with multi-rank
training (ROADMAP queue A.16c).
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_map


def compress(g):
    """-> (int8 codes of g's shape, float32 0-d scale = max|g| / 127)."""
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def decompress(q, scale):
    return q.float() * scale


@torch.no_grad()
def ef_compress_grads(grads, error_buf):
    """-> (wire gradients in each gradient's dtype, new float32 error
    buffers): quantize g + e, keep the residual.  ``error_buf`` None starts
    from zeros."""
    if error_buf is None:
        error_buf = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)

    def one(g, e):
        corrected = g.float() + e
        deq = decompress(*compress(corrected))
        return deq.to(g.dtype), corrected - deq

    pairs = tree_map(one, grads, error_buf)
    return (tree_map(lambda _, t: t[0], grads, pairs),
            tree_map(lambda _, t: t[1], grads, pairs))
