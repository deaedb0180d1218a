"""int8 gradient compression with error feedback: port of
``repro/train/compression.py`` (``compress``, ``decompress``,
``ef_compress_grads``, ``compressed_allreduce``).

``compress``/``decompress`` define the wire format (per-tensor absmax
int8); ``ef_compress_grads`` quantizes each gradient plus its persistent
error-feedback buffer and keeps the residual for the next step
(Karimireddy et al. EF-SGD).  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 codes are the reference's.  On a mesh the
trainer holds blocks of each gradient; their codes are the whole leaf's
only if every block is scaled by the whole leaf's absmax, so
``ef_compress_grads(..., placements=, mesh=)`` takes the maximum over the
ranks that hold the leaf's other blocks (``pmax``).

``compressed_allreduce`` is the standalone collective (the reference's
``shard_map`` body): each rank's int8 codes and scale are gathered along a
mesh dim and the sum Σᵢ scaleᵢ · qᵢ is taken in rank order, so every rank
gets the same bits.  (The reference also makes an int32 ``psum`` of the
codes that it never reads; the port does not.)
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_map
from repro_torch.sharding.collectives import all_gather, pmax


def compress(g, absmax=None):
    """-> (int8 codes of g's shape, float32 0-d scale = max|g| / 127);
    ``absmax`` replaces max|g| (the whole leaf's, for a block of it)."""
    amax = g.abs().max() if absmax is None else absmax
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def decompress(q, scale):
    return q.float() * scale


def whole_absmax(x, placement, mesh):
    """max|x| over the whole leaf of which ``x`` is this rank's block: the
    maximum over every mesh dim that splits it."""
    amax = x.abs().max()
    for axis in placement.split_axes:
        amax = pmax(amax, mesh, axis)
    return amax


@torch.no_grad()
def ef_compress_grads(grads, error_buf, placements=None, mesh=None):
    """-> (wire gradients in each gradient's dtype, new float32 error
    buffers): quantize g + e, keep the residual.  ``error_buf`` None starts
    from zeros.  With ``placements`` and ``mesh`` the gradients are blocks,
    each scaled by its whole leaf's absmax."""
    if error_buf is None:
        error_buf = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)

    def one(g, e, pl=None):
        corrected = g.float() + e
        amax = None if pl is None else whole_absmax(corrected, pl, mesh)
        deq = decompress(*compress(corrected, amax))
        return deq.to(g.dtype), corrected - deq

    rest = (error_buf,) if placements is None else (error_buf, placements)
    pairs = tree_map(one, grads, *rest)
    return (tree_map(lambda _, t: t[0], grads, pairs),
            tree_map(lambda _, t: t[1], grads, pairs))


@torch.no_grad()
def compressed_allreduce(g, mesh, axis: str = "data"):
    """int8 on the wire: the sum over ``axis`` of every rank's
    ``decompress(*compress(g))``, as float32, in rank order."""
    q, scale = compress(g)
    qs = all_gather(q[None], mesh, axis)                # (D, ...) int8
    scales = all_gather(scale.reshape(1), mesh, axis)   # (D,)
    out = scales[0] * qs[0].float()
    for i in range(1, qs.shape[0]):
        out = out + scales[i] * qs[i].float()
    return out
