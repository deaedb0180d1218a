"""Dispatching wrappers of the decode attention: the CUDA kernel
(``csrc/decode_attention.cu``) for CUDA tensors, the plain version for CPU
tensors (``force=`` pins either).  :func:`decode_attention` is the serving
launch; :func:`decode_attention_partial` the partial launch, one range of
each row's cache with its log-sum-exp, for a combine across the ranks that
hold the cache's sequence ranges (``sharding/tensor_parallel.py``
``combine_partials``)."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partial_ref,
    decode_attention_ref,
)

MAX_GROUP = 16       # query heads per KV head held by one block
MAX_HEAD_DIM = 256
MAX_SPLITS = 8       # blocks of one thread block cluster (the portable size)
BLOCKS_PER_SM = 2
MIN_CHUNK = 16       # cache entries a split holds at least


def split_rule(bkv: int, s: int, sms: int = 132) -> int:
    """Blocks (one cluster) per (row, KV head) over a cache of ``s``
    entries; split i owns entries [i·chunk, min((i + 1)·chunk, s)) with
    chunk = ceil(s / splits), as the kernel computes it.

    Enough splits for ``BLOCKS_PER_SM`` blocks an SM over the ``bkv``
    (row, KV head) pairs, but no more than leave ``MIN_CHUNK`` entries a
    split (which also leaves no chunk empty), at most ``MAX_SPLITS`` and at
    least one.  On an H100 more splits than that lost time to the cluster's
    combine, fewer to the longer walk of each block (the split timings in
    PERF.md)."""
    return max(1, min(MAX_SPLITS, -(-BLOCKS_PER_SM * sms // bkv),
                      s // MIN_CHUNK))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q, k_cache, v_cache, length, *, force: str = "auto"):
    """q: (B, H, D); k/v_cache: (B, KV, S, D); length: (B,) -> (B, H, D).

    One query token per row against the first ``length[b]`` cache entries
    (1 <= length <= S; a length of 0 gives zeros on the kernel).  The kernel
    reads q and the caches by their strides, so a (B, S, KV, D) slab
    permuted to (B, KV, S, D) is read in place, never copied; it splits
    each row's cache over ``split_rule(B·KV, S)`` blocks of one cluster.
    """
    if not _build.dispatch("decode_attention", force, q.device):
        return decode_attention_ref(q, k_cache, v_cache, length)
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    code, length, splits = _checked("decode_attention", q, k_cache, v_cache,
                                    length)
    b, h, d = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    rc = _build.library().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        length.data_ptr(), out.data_ptr(), *q.stride()[:2],
        *k_cache.stride()[:3], *v_cache.stride()[:3], b, h, kv, s, d,
        splits, d ** -0.5, code, _build.stream_ptr(q.device))
    _build.check(rc, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_partial(q, k_blk, v_blk, length, *,
                             force: str = "auto"):
    """q: (B, H, D); k/v_blk: (B, KV, S, D), one range of each row's cache;
    length: (B,) valid entries of the range, 0 to S -> (out float32 (B, H,
    D), lse float32 (B, H)).

    The serving launch's cluster kernel with a float32 output and the
    range's log-sum-exp of the scaled scores (natural log) beside it: out
    is the range's normalised output, zeros with lse = -inf for an empty
    range.  One launch a call, the range split over ``split_rule(B·KV,
    S)`` blocks of one cluster as the serving launch's."""
    if not _build.dispatch("decode_attention_partial", force, q.device):
        return decode_attention_partial_ref(q, k_blk, v_blk, length)
    _build.refuse_grad("decode_attention_partial", q, k_blk, v_blk)
    code, length, splits = _checked("decode_attention_partial", q, k_blk,
                                    v_blk, length)
    b, h, d = q.shape
    kv, s = k_blk.shape[1], k_blk.shape[2]
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    rc = _build.library().decode_attention_partial_launch(
        q.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), length.data_ptr(),
        out.data_ptr(), lse.data_ptr(), *q.stride()[:2], *k_blk.stride()[:3],
        *v_blk.stride()[:3], b, h, kv, s, d, splits, d ** -0.5, code,
        _build.stream_ptr(q.device))
    _build.check(rc, "decode_attention_partial")
    _build.LAUNCHES["decode_attention_partial"] += 1
    return out, lse


def _checked(name: str, q, k_cache, v_cache, length):
    """A launch's checks -> (dtype code, int32 lengths, splits)."""
    b, h, d = q.shape
    kb, kv, s, kd = k_cache.shape
    if (kb, kd) != (b, d) or tuple(v_cache.shape) != tuple(k_cache.shape) \
            or kv < 1 or h % kv or tuple(length.shape) != (b,):
        raise ValueError(f"{name} kernel: shapes q {tuple(q.shape)}"
                         f" k {tuple(k_cache.shape)} v "
                         f"{tuple(v_cache.shape)} length "
                         f"{tuple(length.shape)}")
    g = h // kv
    if g > MAX_GROUP or d % 2 or d > MAX_HEAD_DIM:
        raise ValueError(f"{name} kernel: needs at most "
                         f"{MAX_GROUP} query heads per KV head and an even "
                         f"head_dim <= {MAX_HEAD_DIM}, got G={g}, D={d}")
    code = _build.check_strided(name, q, k_cache, v_cache)
    length = length.to(torch.int32).contiguous()
    if length.device != q.device:
        raise ValueError(f"{name}: length must be on q's device")
    if min(b, h, s) == 0:
        raise ValueError(f"{name} kernel: empty operands")
    return code, length, split_rule(b * kv, s, _sm_count(q.get_device()))
