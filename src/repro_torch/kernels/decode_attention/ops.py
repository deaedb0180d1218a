"""Dispatching wrapper of the decode attention: the CUDA kernel
(``csrc/decode_attention.cu``) for CUDA tensors, the plain version for CPU
tensors (``force=`` pins either)."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

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
    b, h, d = q.shape
    kb, kv, s, kd = k_cache.shape
    if (kb, kd) != (b, d) or tuple(v_cache.shape) != tuple(k_cache.shape) \
            or kv < 1 or h % kv or tuple(length.shape) != (b,):
        raise ValueError(f"decode_attention kernel: shapes q {tuple(q.shape)}"
                         f" k {tuple(k_cache.shape)} v "
                         f"{tuple(v_cache.shape)} length "
                         f"{tuple(length.shape)}")
    g = h // kv
    if g > MAX_GROUP or d % 2 or d > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention kernel: needs at most "
                         f"{MAX_GROUP} query heads per KV head and an even "
                         f"head_dim <= {MAX_HEAD_DIM}, got G={g}, D={d}")
    code = _build.check_strided("decode_attention", q, k_cache, v_cache)
    length = length.to(torch.int32).contiguous()
    if length.device != q.device:
        raise ValueError("decode_attention: length must be on q's device")
    if min(b, h, s) == 0:
        raise ValueError("decode_attention kernel: empty operands")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    rc = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        length.data_ptr(), out.data_ptr(), *q.stride()[:2],
        *k_cache.stride()[:3], *v_cache.stride()[:3], b, h, kv, s, d,
        split_rule(b * kv, s, _sm_count(q.get_device())), d ** -0.5, code,
        _build.stream_ptr(q.device))
    _build.check(rc, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out
