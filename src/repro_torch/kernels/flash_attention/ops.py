"""Dispatching wrapper of the prefill attention: the CUDA kernel
(``csrc/flash_attention.cu``) for CUDA tensors, the plain version for CPU
tensors (``force=`` pins either)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # the kernel's instantiations
ROWS = 64                   # query rows of a block: G heads × BQ positions


def flash_attention(q, k, v, *, window: Optional[int] = None,
                    causal: bool = True, positions=None, force: str = "auto"):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) -> (B, H, Sq, D), contiguous.

    Causal GQA attention (query i sees keys j <= i), optionally limited to
    ``i - j < window``; ``causal=False`` drops the causal mask.
    ``positions`` (B, S) integers, self-attention only (Sq = Sk, causal):
    query i sees key j iff pos[i] >= pos[j] and, with a window, pos[i] -
    pos[j] < window (the reference model's mask over runtime positions, as
    M-RoPE's temporal stream gives them; its windowed path also limits
    each q chunk to a key span by index, which agrees wherever positions
    follow the index); the kernel then visits every key tile.  Every query
    sees itself, so no row is empty.  The kernel
    reads q, k and v by their strides (views such as a (B, S, H, D) tensor
    permuted to (B, H, S, D) are not copied); any Sq and Sk.  In bfloat16
    every row start (pointer and strides in bytes) must lie on a 16-byte
    boundary, or the wrapper raises ``ValueError``.  A query that
    sees no key at all (only possible with a window and Sq > Sk) gets zeros
    from the kernel and the uniform average of v from the plain version.
    """
    if not _build.dispatch("flash_attention", force, q.device):
        return attention_ref(q, k, v, window=window, causal=causal,
                             positions=positions)
    b, h, sq, d = q.shape
    kb, kv, sk, kd = k.shape
    if (kb, kd) != (b, d) or tuple(v.shape) != tuple(k.shape) \
            or kv < 1 or h % kv:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if positions is not None:
        if not causal or sq != sk or tuple(positions.shape) != (b, sq):
            raise ValueError(f"flash_attention kernel: positions "
                             f"{tuple(positions.shape)} mask causal "
                             f"self-attention of (B, S) = ({b}, {sq})")
        if positions.device != q.device:
            raise ValueError("flash_attention kernel: positions on "
                             f"{positions.device}, q on {q.device}")
        positions = positions.to(torch.int32).contiguous()
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim must be one of "
                         f"{HEAD_DIMS}, got {d}")
    g = h // kv
    if g > ROWS:
        raise ValueError(f"flash_attention kernel: at most {ROWS} query "
                         f"heads per KV head, got {g}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    # the bf16 kernel stages rows with 16-byte copies: every row start of q,
    # k and v on a 16-byte boundary (the model's projections are)
    code = _build.check_strided("flash_attention", q, k, v, align=16)
    if min(b, h, sq, sk) == 0:
        raise ValueError("flash_attention kernel: empty operands")
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if positions is None else positions.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, h, kv, sq, sk, d, ROWS // g, window or 0, int(causal),
        d ** -0.5, code, _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out
