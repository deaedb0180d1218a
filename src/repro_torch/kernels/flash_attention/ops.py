"""Dispatching wrappers of the prefill attention and of its backward: the
CUDA kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``)
for CUDA tensors, the plain versions for CPU tensors (``force=`` pins
either), and :class:`FlashAttentionFn`, the attention as an autograd
function whose backward is the backward kernel on the card."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    attention_vjp_ref,
)

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
    _build.refuse_grad("flash_attention", q, k, v,
                       hint="FlashAttentionFn carries the gradient")
    positions, code = _check("flash_attention", q, k, v, window, causal,
                             positions)
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if positions is None else positions.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, h, kv, sq, sk, d, ROWS // (h // kv), window or 0, int(causal),
        d ** -0.5, code, _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out


def _check(name, q, k, v, window, causal, positions, align: int = 16):
    """Shapes, head dim, group size, window and strides the kernels take
    (raises on the rest) -> (positions as contiguous int32 or None, the
    dtype code).  ``align``: the bf16 forward kernel stages rows with
    16-byte copies, so every row start of its q, k and v lies on a 16-byte
    boundary (the model's projections do); the backward kernel loads
    element by element (2)."""
    b, h, sq, d = q.shape
    kb, kv, sk, kd = k.shape
    if (kb, kd) != (b, d) or tuple(v.shape) != tuple(k.shape) \
            or kv < 1 or h % kv:
        raise ValueError(f"{name} kernel: shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if positions is not None:
        if not causal or sq != sk or tuple(positions.shape) != (b, sq):
            raise ValueError(f"{name} kernel: positions "
                             f"{tuple(positions.shape)} mask causal "
                             f"self-attention of (B, S) = ({b}, {sq})")
        if positions.device != q.device:
            raise ValueError(f"{name} kernel: positions on "
                             f"{positions.device}, q on {q.device}")
        positions = positions.to(torch.int32).contiguous()
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} kernel: head_dim must be one of "
                         f"{HEAD_DIMS}, got {d}")
    if h // kv > ROWS:
        raise ValueError(f"{name} kernel: at most {ROWS} query "
                         f"heads per KV head, got {h // kv}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    code = _build.check_strided(name, q, k, v, align=align)
    if min(b, h, sq, sk) == 0:
        raise ValueError(f"{name} kernel: empty operands")
    return positions, code


def flash_attention_bwd(q, k, v, o, do, *, window: Optional[int] = None,
                        causal: bool = True, positions=None,
                        force: str = "auto"):
    """The attention's vector-Jacobian product -> (dq (B, H, Sq, D), dk,
    dv (B, KV, Sk, D)), each contiguous in its input's dtype.

    q, k, v, ``window``, ``causal`` and ``positions`` as in
    :func:`flash_attention`; ``o`` its output and ``do`` the output's
    gradient (B, H, Sq, D), both of q's dtype.  The kernel reads the five
    operands by their strides (any row alignment: it loads element by
    element), recomputes the rows' softmax statistics under the same masks
    and sums in a fixed order (no atomics), so two launches give the same
    bits; a query that sees no key gets zero gradients.  The plain version,
    :func:`~repro_torch.kernels.flash_attention.ref.attention_vjp_ref`, is
    autograd of the plain forward and does not read ``o``.
    """
    if not _build.dispatch("flash_attention_bwd", force, q.device):
        return attention_vjp_ref(q, k, v, do, window=window, causal=causal,
                                 positions=positions)
    positions, code = _check("flash_attention_bwd", q, k, v, window, causal,
                             positions, align=2)
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention_bwd kernel: o {tuple(o.shape)} "
                         f"and do {tuple(do.shape)} must be q's "
                         f"{tuple(q.shape)}")
    _build.check_strided("flash_attention_bwd", q, o, do, align=2)
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, kv, sk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    # each row's softmax max, 1/sum and rowsum(do·o), from the dq kernel to
    # the dk/dv kernel
    stats = torch.empty((3, b * h * sq), dtype=torch.float32,
                        device=q.device)
    lib = _build.library()
    rc = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), None if positions is None else positions.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], b, h, kv, sq, sk, d, ROWS // (h // kv),
        window or 0, int(causal), d ** -0.5, code,
        _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention_bwd")
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` as an autograd function: the forward is the
    attention (the forward kernel on the card), the backward
    :func:`flash_attention_bwd` (the backward kernel on the card; never
    autograd of the plain version there).  ``apply(q, k, v, positions,
    window, causal, force)``; ``positions`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, positions, window, causal, force):
        o = flash_attention(q, k, v, window=window, causal=causal,
                            positions=positions, force=force)
        ctx.save_for_backward(q, k, v, o, positions)
        ctx.opts = dict(window=window, causal=causal, force=force)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, positions = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, positions=positions,
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention_autograd(q, k, v, *, window: Optional[int] = None,
                             causal: bool = True, positions=None,
                             force: str = "auto"):
    """:func:`flash_attention` through :class:`FlashAttentionFn`,
    differentiable in q, k and v."""
    return FlashAttentionFn.apply(q, k, v, positions, window, causal, force)
