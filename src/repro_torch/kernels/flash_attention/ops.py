"""Dispatching wrappers of the prefill attention and of its backward: the
CUDA kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``)
for CUDA tensors, the plain versions for CPU tensors (``force=`` pins
either), and :class:`FlashAttentionFn`, the attention as an autograd
function whose backward is the backward kernel on the card."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    attention_lse_ref,
    attention_ref,
    attention_vjp_ref,
)

HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # the kernel's instantiations
ROWS = 64                   # query rows of a block: G heads × BQ positions
# head dims whose bf16 backward runs on the tensor cores and reads the
# forward's LSE (csrc/flash_attention_bwd.cu, kTensorCores); the rest
# (float32 everywhere, bf16 at 8 and 16) recompute the row statistics on
# the CUDA cores
BWD_TENSOR_CORE_DIMS = (32, 64, 128, 256)
LOG2E = 1.0 / math.log(2.0)


def bwd_design(dtype, head_dim: int) -> str:
    """Which kernels ``flash_attention_bwd`` runs on the card for this dtype
    and head dim: ``"tensor_cores"`` (reads the forward's LSE) or
    ``"cuda_cores"`` (the first design: recomputes the row statistics)."""
    return ("tensor_cores" if dtype == torch.bfloat16
            and head_dim in BWD_TENSOR_CORE_DIMS else "cuda_cores")


def flash_attention(q, k, v, *, window: Optional[int] = None,
                    causal: bool = True, positions=None, force: str = "auto",
                    return_lse: bool = False):
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

    ``return_lse`` (the training launch, which only
    :class:`FlashAttentionFn` asks for) -> (out, lse): lse float32 (B, H,
    Sq), each row's log-sum-exp of its scaled scores in log2 units (the
    base the kernels exponentiate in), where the backward reads it
    (:func:`bwd_design` ``"tensor_cores"``), else None; the plain version's
    always.  ``out`` has the serving launch's bits.
    """
    if not _build.dispatch("flash_attention", force, q.device):
        out = attention_ref(q, k, v, window=window, causal=causal,
                            positions=positions)
        if not return_lse:
            return out
        return out, attention_lse_ref(q, k, window=window, causal=causal,
                                      positions=positions) * LOG2E
    _build.refuse_grad("flash_attention", q, k, v,
                       hint="FlashAttentionFn carries the gradient")
    positions, code = _check("flash_attention", q, k, v, window, causal,
                             positions)
    lse = (_lse_buffer(q) if return_lse
           and bwd_design(q.dtype, q.shape[3]) == "tensor_cores" else None)
    out = _forward_launch(q, k, v, positions, window, causal, code, lse)
    _build.LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def _lse_buffer(q):
    b, h, sq, _ = q.shape
    return torch.empty((b, h, sq), dtype=torch.float32, device=q.device)


def _forward_launch(q, k, v, positions, window, causal, code, lse):
    """One launch of the forward kernel on checked operands (``lse``: None,
    or the float32 (B, H, Sq) buffer of the training launch) -> out."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if positions is None else positions.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, h, kv, sq, sk, d, ROWS // (h // kv), window or 0, int(causal),
        d ** -0.5, code, _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention")
    return out


def _check(name, q, k, v, window, causal, positions):
    """Shapes, head dim, group size, window and strides the kernels take
    (raises on the rest) -> (positions as contiguous int32 or None, the
    dtype code).  The bf16 kernels stage rows with 16-byte copies, so every
    row start of q, k and v must lie on a 16-byte boundary (the model's
    projections do)."""
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
    code = _build.check_strided(name, q, k, v, align=16)
    if min(b, h, sq, sk) == 0:
        raise ValueError(f"{name} kernel: empty operands")
    return positions, code


def flash_attention_bwd(q, k, v, o, do, *, window: Optional[int] = None,
                        causal: bool = True, positions=None,
                        force: str = "auto", lse=None):
    """The attention's vector-Jacobian product -> (dq (B, H, Sq, D), dk,
    dv (B, KV, Sk, D)), each contiguous in its input's dtype.

    q, k, v, ``window``, ``causal`` and ``positions`` as in
    :func:`flash_attention` (in bfloat16 every row start of q, k and v on
    a 16-byte boundary, or ``ValueError``); ``o`` its output and ``do`` the
    output's gradient (B, H, Sq, D), both of q's dtype, read by their
    strides, or first copied contiguous where their last dimension is not
    contiguous or, in bfloat16, a row start is off a 16-byte boundary (an
    expanded gradient has stride 0).  ``lse``: the forward's training
    launch's (``flash_attention(..., return_lse=True)``), which
    :class:`FlashAttentionFn` passes; where the kernels read one
    (:func:`bwd_design` ``"tensor_cores"``) and none is given, one forward
    launch computes it first.  The kernels sum in a fixed order (no
    atomics), so two launches give the same bits; a query that sees no key
    gets zero gradients.  The plain version,
    :func:`~repro_torch.kernels.flash_attention.ref.attention_vjp_ref`, is
    autograd of the plain forward and reads neither ``o`` nor ``lse``.
    """
    if not _build.dispatch("flash_attention_bwd", force, q.device):
        return attention_vjp_ref(q, k, v, do, window=window, causal=causal,
                                 positions=positions)
    positions, code = _check("flash_attention_bwd", q, k, v, window, causal,
                             positions)
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention_bwd kernel: o {tuple(o.shape)} "
                         f"and do {tuple(do.shape)} must be q's "
                         f"{tuple(q.shape)}")
    o, do = _rows_aligned(o), _rows_aligned(do)
    _build.check_strided("flash_attention_bwd", q, o, do, align=16)
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if lse is not None:
        if (tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32
                or lse.device != q.device or not lse.is_contiguous()):
            raise ValueError(f"flash_attention_bwd kernel: lse must be "
                             f"float32 ({b}, {h}, {sq}) contiguous on "
                             f"{q.device}, got {lse.dtype} "
                             f"{tuple(lse.shape)} on {lse.device}")
    elif bwd_design(q.dtype, d) == "tensor_cores":
        lse = _lse_buffer(q)
        _forward_launch(q, k, v, positions, window, causal, code, lse)
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, kv, sk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    # each row's rowsum(do·o) (and, on the CUDA cores, its softmax max and
    # 1/sum), from the dq kernel to the dk/dv kernel
    stats = torch.empty((3, b * h * sq), dtype=torch.float32,
                        device=q.device)
    lib = _build.library()
    rc = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), None if positions is None else positions.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], b, h, kv, sq, sk, d, ROWS // (h // kv),
        window or 0, int(causal), d ** -0.5, code,
        _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention_bwd")
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def _rows_aligned(t):
    """``t`` where the kernels can read it by its strides (last dimension
    contiguous and, in bfloat16, every row start on a 16-byte boundary),
    else a contiguous copy: autograd picks the layout of an output's
    gradient (a transposed view, or stride 0 from ``out.sum()``)."""
    ok = t.stride(-1) == 1 and (t.dtype != torch.bfloat16 or (
        t.data_ptr() % 16 == 0
        and all(st * 2 % 16 == 0 for st in t.stride()[:-1])))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` as an autograd function: the forward is the
    attention (the forward kernel on the card), the backward
    :func:`flash_attention_bwd` (the backward kernel on the card; never
    autograd of the plain version there).  The forward is the training
    launch: it saves the rows' LSE (under remat, from the forward that
    ``torch.utils.checkpoint`` reruns) and the backward hands it to the
    kernels.  ``apply(q, k, v, positions, window, causal, force)``;
    ``positions`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, positions, window, causal, force):
        o, lse = flash_attention(q, k, v, window=window, causal=causal,
                                 positions=positions, force=force,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, positions, lse)
        ctx.opts = dict(window=window, causal=causal, force=force)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, positions, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, positions=positions,
                                         lse=lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention_autograd(q, k, v, *, window: Optional[int] = None,
                             causal: bool = True, positions=None,
                             force: str = "auto"):
    """:func:`flash_attention` through :class:`FlashAttentionFn`,
    differentiable in q, k and v."""
    return FlashAttentionFn.apply(q, k, v, positions, window, causal, force)
