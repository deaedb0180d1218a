"""Dispatching wrapper of the fused CCG encoding: the CUDA kernel
(``csrc/ccg_encode.cu``) for CUDA tensors, the plain version for CPU tensors
(``force=`` pins either)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ccg_encode.ref import ccg_encode_ref


def ccg_encode(z, aq, rn_flat, pn_flat, tier_flat, b2_scaled, rec_table, *,
               margin: float, num_versions: int, force: str = "auto",
               y_ok=None):
    """Per-task CCG encoding -> (code, rec_all, best).

    z/aq: (M,) float32; rn/pn/tier_flat: (F,); b2_scaled: (P, F, K)
    pole-scaled second-stage costs (the kernel's source); rec_table:
    (P, F, 2^K) subset-min lookup (the plain version's source; both encode
    the same recourse values); y_ok: optional (F,) availability mask.
    Returns the (M, F) int32 feasible-version bitmask, the (M, P, F) float32
    recourse slab and the (M,) int32 flat accuracy argmax.  The kernel masks
    the ragged edge itself, so any M works without padding.
    """
    if not _build.dispatch("ccg_encode", force, z.device):
        return ccg_encode_ref(z, aq, rn_flat, pn_flat, tier_flat, rec_table,
                              margin, num_versions, y_ok=y_ok)
    m, f = z.shape[0], rn_flat.shape[0]
    p, f2, k = b2_scaled.shape
    if f2 != f or k != num_versions or aq.shape != (m,) \
            or any(t.shape != (f,) for t in (pn_flat, tier_flat)):
        raise ValueError("ccg_encode kernel: inconsistent shapes")
    ok = _build.all_ones(f, z.device) if y_ok is None else \
        y_ok.to(torch.float32).contiguous()
    b2s = b2_scaled.permute(2, 0, 1).contiguous()               # (K, P, F)
    ins = [z, aq, rn_flat, pn_flat, tier_flat, ok, b2s]
    _build.check_cuda("ccg_encode", *ins)
    _build.check_dtype("ccg_encode", torch.float32,
                       **{f"operand{i}": t for i, t in enumerate(ins)})
    dev = z.device
    code = torch.empty((m, f), dtype=torch.int32, device=dev)
    rec_all = torch.empty((m, p, f), dtype=torch.float32, device=dev)
    best = torch.empty((m,), dtype=torch.int32, device=dev)
    err = _build.library().ccg_encode_launch(
        *[t.data_ptr() for t in ins], code.data_ptr(), rec_all.data_ptr(),
        best.data_ptr(), m, f, k, p, float(margin), _build.stream_ptr(dev))
    _build.check(err, "ccg_encode")
    _build.LAUNCHES["ccg_encode"] += 1
    return code, rec_all, best
