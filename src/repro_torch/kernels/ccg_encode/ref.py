"""Plain PyTorch version of the fused per-task CCG encoding, port of
``repro/kernels/ccg_encode/ref.py``.

The accuracy surface is evaluated one model version at a time in the flat
option layout (the largest accuracy intermediate is one (M, F) slice), each
slice is thresholded into the feasible-version bitmask ``code``, and the
(M, P, F) recourse slab is gathered from the task-independent (P, F, 2^K)
subset lookup at the bitmask.  The CUDA kernel (``csrc/ccg_encode.cu``)
min-folds the pole-scaled costs instead of gathering; a float min is exact
in any order, so the two give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.cost_model import _accuracy_formula
from repro_torch.core.lattice import BIG


def ccg_encode_ref(z, aq, rn_flat, pn_flat, tier_flat, rec_table, margin,
                   num_versions: int, y_ok=None):
    """Fused task encoding for a CCG batch.

    z/aq: (M,) difficulty and accuracy requirement; rn/pn/tier_flat: (F,)
    normalized option coordinates; rec_table: (P, F, 2^K) recourse lookup;
    y_ok: optional (F,) availability mask (options at ``y_ok <= 0`` get
    accuracy -BIG: infeasible and out of the fallback argmax).

    Returns ``(code (M, F) int32, rec_all (M, P, F) float32, best (M,)
    int32)``: the feasible-version bitmask, the per-pole recourse (BIG where
    no version fits) and the flat accuracy argmax over (F·K), k minor, first
    maximum on ties.
    """
    dev = z.device
    m, f = z.shape[0], rn_flat.shape[0]
    z2 = z[:, None]
    thr = (aq + margin)[:, None]
    rn, pn, tf = rn_flat[None, :], pn_flat[None, :], tier_flat[None, :]
    okm = None if y_ok is None else (y_ok > 0)[None, :]
    code = torch.zeros((m, f), dtype=torch.int32, device=dev)
    best_val = torch.full((m,), -BIG, dtype=torch.float32, device=dev)
    best = torch.zeros((m,), dtype=torch.int64, device=dev)
    for k in range(num_versions):
        kf = torch.full((), float(k), dtype=torch.float32, device=dev)
        f_k = _accuracy_formula(z2, rn, pn, kf, tf)               # (M, F)
        if okm is not None:
            f_k = torch.where(okm, f_k, -BIG)
        code = code + torch.where(f_k >= thr, 1 << k, 0).to(torch.int32)
        # per-version first maximum, then a strict-> hand-off across
        # versions that breaks ties to the lower flat index y·K + k
        val_k, arg_k = f_k.max(dim=1)
        flat_k = arg_k * num_versions + k
        better = (val_k > best_val) | ((val_k == best_val) & (flat_k < best))
        best = torch.where(better, flat_k, best)
        best_val = torch.where(better, val_k, best_val)
    rec_all = torch.take_along_dim(
        rec_table[None], code[:, None, :, None].long(), dim=-1)[..., 0]
    return code, rec_all, best.to(torch.int32)
