"""Dispatching wrapper of the fused CCG solve: the CUDA kernel
(``csrc/ccg_solve.cu``) for CUDA tensors, the plain version for CPU tensors
(``force=`` pins either)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ccg_solve.ref import ccg_solve_ref

BLOCK_M = 8       # tasks per CUDA block (one warp each)


def ccg_solve(z, aq, rn_flat, pn_flat, tier_flat, b2_flat, u_all, c1_flat,
              warm_y, *, margin: float, num_versions: int, max_iters: int = 8,
              theta: float = 1e-4, force: str = "auto"):
    """Fully fused CCG solve -> (y_f, v_star, o_up, o_down, iters, infeasible).

    z/aq: (M,) float32; rn/pn/tier_flat, c1_flat: (F,); b2_flat: (F, K);
    u_all: (P, K) pole deviations; warm_y: (M,) int32 flat warm starts
    (-1 = cold).  Every option is available.  The kernel takes
    F <= 64, K <= 8 and P <= 32.  M is padded up to the block with cold,
    zero-difficulty lanes, sliced off on return.
    """
    if not _build.dispatch("ccg_solve", force, z.device):
        return ccg_solve_ref(z, aq, rn_flat, pn_flat, tier_flat, b2_flat,
                             u_all, c1_flat, warm_y, margin, num_versions,
                             max_iters, theta)
    m = z.shape[0]
    f = rn_flat.shape[0]
    k, p = num_versions, u_all.shape[0]
    if b2_flat.shape != (f, k) or u_all.shape[1] != k or aq.shape != (m,) \
            or warm_y.shape != (m,) or not (f <= 64 and k <= 8 and p <= 32):
        raise ValueError("ccg_solve kernel: inconsistent shapes or F > 64, "
                         "K > 8, P > 32")
    pad = (-m) % BLOCK_M
    lanes = [_build.pad_rows(z, pad), _build.pad_rows(aq, pad)]
    wy = _build.pad_rows(warm_y, pad, value=-1)
    tables = [rn_flat, pn_flat, tier_flat, _build.all_ones(f, z.device),
              b2_flat.t().contiguous(), u_all.contiguous(), c1_flat]
    _build.check_cuda("ccg_solve", *lanes, wy, *tables)
    _build.check_dtype("ccg_solve", torch.float32,
                       **{f"operand{i}": t for i, t in enumerate(lanes + tables)})
    _build.check_dtype("ccg_solve", torch.int32, warm_y=wy)
    mp = m + pad
    dev = z.device
    outs = [torch.empty((mp,), dtype=dt, device=dev) for dt in
            (torch.int32, torch.int32, torch.float32, torch.float32,
             torch.int32, torch.int32)]
    n_steps = min(max_iters, p + 1)
    lib = _build.library()
    code = lib.ccg_solve_launch(
        lanes[0].data_ptr(), lanes[1].data_ptr(), wy.data_ptr(),
        *[t.data_ptr() for t in tables], *[o.data_ptr() for o in outs],
        mp, f, k, p, n_steps, float(margin), float(theta),
        _build.stream_ptr(dev))
    _build.check(code, "ccg_solve")
    _build.LAUNCHES["ccg_solve"] += 1
    y_f, v_star, o_up, o_down, iters, infeas = (o[:m] for o in outs)
    return y_f, v_star, o_up, o_down, iters, infeas > 0
