"""Dispatching wrapper of the fused CCG solve: the CUDA kernel
(``csrc/ccg_solve.cu``) for CUDA tensors, the plain version for CPU tensors
(``force=`` pins either)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ccg_solve.ref import ccg_solve_ref


def ccg_solve(z, aq, rn_flat, pn_flat, tier_flat, b2_flat, u_all, c1_flat,
              warm_y, *, margin: float, num_versions: int, max_iters: int = 8,
              theta: float = 1e-4, force: str = "auto", y_ok=None):
    """Fully fused CCG solve -> (y_f, v_star, o_up, o_down, iters, infeasible).

    z/aq: (M,) float32; rn/pn/tier_flat, c1_flat: (F,); b2_flat: (F, K);
    u_all: (P, K) pole deviations; warm_y: (M,) int32 flat warm starts
    (-1 = cold); y_ok: optional (F,) float32 availability, as the
    reference's: an option at ``y_ok <= 0`` (a tier out) is infeasible and
    out of the all-infeasible fallback; None leaves every option up.  The
    kernel takes F <= 64, K <= 8 and P <= 32, and any M (one warp a task);
    K <= 5 takes its table instantiation, a larger K its generic one.
    """
    if not _build.dispatch("ccg_solve", force, z.device):
        return ccg_solve_ref(z, aq, rn_flat, pn_flat, tier_flat, b2_flat,
                             u_all, c1_flat, warm_y, margin, num_versions,
                             max_iters, theta, y_ok=y_ok)
    _build.refuse_grad("ccg_solve", z, aq, rn_flat, pn_flat, tier_flat,
                       b2_flat, u_all, c1_flat, y_ok)
    m = z.shape[0]
    f = rn_flat.shape[0]
    k, p = num_versions, u_all.shape[0]
    if b2_flat.shape != (f, k) or u_all.shape[1] != k or aq.shape != (m,) \
            or warm_y.shape != (m,) or not (f <= 64 and k <= 8 and p <= 32) \
            or y_ok is not None and y_ok.shape != (f,):
        raise ValueError("ccg_solve kernel: inconsistent shapes or F > 64, "
                         "K > 8, P > 32")
    ok = _build.all_ones(f, z.device) if y_ok is None else y_ok
    tables = [rn_flat, pn_flat, tier_flat, ok,
              b2_flat.t().contiguous(), u_all.contiguous(), c1_flat]
    _build.check_cuda("ccg_solve", z, aq, warm_y, *tables)
    _build.check_dtype("ccg_solve", torch.float32,
                       **{f"operand{i}": t for i, t in enumerate([z, aq]
                                                                 + tables)})
    _build.check_dtype("ccg_solve", torch.int32, warm_y=warm_y)
    dev = z.device
    outs = [torch.empty((m,), dtype=dt, device=dev) for dt in
            (torch.int32, torch.int32, torch.float32, torch.float32,
             torch.int32, torch.int32)]
    n_steps = min(max_iters, p + 1)
    lib = _build.library()
    code = lib.ccg_solve_launch(
        z.data_ptr(), aq.data_ptr(), warm_y.data_ptr(),
        *[t.data_ptr() for t in tables], *[o.data_ptr() for o in outs],
        m, f, k, p, n_steps, float(margin), float(theta),
        _build.stream_ptr(dev))
    _build.check(code, "ccg_solve")
    _build.LAUNCHES["ccg_solve"] += 1
    y_f, v_star, o_up, o_down, iters, infeas = outs
    return y_f, v_star, o_up, o_down, iters, infeas > 0
