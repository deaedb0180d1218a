"""Dispatching wrapper of the fused gating cell: the CUDA kernel
(``csrc/temporal_gate.cu``) for CUDA tensors, the plain version for CPU
tensors (``force=`` pins either)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.temporal_gate.ref import gate_cell_ref, pack_weights


def gate_cell(dx, h, vol, p, *, force: str = "auto"):
    """Fused gating cell for a (B, d) stream batch -> (h_new, tau, g_mean).

    The kernel takes m = 32 hidden units and d <= 64 features in float32,
    any B (the last tile of streams is masked in the kernel).
    """
    if not _build.dispatch("gate_cell", force, dx.device):
        return gate_cell_ref(dx, h, vol, p)
    b, d = dx.shape
    m = h.shape[1]
    if m != 32 or not 1 <= d <= 64 or h.shape[0] != b or vol.shape != (b,):
        raise ValueError(f"gate_cell kernel: need dx (B, d<=64), h (B, 32), "
                         f"vol (B,); got {tuple(dx.shape)}, {tuple(h.shape)}, "
                         f"{tuple(vol.shape)}")
    w_x, u_gr = pack_weights(p)
    weights = [w_x, u_gr, p["b_g"], p["alpha"].reshape(1), p["b_r"], p["u_h"],
               p["b_h"], p["w_o"], p["b_o"]]
    if w_x.shape != (d, 3 * m) or p["u_h"].shape != (m, m) \
            or p["w_o"].shape != (m, 1):
        raise ValueError("gate_cell kernel: weight shapes do not match dx/h")
    ins = [dx, h, vol] + [w.contiguous() for w in weights]
    _build.check_cuda("gate_cell", *ins)
    _build.check_dtype("gate_cell", torch.float32,
                       **{f"operand{i}": t for i, t in enumerate(ins)})
    h_new = torch.empty((b, m), dtype=torch.float32, device=dx.device)
    tau = torch.empty((b,), dtype=torch.float32, device=dx.device)
    g_mean = torch.empty((b,), dtype=torch.float32, device=dx.device)
    lib = _build.library()
    code = lib.gate_cell_launch(
        *[t.data_ptr() for t in ins], h_new.data_ptr(), tau.data_ptr(),
        g_mean.data_ptr(), b, d, m, _build.stream_ptr(dx.device))
    _build.check(code, "gate_cell")
    _build.LAUNCHES["gate_cell"] += 1
    return h_new, tau, g_mean
