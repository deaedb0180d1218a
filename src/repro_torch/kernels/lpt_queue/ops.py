"""Dispatching wrapper of LPT packing: the CUDA helper
(``csrc/lpt_queue.cu``) for CUDA tensors, the plain version for CPU tensors
(``force=`` pins either)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lpt_queue.ref import lpt_queue_ref

MAX_SERVERS = 8
MAX_SMEM = 227 * 1024     # bytes of shared memory a Hopper block can opt into


def lpt_queue(t_comp, route, n_edge: int, n_cloud: int, *,
              force: str = "auto"):
    """Per-task queueing delay under LPT packing -> (R, M) float32.

    t_comp/route: (R, M) (a 1-D (M,) pair is one round).  The stable
    longest-first order is one ``torch.argsort`` on the tensors' device for
    both paths; the serial walk is the kernel's (one block per round) or the
    plain version's.  The kernel takes at most 8 servers and M <= 46k tasks.
    """
    one = t_comp.dim() == 1
    if one:
        t_comp, route = t_comp[None], route[None]
    order = torch.argsort(-t_comp, dim=-1, stable=True)
    if not _build.dispatch("lpt_queue", force, t_comp.device):
        out = lpt_queue_ref(t_comp, route, order, n_edge, n_cloud)
        return out[0] if one else out
    n_rounds, m = t_comp.shape
    if route.shape != t_comp.shape or n_edge < 1 or n_cloud < 1 \
            or n_edge + n_cloud > MAX_SERVERS or 5 * m > MAX_SMEM:
        raise ValueError("lpt_queue kernel: route must match t_comp, 2..8 "
                         "servers with both tiers, M <= 46k")
    route = route.contiguous()
    _build.check_cuda("lpt_queue", t_comp, route, order)
    _build.check_dtype("lpt_queue", torch.float32, t_comp=t_comp)
    _build.check_dtype("lpt_queue", torch.int32, route=route)
    start = torch.empty_like(t_comp)
    lib = _build.library()
    code = lib.lpt_queue_launch(
        t_comp.data_ptr(), route.data_ptr(), order.data_ptr(),
        start.data_ptr(), n_rounds, m, n_edge, n_cloud,
        _build.stream_ptr(t_comp.device))
    _build.check(code, "lpt_queue")
    _build.LAUNCHES["lpt_queue"] += 1
    return start[0] if one else start
