"""Dispatching wrapper of LPT packing: the CUDA helper
(``csrc/lpt_queue.cu``) for CUDA tensors, the plain version for CPU tensors
(``force=`` pins either)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lpt_queue.ref import lpt_queue_ref

MAX_SERVERS = 8
MAX_SMEM = 227 * 1024     # bytes of shared memory a Hopper block can opt into


def smem_bytes(m: int) -> int:
    """The kernel's dynamic shared memory for M tasks (``smem_bytes`` in
    ``csrc/lpt_queue.cu``): M padded to 32 plus 32 floats of times, and
    per 32 tasks a word of tier bits and one of cloud counts."""
    mp = -(-m // 32) * 32
    return 4 * (mp + 32) + 8 * (mp // 32) + 16


# the largest M whose dynamic shared memory, beside the kernel's 16 static
# bytes, fits a block: 17/4 bytes a task
MAX_TASKS = (MAX_SMEM - 16 - 144) * 4 // 17 // 32 * 32


def lpt_queue(t_comp, route, n_edge: int, n_cloud: int, *, avail=None,
              force: str = "auto"):
    """Per-task queueing delay under LPT packing -> (R, M) float32.

    t_comp/route: (R, M) (a 1-D (M,) pair is one round).  ``avail``:
    optional (R, n_edge + n_cloud) per-server availability (edge servers
    first; (S,) with a 1-D pair), as the reference's: a dead server starts
    at +inf load.  The stable longest-first order is one ``torch.argsort``
    on the tensors' device for both paths; the serial walk is the kernel's
    (one block per round) or the plain version's.  The kernel takes at most
    8 servers and M <= ``MAX_TASKS`` (54,656) tasks.
    """
    one = t_comp.dim() == 1
    if one:
        t_comp, route = t_comp[None], route[None]
    init = None
    if avail is not None:
        avail = avail[None] if one else avail
        init = torch.where(avail > 0, 0.0, torch.inf).to(
            device=t_comp.device, dtype=torch.float32).contiguous()
    order = torch.argsort(-t_comp, dim=-1, stable=True)
    if not _build.dispatch("lpt_queue", force, t_comp.device):
        out = lpt_queue_ref(t_comp, route, order, n_edge, n_cloud, init)
        return out[0] if one else out
    n_rounds, m = t_comp.shape
    if route.shape != t_comp.shape or n_edge < 1 or n_cloud < 1 \
            or n_edge + n_cloud > MAX_SERVERS or m > MAX_TASKS \
            or init is not None and init.shape != (n_rounds, n_edge + n_cloud):
        raise ValueError(f"lpt_queue kernel: route must match t_comp, avail "
                         f"(R, servers), 2..8 servers with both tiers, M <= "
                         f"{MAX_TASKS}")
    route = route.contiguous()
    _build.check_cuda("lpt_queue", t_comp, route, order,
                      *(() if init is None else (init,)))
    _build.check_dtype("lpt_queue", torch.float32, t_comp=t_comp)
    _build.check_dtype("lpt_queue", torch.int32, route=route)
    start = torch.empty_like(t_comp)
    lib = _build.library()
    code = lib.lpt_queue_launch(
        t_comp.data_ptr(), route.data_ptr(), order.data_ptr(),
        None if init is None else init.data_ptr(), start.data_ptr(),
        n_rounds, m, n_edge, n_cloud, _build.stream_ptr(t_comp.device))
    _build.check(code, "lpt_queue")
    _build.LAUNCHES["lpt_queue"] += 1
    return start[0] if one else start
