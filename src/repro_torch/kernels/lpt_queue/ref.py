"""Plain PyTorch version of longest-processing-time (LPT) packing, port of
the scan in ``repro/serving/simulator.py:_lpt_queue``.

Not a TPU kernel in the reference (a ``lax.scan`` over the sorted tasks); on
the card its serial walk is the CUDA helper ``csrc/lpt_queue.cu``.
"""
from __future__ import annotations

import torch


def lpt_queue_ref(t_comp, route, order, n_edge: int, n_cloud: int,
                  init=None):
    """Queueing delay of every task under LPT packing, round by round.

    t_comp: (R, M) float32 compute times; route: (R, M) tier per task;
    order: (R, M) the stable longest-first order (``argsort(-t_comp)``);
    init: optional (R, n_edge + n_cloud) starting loads (+inf for a dead
    server), zeros when None.  Tasks are placed in that order on the
    least-loaded server of their tier (edge servers first, the lowest index
    wins ties; the argmin runs over every server with the other tier's
    masked to +inf, so a task whose tier is all at +inf lands on server 0);
    a task's delay is the load of its server when it is placed.  Returns
    (R, M) float32.
    """
    n_rounds, m = t_comp.shape
    dev = t_comp.device
    server_tier = torch.cat([
        torch.zeros(n_edge, dtype=torch.int64, device=dev),
        torch.ones(n_cloud, dtype=torch.int64, device=dev)])
    tc_s = t_comp.gather(1, order)
    rt_s = route.long().gather(1, order)
    loads = torch.zeros((n_rounds, n_edge + n_cloud), dtype=t_comp.dtype,
                        device=dev) if init is None else init.clone()
    start_s = torch.empty_like(tc_s)
    for i in range(m):
        masked = torch.where(server_tier[None] == rt_s[:, i:i + 1], loads,
                             torch.inf)
        j = masked.argmin(dim=1, keepdim=True)      # first index on ties
        start_s[:, i] = loads.gather(1, j)[:, 0]
        loads.scatter_add_(1, j, tc_s[:, i:i + 1])
    return torch.zeros_like(t_comp).scatter(1, order, start_s)
