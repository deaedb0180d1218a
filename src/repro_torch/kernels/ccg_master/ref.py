"""Plain PyTorch version of the CCG master step (paper Alg. 2, MP1), port of
``repro/kernels/ccg_master/ref.py``: the scenario-masked recourse maximum
η(y), the feasibility-masked objective c1 + η and its first argmin over the
F first-stage options.  The CUDA kernel (``csrc/ccg_master.cu``) reproduces
it bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.lattice import BIG


def ccg_master_ref(rec_all, scen_mask, fs_ok, c1):
    """One masked MP1 step for a task batch.

    rec_all: (M, P, F) recourse of every pole/option pair; scen_mask: (M, P)
    0/1 generated-scenario indicators; fs_ok: (M, F) bool feasibility; c1:
    (F,) first-stage cost.  Returns ``(y_star (M,) int32, o_down (M,))``.
    A task with no scenario gets η = 0; infeasible options score BIG.
    """
    active = torch.where(scen_mask[..., None] > 0, rec_all, -BIG)
    any_scen = scen_mask.sum(dim=-1, keepdim=True) > 0
    eta = torch.where(any_scen, active.amax(dim=-2), 0.0)        # (M, F)
    obj = torch.where(fs_ok, c1 + eta, BIG)
    o_down, y_star = obj.min(dim=-1)
    return y_star.to(torch.int32), o_down
