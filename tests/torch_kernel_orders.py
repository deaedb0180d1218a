"""Emulations, in torch float32 operations, of the orders of work of
CUDA kernels: ``gate_cell`` (``csrc/temporal_gate.cu``) and the two
``c6_repair`` kernels (``csrc/c6_tail.cu``: one block, and one thread
block cluster).  They import no JAX, so the CPU tests and the card's
tests (``test_torch_kernels_cuda.py``, run with ``--noconftest``) share
them.  Run on the card, an emulation gives the kernel's bits: each float32
operation is one torch elementwise operation, rounded alone (torch does not
contract a multiply and an add), in the kernel's order.
"""
import numpy as np
import torch

from repro_torch.kernels.c6_tail.ref import c6_tail_ref, compare_repairs
from repro_torch.kernels.temporal_gate.ref import pack_weights


def _sigmoid(x):
    """The kernels' sigmoid, 1 / (1 + exp(−x)) (not torch.sigmoid)."""
    return 1.0 / (1.0 + torch.exp(-x))


def _butterfly(v):
    """The warp's xor-butterfly sum over the last axis (32 lanes): every
    lane ends with the same value."""
    lane = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ off]
    return v[..., 0]


def _gate_epilogue(xg, xr, xh, hg, hr, h, vol, p, uh_product):
    """Eq. 5–6 from the packed products, in the kernels' operations; the
    candidate's U_h product is ``uh_product(r·h)``."""
    m = h.shape[1]
    g = _sigmoid(xg + hg + p["b_g"] + p["alpha"].reshape(()) * vol[:, None])
    r = _sigmoid(xr + hr + p["b_r"])
    c = uh_product(r * h)
    cand = torch.tanh(xh + c + p["b_h"])
    hn = (1.0 - g) * h + g * cand
    tau = _sigmoid(_butterfly(hn * p["w_o"][:, 0]) + p["b_o"].reshape(()))
    return hn, tau, _butterfly(g) / float(m)


def gate_cell_pr11(dx, h, vol, p):
    """The first design's order (one warp a stream, lane j = unit j, the dx
    row broadcast by shuffles): every dot product summed k ascending, a
    multiply then an add, from 0."""
    w_x, u_gr = pack_weights(p)
    m = h.shape[1]

    def dot(x, w):
        acc = torch.zeros((x.shape[0], w.shape[1]), device=x.device)
        for k in range(x.shape[1]):
            acc = acc + x[:, k, None] * w[k]
        return acc

    xw, hu = dot(dx, w_x), dot(h, u_gr)
    return _gate_epilogue(xw[:, :m], xw[:, m:2 * m], xw[:, 2 * m:],
                          hu[:, :m], hu[:, m:], h, vol, p,
                          lambda rh: dot(rh, p["u_h"]))


def gate_cell_tiled(dx, h, vol, p, tile=32, per_warp=2):
    """The persistent kernel's order: tiles of ``tile`` streams, a warp's
    ``per_warp`` streams with their own accumulators, the k-loop over dx
    in groups of four (one 16-byte broadcast of each stream's row; two
    groups a step) and then the d mod 4 rest, h·U_gr and (r·h)·U_h in
    groups of four; rows past B are masked (computed on zeros here, never
    stored)."""
    w_x, u_gr = pack_weights(p)
    b, d = dx.shape
    m = h.shape[1]
    n_tiles = -(-b // tile)
    pad = n_tiles * tile - b

    def padded(t):
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

    dxp, hp, volp = padded(dx), padded(h), padded(vol)
    outs = []
    for t in range(n_tiles):
        sl = slice(t * tile, (t + 1) * tile)
        x, hh = dxp[sl].reshape(-1, per_warp, d), hp[sl].reshape(-1, per_warp, m)
        acc = [torch.zeros((x.shape[0], per_warp, m), device=dx.device)
               for _ in range(5)]
        for k0 in range(0, d - d % 4, 4):
            for u in range(4):
                k = k0 + u
                for j in range(3):
                    acc[j] = acc[j] + x[:, :, k, None] * w_x[k, j * m:(j + 1) * m]
        for k in range(d - d % 4, d):
            for j in range(3):
                acc[j] = acc[j] + x[:, :, k, None] * w_x[k, j * m:(j + 1) * m]
        for k in range(m):
            for j in range(2):
                acc[3 + j] = acc[3 + j] + hh[:, :, k, None] * u_gr[
                    k, j * m:(j + 1) * m]

        def uh_product(rh):
            c = torch.zeros_like(rh)
            for k in range(m):
                c = c + rh[:, k, None] * p["u_h"][k]
            return c

        flat = [a.reshape(-1, m) for a in acc]
        outs.append(_gate_epilogue(*flat, hh.reshape(-1, m), volp[sl], p,
                                   uh_product))
    return tuple(torch.cat(o)[:b] for o in zip(*outs))


# ---------------------------------------------------------------- c6_repair

THREADS = 1024


def compare_runs(run_a, run_b, rounds, args, budget, exempt=(),
                 task_mask=None):
    """``compare_repairs`` asserted: returns the rounds that demote (or the
    first round that differs, all its differing tasks exempt)."""
    out = compare_repairs(run_a, run_b, rounds, args, budget,
                          args[8].shape[0], exempt, task_mask)
    assert out["within"], out
    if out["first_differing_round"] is not None:
        print(f"round {out['first_differing_round']} differs on exempt "
              f"tasks only")
        return out["first_differing_round"]
    return out["rounds_demoting"]


def _order_keys(gain, can_p):
    """The kernel's 64-bit keys of the tasks with a positive gain, as
    (indices in ascending key order, can_p): the gain's float bits
    inverted above (larger gain first), the index below."""
    idx = torch.nonzero(gain > 0).flatten().cpu().numpy()
    bits = gain[gain > 0].cpu().numpy().view(np.uint32)
    order = idx[np.lexsort((idx, ~bits))]
    return order, can_p.cpu().numpy()[order]


def _kogge_stone(v):
    """Inclusive Kogge–Stone scan over the last axis (32 lanes): each lane
    adds the value ``off`` lanes below it, off = 1, 2, 4, 8, 16."""
    for off in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :off], v[..., off:] + v[..., :-off]], dim=-1)
    return v


def _exclusive(incl):
    return torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]],
                     dim=-1)


def block_sum(x, threads=THREADS):
    """The kernel's sum of x (M,): thread t adds tasks t, t + threads, ...
    from 0; a butterfly in each warp; a butterfly over the warps' sums."""
    k = -(-x.shape[0] // threads)
    xs = torch.cat([x, x.new_zeros(k * threads - x.shape[0])])
    part = torch.zeros(threads, device=x.device)
    for row in xs.reshape(k, threads):
        part = part + row
    warps = _butterfly(part.reshape(-1, 32))    # lanes past the warps: 0
    warps = torch.cat([warps, warps.new_zeros(32 - warps.shape[0])])
    return _butterfly(warps[None])[0]


def exclusive_prefix(g, threads=THREADS):
    """The kernel's exclusive prefix sums of the sorted gains g (n,):
    contiguous chunks of ⌈n/threads⌉ per thread summed from 0, the chunk
    totals scanned by Kogge–Stone in each warp and over the warps' totals,
    then the running sum down each chunk."""
    n = g.shape[0]
    per = max(1, -(-n // threads))
    gs = torch.cat([g, g.new_zeros(per * threads - n)]).reshape(threads, per)
    chunk = torch.zeros(threads, device=g.device)
    for q in range(per):
        chunk = chunk + gs[:, q]
    incl = _kogge_stone(chunk.reshape(-1, 32))
    w_excl = _exclusive(_kogge_stone(incl[:, -1]))
    prefix = (w_excl[:, None] + _exclusive(incl)).reshape(-1)
    cum, out = prefix, []
    for q in range(per):
        out.append(cum)
        cum = cum + gs[:, q]
    return torch.stack(out, dim=1).reshape(-1)[:n]


def c6_repair_emulated(*args, trace=None, task_mask=None, **kw):
    """The one-block repair kernel's order of work -> (r, p, bw_history):
    the cluster kernel's (``c6_repair_cluster_emulated``) on one block, whose
    draw is one ``block_sum`` and whose keys' gains before them are their
    block's exclusive prefix.  ``trace`` and ``task_mask`` as there."""
    return c6_repair_cluster_emulated(*args, blocks=1, trace=trace,
                                      task_mask=task_mask, **kw)


# ------------------------------------------------------- c6_repair, cluster

CLUSTER_TASKS = 16384     # tasks a block of the cluster kernel holds
CLUSTER_BLOCKS = 16       # blocks a cluster launch takes


def cluster_shape(m: int, blocks=None):
    """The cluster kernel's (blocks, tasks a block) for M tasks: 16 blocks
    (more where ⌈M / 16,384⌉ is more) unless ``blocks`` is given, ⌈M /
    blocks⌉ tasks rounded up to 32; block b owns tasks [b·T, (b+1)·T)."""
    if blocks is None:
        blocks = max(CLUSTER_BLOCKS, -(-m // CLUSTER_TASKS))
    return blocks, -(-(-(-m // blocks)) // 32) * 32


def _keys(gain, idx, can_p):
    """The kernel's 64-bit keys (numpy uint64) of tasks ``idx``: the
    gain's float bits inverted above, index·2 + can_p below."""
    bits = gain.cpu().numpy().view(np.uint32).astype(np.uint64)
    low = (idx.astype(np.uint64) << np.uint64(1)) | can_p.astype(np.uint64)
    return ((~bits & np.uint64(0xffffffff)) << np.uint64(32)) | low


def c6_repair_cluster_emulated(bw_panel, r, p, v, route, z, acc_thr, rn, pn,
                               budget, n_fps: int, rounds: int, blocks=None,
                               threads=THREADS, trace=None, task_mask=None):
    """The cluster repair kernel's order of work -> (r, p, bw_history), on
    ``blocks`` blocks of ``threads`` threads (``cluster_shape``).  Per
    round: each block's draw summed as ``block_sum`` over its own tasks,
    the blocks' sums added in block order; the early stop on that total
    and the key count; each block's positive-gain keys sorted and their
    exclusive prefix taken as ``exclusive_prefix`` over the block's sorted
    gains, its total after the last key; then each key's gain before it in
    the cluster's order, summed in block order: its own block's prefix,
    and for every other block that block's prefix at the key's rank among
    its keys (its total when all sort before).  ``trace``, a list,
    receives per round run (excess, the sorted gains, their indices and
    their gains before, all in the cluster's key order).  ``task_mask``:
    the alive mask; a dead lane draws 0 and gains 0."""
    dev = bw_panel.device
    budget = torch.as_tensor(budget, dtype=torch.float32, device=dev)
    r, p = r.long().clone(), p.long().clone()
    v32, route32 = v.to(torch.int32), route.to(torch.int32)
    n_blocks, tasks = cluster_shape(r.shape[0], blocks)
    spans = [(b * tasks, min(r.shape[0], (b + 1) * tasks))
             for b in range(n_blocks)]
    hist = []
    for _ in range(rounds):
        bw, gain, can_p = c6_tail_ref(bw_panel, r, p, v32, route32, z,
                                      acc_thr, rn, pn, n_fps)
        if task_mask is not None:
            bw = torch.where(task_mask, bw, 0.0)
            gain = torch.where(task_mask, gain, 0.0)
        total = None
        for lo, hi in spans:
            d = block_sum(bw[lo:hi], threads)
            total = d if total is None else total + d
        excess = total - budget
        drawn = excess + budget
        hist.append(drawn)
        blk = []                  # per block: indices, keys, gains, prefix
        for lo, hi in spans:
            order, cp = _order_keys(gain[lo:hi], can_p[lo:hi])
            order = order + lo
            g = gain[torch.from_numpy(order).to(dev)]
            if order.size:
                excl = exclusive_prefix(g, threads)
                pre = torch.cat([excl, excl[-1:] + g[-1:]])
            else:
                pre = torch.zeros(1, device=dev)
            blk.append((order, _keys(g, order, cp), g, pre, cp))
        if not bool(excess > 0) or sum(b[0].size for b in blk) == 0:
            hist += [drawn] * (rounds - len(hist))
            break
        demoted, rows = [], []
        for b, (order, keys, g, pre, cp) in enumerate(blk):
            before = None
            for c, (_, keys_c, _, pre_c, _) in enumerate(blk):
                at = np.searchsorted(keys_c, keys) if c != b \
                    else np.arange(order.size)
                term = pre_c[torch.from_numpy(at).to(dev)]
                before = term if before is None else before + term
            demote = (before < excess).cpu().numpy()
            demoted.append((order[demote], cp[demote]))
            rows.append((keys, g, order, before))
        if trace is not None:
            keys = np.concatenate([row[0] for row in rows])
            at = torch.from_numpy(np.argsort(keys)).to(dev)
            trace.append((excess, torch.cat([row[1] for row in rows])[at],
                          np.concatenate([row[2] for row in rows])[
                              at.cpu().numpy()],
                          torch.cat([row[3] for row in rows])[at]))
        for order, cp in demoted:
            i_p = torch.from_numpy(order[cp]).to(dev)
            i_r = torch.from_numpy(order[~cp]).to(dev)
            p[i_p] = torch.clamp_min(p[i_p] - 1, 0)
            r[i_r] = torch.clamp_min(r[i_r] - 1, 0)
    hist = torch.stack(hist) if hist else torch.zeros((0,), device=dev)
    return r, p, hist
