#!/usr/bin/env python3
"""Smoke run of the PyTorch port of the R2E-VID router on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, one JSON line each; any failure exits non-zero:

1. ``device``    the card (``torch.cuda``) and its name and power limit
                 (``nvidia-smi``); no CUDA means exit 1 with no result.
2. ``build``     nvcc builds ``src/repro_torch/kernels/csrc/*.cu`` into
                 ``build/repro_torch_kernels/`` (or loads the built library).
3. ``kernels``   every kernel against its plain PyTorch version on the card,
                 at the paths' shapes (M = 4096) and at a ragged M = 4093:
                 gate_cell within 1e-5, ccg_solve, c6_tail, lpt_queue (on
                 all-edge routes, the main path's, and also on all-cloud
                 and mixed routes and with a server down; timed on the
                 main path's routes and on mixed ones),
                 ccg_encode (also with a real availability mask) and
                 ccg_master (also on slabs with ties, empty scenario rows
                 and all-infeasible rows) exact; decode_attention and
                 flash_attention at the dispatch path's shapes for both tier
                 models (slab of 16 × 144 entries at ragged lengths 1..144;
                 prefills of B ∈ {1, 2, 4, 8} × 16..80 tokens) and at ragged,
                 windowed and non-causal shapes, and at RecurrentGemma's
                 (MQA with G = 16, D = 256, a slab of 16 × 80 entries,
                 window 2048), within 2e-2 + 2e-2·|plain| in bf16 and
                 2e-5 + 2e-5·|plain| in float32; mamba_scan and rglru_scan
                 at the recurrent pools' decode step (16 rows) and longest
                 prefill (8 × 80) and at ragged shapes, x in bf16 and
                 float32, h0 given, None and aliasing h_out, within
                 1e-5 + 1e-5·|plain|; kernel, plain and library times (CUDA
                 events or the profiler, median after warm-up; SDPA's
                 device time beside its event time) and each kernel's
                 bound: the larger of its bytes and its compute, where
                 exponentials and square roots may be split between the
                 special-function units and polynomials on the CUDA cores,
                 and for lpt_queue the serial chain of its walk.
4. ``main_path`` ``make_policy("r2evid") → ServeSession.run`` on M = 4096
                 streams for R = 16 rounds of a seeded ``sample_stream``, with
                 random seeded gate weights, launch counters zeroed just
                 before and read just after; then the same run on the plain
                 versions (``force="ref"``) on the card, whose decisions must
                 agree on >= 99.9% of lane-rounds; then rounds/s and
                 segments/s (median of three runs after one warm-up).
5. ``trace``     one profiled run of the main path: device busy time and
                 idle share per round, device activities and host<->device
                 copies per round, the costliest device activities.
6. ``solve_ccg`` the unrolled CCG solver at M = 4096 on round 0 of the
                 stream, cold and warm-started from Stage 1: on the kernels
                 (launch counters zeroed just before and read just after:
                 ccg_encode 1, ccg_master 8 per solve), on the plain
                 versions with the running-η master, and as the fused
                 ``solve_ccg_fused`` on the ccg_solve kernel; the three must
                 agree on route/r/p/v/iters/infeasible on every lane.
7. ``policies``  the paper's method comparison: a2_cloud_only, jcab, rdap,
                 sniper, r2evid in τ-proxy mode and its no-Stage-1 and
                 no-Stage-2 ablations through ``ServeSession.run`` on the
                 main path's stream (M = 4096, R = 16, no motion features):
                 launch counts, rounds/s (median of three runs after a
                 warm-up) and ``Simulator.aggregate``'s paper scalars; the
                 τ-proxy run also on the plain versions, with bit-equal
                 decisions.
8. ``dispatch``  the tier pools at full width and depth (Qwen1.5-0.5B edge,
                 Qwen3-8B cloud, bf16, random weights from seeded
                 generators): (a) ``ServeSession.dispatch`` of a gate-mode
                 round over the first 256 streams of the main path's stream,
                 (b) a fixed request set on both tiers at every prompt length
                 16..80; after an untimed warm-up of (b) on both paths, each
                 on the kernels (launch counters zeroed just
                 before and read just after: flash_attention = layers ×
                 prefills, decode_attention = layers × decode steps) and on
                 the plain versions (``force="ref"``, the same weights).
                 Per tier: requests, tokens/s, p50/p99 latency, decoded ids
                 equal wherever the plain path's top-2 logit margin exceeds
                 0.125, the max |Δ| of first-token logits.  Then
                 ``apply_feedback`` and one more routed round on the
                 fed-back observation; last, a decode step and a prefill
                 per tier, timed on both paths in turns and profiled
                 (device busy time, idle share, top device and host costs).
9. ``dispatch_recurrent``  the same phase on the sub-quadratic tier pools,
                 after the dense pools are freed: Falcon-Mamba-7B (64 Mamba
                 layers) as the edge tier and RecurrentGemma-9B (26 RG-LRU
                 and 12 local-attention layers) as the cloud tier, full
                 width and depth in bf16; launches: mamba_scan = layers ×
                 (prefills + decode steps), rglru_scan likewise,
                 flash_attention and decode_attention = attention layers ×
                 prefills and × decode steps.  Its routed round takes the
                 first 64 streams, not 256, and its profiled windows 2
                 calls, not 5: the plain selective scan is a Python loop
                 over the steps of every layer (~1 s for an 8 × 80
                 prefill), and every id flip is replayed on it.

The last three lines are the kernels' JSON line, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.  ``--out DIR`` also
writes the nvcc/ptxas build log and every phase's record there.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
M, M_RAGGED, ROUNDS = 4096, 4093, 16
# H100 SXM peaks (NVIDIA's data sheet) and the clocks they imply
HBM_BYTES_PER_S = 3.35e12        # device memory
FP32_FLOP_PER_S = 67e12          # float32 outside the tensor cores: 132 SMs ×
                                 # 128 lanes × 2 (multiply-add) × 1.98 GHz
BF16_FLOP_PER_S = 989e12         # dense bf16 on the tensor cores: 132 SMs ×
                                 # 4096 operations a clock × 1.83 GHz
SFU_OP_PER_S = 132 * 16 * 1.98e9  # exp, sqrt, reciprocal on the special
                                  # function units: 16 a clock per SM
SFU_POLY_FLOPS = 8               # float32 operations of one of them on the
                                 # CUDA cores instead: exp2 as a polynomial
                                 # after range reduction (FlashAttention-4),
                                 # sqrt as a bit-level estimate and Newton steps
SM_CLOCK_HZ = 1.98e9             # the boost clock the peaks above assume
CHAIN_CLOCKS = 4                 # latency of one dependent float32 operation
SLOTS, SLAB = 16, 80 + 64        # the dispatch slab: slots × cache entries
PROMPTS = (16, 32, 48, 64, 80)   # prompt lengths 16·(1 + r)
LOGIT_MARGIN = 0.125             # bf16 greedy-id comparison margin
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # atol = rtol
SCAN_TOL = 1e-5                  # atol = rtol, the scans (float32 outputs)
PORTED_MODEL_KERNELS = ("flash_attention_kernel", "decode_attention_kernel",
                        "mamba_scan_kernel", "rglru_scan_kernel")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms_turns(torch, fns: dict, reps: int, warmup: int = 2) -> dict:
    """Median CUDA-event time of one call of each of ``fns`` (stream time,
    wrapper included), the calls taken in turns (a, b, a, b, ...) so that a
    drift of the host's speed reaches them alike."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def event_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of one call (stream time, wrapper included)."""
    return event_ms_turns(torch, {"fn": fn}, reps, warmup)["fn"]


def device_ms(torch, fn, symbol=None, reps: int = 20):
    """Mean device time of the kernel named ``symbol`` per launch or, with
    no symbol, of every device activity of ``fn`` per call (a library call
    that runs several kernels), from the profiler's CUPTI trace; None when
    the trace shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a trace now and then comes back without them
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for evt in prof.key_averages():
            if symbol is None and evt.device_type == DeviceType.CUDA \
                    or symbol is not None and symbol in evt.key:
                total += getattr(evt, "self_device_time_total", 0.0)
                count += evt.count
        count = reps if symbol is None else count
        if count and total > 0:
            return total / 1e3 / count
    return None


def compute_ms(flops: float, flop_per_s: float = FP32_FLOP_PER_S,
               sfu_ops: float = 0.0):
    """The least compute time (ms) of ``flops`` operations at ``flop_per_s``
    and ``sfu_ops`` exponentials and square roots (given only beside float32
    operations), and which pipe sets it.  "operations" when the CUDA cores
    take longer than the SFUs would for all of ``sfu_ops``; else "sfu": the
    best split of them between the SFUs and polynomials on the CUDA cores,
    where both pipes finish at once."""
    t_ops = flops / flop_per_s * 1e3
    if sfu_ops / SFU_OP_PER_S * 1e3 <= t_ops:
        return t_ops, "operations"
    # x moved to the cores: (sfu_ops - x) / sfu rate = (flops + c·x) / fp32 rate
    return ((flops + SFU_POLY_FLOPS * sfu_ops)
            / (FP32_FLOP_PER_S + SFU_POLY_FLOPS * SFU_OP_PER_S) * 1e3, "sfu")


def bound(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S,
          sfu_ops: float = 0.0, chain_ms: float = 0.0):
    """The least time (ms) the card could take: the largest of the bytes
    over the memory rate, ``compute_ms`` and ``chain_ms`` (a serial chain of
    dependent operations, see ``lpt_chain_ms``); and which term it is
    ("bytes", "operations", "sfu" or "chain")."""
    terms = [(nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
             compute_ms(flops, flop_per_s, sfu_ops), (chain_ms, "chain")]
    return max(terms, key=lambda term: term[0])


def lpt_chain_ms(route, n_edge: int, n_cloud: int) -> float:
    """The least time (ms) of LPT packing's serial walk over one round.  A
    task depends on every earlier task of its own tier and on none of the
    other tier's, so the two tiers' chains can run side by side and the
    longer one sets the time.  A step is one add on a single server; on
    more servers, kept sorted by (load, index), the add, the compare of the
    sum with the second-least load and the select of the next least load:
    1 or 3 dependent operations of ``CHAIN_CLOCKS`` clocks each at
    ``SM_CLOCK_HZ``, counted over this round's routes (0 edge, else
    cloud)."""
    n_cloud_tasks = float((route != 0).sum())
    n_edge_tasks = float(route.numel()) - n_cloud_tasks
    ops = max(n_tasks * (1 if n == 1 else 3) for n_tasks, n in
              ((n_edge_tasks, n_edge), (n_cloud_tasks, n_cloud)))
    return ops * CHAIN_CLOCKS / SM_CLOCK_HZ * 1e3


def max_abs(torch, got, want) -> float:
    return max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def kernel_phase(torch, stream, dev):
    """Each kernel vs its plain version at M and M_RAGGED, plus timings."""
    from repro_torch.core.cost_model import SystemConfig, fps_norm, res_norm
    from repro_torch.core.gating import GateConfig, init_gate_params
    from repro_torch.core.lattice import BIG
    from repro_torch.core.robust import RobustProblem
    from repro_torch.core.router import stage1_configure
    from repro_torch.kernels.c6_tail.ops import c6_tail
    from repro_torch.kernels.ccg_encode.ops import ccg_encode
    from repro_torch.kernels.ccg_master.ops import ccg_master
    from repro_torch.kernels.ccg_solve.ops import ccg_solve
    from repro_torch.kernels.lpt_queue.ops import lpt_queue
    from repro_torch.kernels.temporal_gate.ops import gate_cell
    from repro_torch.kernels.temporal_gate.ref import pack_weights

    sys_ = SystemConfig()
    prob = RobustProblem.build(sys_, dev)
    lat = prob.lat
    gen = torch.Generator().manual_seed(7)
    gp = init_gate_params(GateConfig(d_feature=35), gen, dev)
    gp = {k: v + 0.1 * torch.randn(v.shape, generator=gen).to(dev)
          if k.startswith("b_") else v for k, v in gp.items()}
    f_k, F, K = 5, lat.n_flat, sys_.num_versions
    P = prob.poles.shape[0]
    rn, pn = res_norm(sys_, dev), fps_norm(sys_, dev)

    def rand(shape, lo=0.0, hi=1.0):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dev)

    def ints(m, hi):
        return torch.randint(0, hi, (m,), generator=gen,
                             dtype=torch.int32).to(dev)

    enc_kw = dict(margin=sys_.acc_margin_robust, num_versions=K)

    def enc_args(z, aq):
        return (z, aq, lat.rn_flat, lat.pn_flat, lat.tier_flat,
                prob.b2_scaled, prob.rec_table)

    def master_first_step(z, aq):
        """The master's inputs at the first step of a solve warm-started
        from Stage 1: the round's slab, its feasibility, and each task's
        warm pole as its one generated scenario."""
        m = z.shape[0]
        code, rec_all, _ = ccg_encode(*enc_args(z, aq), force="ref",
                                      **enc_kw)
        none = torch.full((m,), -1, dtype=torch.int64, device=dev)
        route, r = stage1_configure(lat, z, z, aq, none, torch.zeros_like(z))
        wy = lat.flatten_index(route, r, sys_.n_fps - 1)
        fs_ok = code > 0
        rec_wy = rec_all.gather(2, wy[:, None, None].expand(-1, P, 1))[..., 0]
        use = fs_ok.gather(1, wy[:, None])[:, 0]
        pole = rec_wy.argmax(1)[:, None]
        scen = ((torch.arange(P, device=dev)[None] == pole)
                & use[:, None]).to(torch.float32)
        return rec_all, scen, fs_ok, lat.c1_flat

    def master_ties(m):
        """A slab on a coarse grid (ties everywhere), with empty scenario
        rows, full ones, all-infeasible rows and BIG recourse entries."""
        rec = (torch.randint(0, 6, (m, P, F), generator=gen) * 0.125)
        rec[torch.rand((m, P, F), generator=gen) < 0.05] = BIG
        scen = (torch.rand((m, P), generator=gen) < 0.3).float()
        scen[::5] = 0.0
        scen[1::7] = 1.0
        fs_ok = torch.rand((m, F), generator=gen) < 0.7
        fs_ok[2::6] = False
        c1 = torch.randint(0, 4, (F,), generator=gen) * 0.25
        return rec.to(dev), scen.to(dev), fs_ok.to(dev), c1.float().to(dev)

    def extra_checks(m):
        z, aq = stream.z[0, :m].contiguous(), stream.aq[0, :m].contiguous()
        cloud_down = (lat.tier_flat < 0.5).to(torch.float32)
        checks = {"ccg_encode": [(ccg_encode, enc_args(z, aq),
                                  dict(enc_kw, y_ok=cloud_down))],
                  "ccg_master": [(ccg_master, master_ties(m), {})]}
        # LPT: mixed routes, all-cloud ones (the a2_cloud_only policy's),
        # and mixed ones with an edge server down
        t_lpt, route = rand((m,), 0.001, 0.5), ints(m, 2)
        edge_down = torch.ones(5, device=dev)
        edge_down[1] = 0.0
        checks["lpt_queue"] = [
            (lpt_queue, (t_lpt, route, 4, 1), {}),
            (lpt_queue, (t_lpt, torch.ones_like(route), 4, 1), {}),
            (lpt_queue, (t_lpt, route, 4, 1), dict(avail=edge_down))]
        return checks

    def cases(m):
        z, aq = stream.z[0, :m].contiguous(), stream.aq[0, :m].contiguous()
        route = ints(m, 2)
        panel = torch.movedim(lat.bw, -1, 0)[route.long()].reshape(m, -1)
        return {
            "gate_cell": (gate_cell, (stream.dx[0, :m].contiguous(),
                                      rand((m, 32), -1, 1), rand((m,), 0, 2),
                                      gp), {}),
            "ccg_solve": (ccg_solve, (
                z, aq, lat.rn_flat, lat.pn_flat, lat.tier_flat, lat.b2_flat,
                prob.u_all, lat.c1_flat,
                torch.randint(-1, F, (m,), generator=gen,
                              dtype=torch.int32).to(dev)),
                dict(margin=sys_.acc_margin_robust, num_versions=K)),
            "c6_tail": (c6_tail, (panel, ints(m, 5), ints(m, 5), ints(m, 5),
                                  route, z, aq + sys_.acc_margin_robust, rn,
                                  pn), dict(n_fps=f_k)),
            # the main path's routes: every task on the edge (ROADMAP C)
            "lpt_queue": (lpt_queue, (rand((m,), 0.001, 0.5),
                                      torch.zeros_like(route), 4, 1), {}),
            "ccg_encode": (ccg_encode, enc_args(z, aq), enc_kw),
            "ccg_master": (ccg_master, master_first_step(z, aq), {}),
        }

    tol = {"gate_cell": 1e-5, "ccg_solve": 0.0, "c6_tail": 0.0,
           "lpt_queue": 0.0, "ccg_encode": 0.0, "ccg_master": 0.0}
    source = {"gate_cell": "temporal_gate.cu", "ccg_solve": "ccg_solve.cu",
              "c6_tail": "c6_tail.cu", "lpt_queue": "lpt_queue.cu",
              "ccg_encode": "ccg_encode.cu", "ccg_master": "ccg_master.cu"}
    replaces = {
        "gate_cell": "src/repro/kernels/temporal_gate/kernel.py:50",
        "ccg_solve": "src/repro/kernels/ccg_solve/kernel.py:168",
        "c6_tail": "src/repro/kernels/c6_tail/kernel.py:69",
        "lpt_queue": "src/repro/serving/simulator.py:70 (not a TPU kernel: "
                     "realization helper)",
        "ccg_encode": "src/repro/kernels/ccg_encode/kernel.py:74",
        "ccg_master": "src/repro/kernels/ccg_master/kernel.py:53",
    }
    symbol = {name: f"{name}_kernel" for name in source}
    plain_reps = {"lpt_queue": 3}
    rows = {}
    main_cases = cases(M)
    ragged_cases = cases(M_RAGGED)
    extra = {m: extra_checks(m) for m in (M, M_RAGGED)}
    for name, (fn, args, kw) in main_cases.items():
        err = 0.0
        checks = [main_cases[name], ragged_cases[name],
                  *extra[M].get(name, []), *extra[M_RAGGED].get(name, [])]
        for fn_, args_, kw_ in checks:
            got = fn_(*args_, force="kernel", **kw_)
            want = fn_(*args_, force="ref", **kw_)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(err, max_abs(torch, got, want))
        if not err <= tol[name]:
            raise AssertionError(f"{name}: kernel vs plain max |diff| {err} "
                                 f"> {tol[name]}")
        call = lambda: fn(*args, force="kernel", **kw)
        plain = lambda: fn(*args, force="ref", **kw)
        ms_events = event_ms(torch, call, reps=50)
        ms_dev = device_ms(torch, call, symbol[name])
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source[name]}",
            "replaces": replaces[name], "max_abs_err": err,
            "tolerance": tol[name], "cases_compared": len(checks),
            "ms": ms_dev if ms_dev is not None else ms_events,
            "ms_from": "profiler" if ms_dev is not None else "cuda_events",
            "call_ms": ms_events,
            "plain_ms": event_ms(torch, plain,
                                 reps=plain_reps.get(name, 20), warmup=1),
            "library_ms": None, "library_call": None,
        }

    # bounds from this run's inputs (M = 4096): bytes each input read once
    # and each output written once; operations of an implementation that
    # builds every task-independent table once, all counted at the float32
    # peak outside the tensor cores (compares and integer ops included)
    d, m_h = 35, 32
    w_floats = d * 3 * m_h + 2 * m_h * m_h + m_h * m_h + 4 * m_h + 2
    gate_bytes = 4 * (M * (d + m_h + 1) + M * (m_h + 2) + w_floats)
    gate_flops = M * (2 * (3 * d * m_h + 3 * m_h * m_h + m_h) + 30 * m_h)
    _, args, kw = main_cases["ccg_solve"]
    solved = ccg_solve(*args, force="kernel", **kw)
    steps = float(solved[4].sum())
    n_infeasible = float(solved[5].sum())
    # ccg_solve.  Tables, once: a_max·sat per (option, version), the pole-
    # scaled costs (P, K, F) and the recourse of every version subset
    # (P, F, 2^K), one min each.  Per task: the threshold and the two z
    # products (3); per option the two z terms (2F); per (option, version)
    # two subtractions, the clamp, the test and the bit (6FK); the worst pole
    # of the warm start and of the epilogue (2P) and v* (K).  Per step: the
    # master's c1 + eta and argmin, the eta max (3F, recourse by lookup), the
    # worst pole (P) and the bound update (5).  The flat accuracy argmax
    # (FK) only on tasks where nothing is feasible.
    ccg_bytes = 4 * (M * 9 + F * 5 + K * F + P * K)
    ccg_flops = (11 * F * K + P * K * F + P * F * 2 ** K
                 + M * (3 + 2 * F + 6 * F * K + 2 * P + K)
                 + steps * (3 * F + P + 5) + n_infeasible * F * K)
    # c6_tail.  Per task: the two clamped indices and the two z products
    # (4); per demotion the (1 − p) and (1 − r) terms, two subtractions, the
    # clamp and the test (7 each; a_max·sat is a (version, tier, resolution)
    # table built once); the guards and their ands (4); the gain and its
    # select (2).  Bytes: six lane inputs, three outputs, the current panel
    # entry, and the demoted entry only where a demotion is feasible.
    _, args, kw = main_cases["c6_tail"]
    n_demote = float((c6_tail(*args, force="kernel", **kw)[1] > -BIG / 2)
                     .sum())
    n_res = sys_.n_res
    c6_bytes = M * (6 * 4 + 3 * 4 + 4) + 4 * n_demote + 4 * (n_res + f_k)
    c6_flops = 11 * K * 2 * n_res + M * (4 + 2 * 7 + 4 + 2)
    # lpt_queue: t, route and the sorted order in, start out; per task the
    # argmin over its tier's servers and one add; and the serial chain.  On
    # the main path's routes, and beside them on mixed ones (both tiers'
    # walks side by side)
    _, (_, r_lpt, n_edge, n_cloud), _ = main_cases["lpt_queue"]
    on_edge = float((r_lpt == 0).sum())
    lpt_bytes = M * (4 + 4 + 8 + 4)
    lpt_flops = on_edge * n_edge + (M - on_edge) * n_cloud
    lpt_chain = lpt_chain_ms(r_lpt, n_edge, n_cloud)
    # ccg_encode: writes the (M, P, F) slab, the (M, F) bitmask and the (M,)
    # argmax; reads z, aq, four (F,) vectors and the (K, P, F) costs.  With
    # a_max·sat per (option, version) and the (P, F, 2^K) subset lookup
    # built once, per task the two z products and their sum per option (3F)
    # and per (option, version) the subtraction, clamp (2), test, bit and
    # argmax compare (6FK); the recourse is a lookup.
    enc_bytes = 4 * (M * P * F + M * F + M + 2 * M + 4 * F + K * P * F)
    enc_flops = (11 * F * K + P * F * 2 ** K + M * (3 * F + 6 * F * K))
    # ccg_master on the first warm step's inputs: it needs the recourse of
    # each task's generated poles at its feasible options only, the whole
    # (M, P) mask and (M, F) feasibility, c1, and writes y* and o_down; per
    # feasible option the η max over the poles, c1 + η and the argmin
    # compare, per option the select
    rec_m, scen_m, ok_m, _ = main_cases["ccg_master"][1]
    n_poles = scen_m.sum(1).double()
    n_feas = ok_m.sum(1).double()
    master_bytes = float(4 * (n_poles * n_feas).sum() + 4 * M * P + M * F
                         + 4 * F + 8 * M)
    master_flops = float((n_feas * (n_poles + 2)).sum() + M * F)
    work = {"gate_cell": (gate_bytes, gate_flops),
            "ccg_solve": (ccg_bytes, ccg_flops),
            "c6_tail": (c6_bytes, c6_flops),
            "lpt_queue": (lpt_bytes, lpt_flops),
            "ccg_encode": (enc_bytes, enc_flops),
            "ccg_master": (master_bytes, master_flops)}
    for name, (nbytes, flops) in work.items():
        rows[name]["bytes"], rows[name]["flops"] = nbytes, flops
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound(
            nbytes, flops, chain_ms=lpt_chain if name == "lpt_queue" else 0.0)
    rows["lpt_queue"]["bytes_ms"] = lpt_bytes / HBM_BYTES_PER_S * 1e3
    rows["lpt_queue"]["chain_ms"] = lpt_chain
    rows["lpt_queue"]["routes"] = "all edge (the main path's)"
    lpt_fn, mixed_args, mixed_kw = extra[M]["lpt_queue"][0]
    mixed = lambda: lpt_fn(*mixed_args, force="kernel", **mixed_kw)
    rows["lpt_queue"]["mixed_ms"] = device_ms(torch, mixed, symbol["lpt_queue"])
    rows["lpt_queue"]["mixed_chain_ms"] = lpt_chain_ms(mixed_args[1], n_edge,
                                                       n_cloud)
    rows["ccg_solve"]["ccg_steps_in_run"] = steps
    rows["ccg_solve"]["infeasible_tasks"] = n_infeasible
    rows["c6_tail"]["feasible_demotions"] = n_demote
    rows["ccg_master"]["inputs"] = (
        "first master step of the Stage-1 warm-started solve of round 0")
    rows["ccg_master"]["mean_poles_per_task"] = float(n_poles.mean())
    rows["ccg_master"]["dense_slab_bytes"] = 4 * M * P * F

    # the nearest library yardstick of gate_cell: its packed dx·W_x GEMM
    dx = main_cases["gate_cell"][1][0]
    w_x, _ = pack_weights(gp)
    rows["gate_cell"]["library_ms"] = event_ms(torch, lambda: dx @ w_x, 50)
    rows["gate_cell"]["library_call"] = (
        "torch.matmul(dx, W_x), the packed (35, 96) GEMM only: no single "
        "PyTorch call computes the gate cell")
    return rows


def attention_rows(torch, dev):
    """decode_attention and flash_attention against their plain versions
    at the dispatch path's shapes and at ragged ones, then timed at the
    cloud tier's shapes (the edge tier's beside them)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention, \
        split_rule
    from repro_torch.kernels.flash_attention.ops import flash_attention

    gen = torch.Generator(dev).manual_seed(11)
    tiers = {"edge": get_config("qwen1.5-0.5b"),
             "cloud": get_config("qwen3-8b"),
             "recurrentgemma": get_config("recurrentgemma-9b")}
    # cache entries of a tier's slab: prompts up to 80 + the decode
    # headroom, or min(window, 80) for RecurrentGemma's local attention
    slab_len = {t: min(c.attn_window, PROMPTS[-1]) if c.attn_window else SLAB
                for t, c in tiers.items()}

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def decode_case(cfg, dtype, b=SLOTS, s=SLAB):
        """A (B, S, KV, D) slab read through a permuted view, ragged
        lengths 1..S."""
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        k_slab, v_slab = (normal((b, s, kv, d), dtype) for _ in range(2))
        length = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        length[0], length[-1] = 1, s
        return (normal((b, h, d), dtype), k_slab.permute(0, 2, 1, 3),
                v_slab.permute(0, 2, 1, 3), length), {}

    def flash_case(cfg, dtype, b, sq, sk=None, **kw):
        """(B, S, heads, D) projections read through permuted views."""
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        sk = sq if sk is None else sk
        return (normal((b, sq, h, d), dtype).transpose(1, 2),
                normal((b, sk, kv, d), dtype).transpose(1, 2),
                normal((b, sk, kv, d), dtype).transpose(1, 2)), kw

    bf16, f32 = torch.bfloat16, torch.float32
    cases = {"decode_attention": [], "flash_attention": []}
    for tier, cfg in tiers.items():
        win = {"window": cfg.attn_window} if cfg.attn_window else {}
        for dt in (bf16, f32):
            cases["decode_attention"].append(
                (str(dt)[6:], decode_case(cfg, dt, s=slab_len[tier])))
        for b, s in zip((1, 2, 4, 8, 8), PROMPTS):
            cases["flash_attention"].append(
                ("bfloat16", flash_case(cfg, bf16, b, s, **win)))
        for dt in (bf16, f32):
            cases["flash_attention"] += [
                (str(dt)[6:], flash_case(cfg, dt, 8, 80)),
                (str(dt)[6:], flash_case(cfg, dt, 2, 37)),
                (str(dt)[6:], flash_case(cfg, dt, 2, 65)),
                (str(dt)[6:], flash_case(cfg, dt, 2, 100, window=16)),
                (str(dt)[6:], flash_case(cfg, dt, 1, 5, 70, causal=False))]
    fns = {"decode_attention": decode_attention,
           "flash_attention": flash_attention}
    rows = {}
    for name, fn in fns.items():
        errs = {"bfloat16": 0.0, "float32": 0.0}
        for dtype, (args, kw) in cases[name]:
            got = fn(*args, force="kernel", **kw).double()
            want = fn(*args, force="ref", **kw).double()
            torch.cuda.synchronize()
            tol = ATTN_TOL[dtype]
            diff = (got - want).abs()
            if not bool((diff <= tol + tol * want.abs()).all()):
                raise AssertionError(
                    f"{name} ({dtype}): kernel vs plain max |diff| "
                    f"{float(diff.max())} over {tol} + {tol}·|plain|")
            errs[dtype] = max(errs[dtype], float(diff.max()))
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}/kernel.py:"
                        + ("64" if name == "decode_attention" else "92"),
            "max_abs_err": errs["bfloat16"],
            "max_abs_err_float32": errs["float32"],
            "tolerance": "2e-2 + 2e-2·|plain| (bf16); 2e-5 + 2e-5·|plain| "
                         "(float32)",
            "cases_compared": len(cases[name])}

    def timed(name, fn, args, kw, library, nbytes, flops):
        """Kernel and library each by CUDA events around the call, taken
        in turns (``ms`` falls back to them), and by the profiler's device
        time: ``call_ms`` compares with ``library_ms``, ``ms`` with
        ``library_device_ms`` (every kernel of the library call)."""
        call = lambda: fn(*args, force="kernel", **kw)
        events = event_ms_turns(torch, {"call": call, "library": library},
                                reps=100)
        ms_dev = device_ms(torch, call, f"{name}_kernel")
        t_bound, by = bound(nbytes, flops, BF16_FLOP_PER_S)
        return {"ms": ms_dev if ms_dev is not None else events["call"],
                "ms_from": "profiler" if ms_dev is not None else "cuda_events",
                "call_ms": events["call"],
                "plain_ms": event_ms(torch, lambda: fn(*args, force="ref",
                                                       **kw), reps=20),
                "library_ms": events["library"],
                "library_device_ms": device_ms(torch, library),
                "bytes": nbytes, "flops": flops, "bound_ms": t_bound,
                "bound_by": by}

    shapes = {}
    for tier, cfg in tiers.items():
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        sl = slab_len[tier]
        # decode: the slab at ragged lengths; bytes: q, the K/V entries up
        # to each row's length, out, lengths; 4·H·D operations per entry
        (q, kc, vc, length), _ = decode_case(cfg, bf16, s=sl)
        n_kv = float(length.double().sum())
        mask = (torch.arange(sl, device=dev)[None, :]
                < length[:, None])[:, None, None, :]
        lib = lambda q=q, kc=kc, vc=vc, mask=mask: \
            F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                           attn_mask=mask, enable_gqa=True)
        dec = timed("decode_attention", decode_attention, (q, kc, vc, length),
                    {}, lib, 2 * (2 * SLOTS * h * d + 2 * n_kv * kv * d)
                    + 4 * SLOTS, 4 * n_kv * h * d)
        dec["shape"] = (f"B={SLOTS} S={sl} H={h} KV={kv} D={d} bf16, "
                        f"mean length {n_kv / SLOTS:.1f}")
        dec["splits"] = split_rule(
            SLOTS * kv, sl, torch.cuda.get_device_properties(
                dev).multi_processor_count)
        # flash: the longest prefill bucket; bytes: q, k, v, out once;
        # 4·D operations per (head, causal query-key pair; the window of
        # 2048 masks none of them at 80 tokens)
        win = {"window": cfg.attn_window} if cfg.attn_window else {}
        (fq, fk, fv), _ = flash_case(cfg, bf16, 8, 80)
        lib = lambda fq=fq, fk=fk, fv=fv: F.scaled_dot_product_attention(
            fq, fk, fv, is_causal=True, enable_gqa=True)
        pairs = 80 * 81 / 2
        fl = timed("flash_attention", flash_attention, (fq, fk, fv), win,
                   lib, 2 * 8 * 80 * d * (2 * h + 2 * kv),
                   4 * 8 * h * d * pairs)
        fl["shape"] = (f"B=8 Sq=Sk=80 H={h} KV={kv} D={d} causal"
                       + (f" window {cfg.attn_window}" if win else "")
                       + " bf16")
        shapes[tier] = {"decode_attention": dec, "flash_attention": fl}
    for name, row in rows.items():
        row.update(shapes["cloud"][name])
        row["library_call"] = (
            "torch.nn.functional.scaled_dot_product_attention(enable_gqa="
            "True" + (", attn_mask=lengths)" if name == "decode_attention"
                      else ", is_causal=True)"))
        row["edge"] = shapes["edge"][name]
        row["recurrentgemma"] = shapes["recurrentgemma"][name]
    return rows


def scan_rows(torch, dev):
    """mamba_scan and rglru_scan against their plain versions at the
    recurrent tier pools' shapes (a decode step of 16 slots and the longest
    prefill, 8 × 80) and at ragged ones (S = 1 and 37, channels not a
    multiple of the 128-channel block), x in bf16 and in float32, h0 given
    and None, and with h_out aliasing h0 (the decode step's in-place
    update); then timed at the decode step, the prefill beside it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan.ops import selective_scan
    from repro_torch.kernels.rglru.ops import rglru_scan

    gen = torch.Generator(dev).manual_seed(12)
    fm, rg = get_config("falcon-mamba-7b"), get_config("recurrentgemma-9b")
    r = fm.dt_rank

    def normal(shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    def mamba_case(b, s, di, n, dtype, with_h0):
        """x and the x_proj output in ``dtype`` (B and C its column
        slices), dt float32, as the model makes them."""
        proj = normal((b, s, r + 2 * n), dtype)
        return (normal((b, s, di), dtype),
                torch.nn.functional.softplus(normal((b, s, di), scale=0.5)),
                proj[..., r:r + n], proj[..., r + n:],
                -torch.exp(normal((di, n), scale=0.2)), normal((di,)),
                normal((b, di, n)) if with_h0 else None)

    def rglru_case(b, s, w, dtype, with_h0):
        return (normal((b, s, w), dtype), torch.sigmoid(normal((b, s, w))),
                torch.sigmoid(normal((b, s, w))),
                -8.0 * torch.nn.functional.softplus(normal((w,))),
                normal((b, w)) if with_h0 else None)

    di, n, w = fm.d_inner, fm.ssm.d_state, rg.lru_width
    kernels = {
        "mamba_scan": (selective_scan, mamba_case,
                       {"decode": (SLOTS, 1, di, n),
                        "prefill": (8, 80, di, n)},
                       [(3, 37, 200, n), (2, 1, 130, 4)], 64),
        "rglru_scan": (rglru_scan, rglru_case,
                       {"decode": (SLOTS, 1, w), "prefill": (8, 80, w)},
                       [(3, 37, 200), (2, 1, 130)], 26),
    }
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    for name, (fn, make, path, ragged, layers) in kernels.items():
        errs, n_cases, bit_equal = {"bfloat16": 0.0, "float32": 0.0}, 0, True
        for shape in (*path.values(), *ragged):
            for dt in (bf16, f32):
                for with_h0 in (False, True):
                    args = make(*shape, dt, with_h0)
                    runs = [fn(*args, force="kernel")]
                    if with_h0:   # h_out aliasing h0, as the decode step
                        state = args[-1].clone()
                        runs.append(fn(*args[:-1], state, h_out=state,
                                       force="kernel"))
                    want = fn(*args, force="ref")
                    torch.cuda.synchronize()
                    for got in runs:
                        for g, wt in zip(got, want):
                            diff = (g.double() - wt.double()).abs()
                            if not bool((diff <= SCAN_TOL + SCAN_TOL
                                         * wt.double().abs()).all()):
                                raise AssertionError(
                                    f"{name} {shape} ({dt}): kernel vs plain"
                                    f" max |diff| {float(diff.max())} over "
                                    f"{SCAN_TOL} + {SCAN_TOL}·|plain|")
                            key = str(dt)[6:]
                            errs[key] = max(errs[key], float(diff.max()))
                            bit_equal &= bool(torch.equal(g, wt))
                    n_cases += len(runs)
        timing = {}
        for what, shape in path.items():
            # the model's call: bf16 x; the decode step carries its state
            args = make(*shape, bf16, what == "decode")
            call = lambda args=args: fn(*args, force="kernel")
            ms_events = event_ms(torch, call, reps=50)
            ms_dev = device_ms(torch, call, f"{name}_kernel")
            nbytes, flops, sfu = scan_work(name, args)
            t_bound, by = bound(nbytes, flops, sfu_ops=sfu)
            timing[what] = {
                "ms": ms_dev if ms_dev is not None else ms_events,
                "ms_from": "profiler" if ms_dev is not None else "cuda_events",
                "call_ms": ms_events,
                "plain_ms": event_ms(torch, lambda args=args: fn(
                    *args, force="ref"), reps=10, warmup=1),
                "bytes": nbytes, "flops": flops, "sfu_ops": sfu,
                "bound_ms": t_bound, "bound_by": by,
                # the kernel takes every exp on the SFUs: its floor there
                "sfu_only_ms": sfu / SFU_OP_PER_S * 1e3,
                "shape": "x (B, S, C) = " + str(tuple(shape[:3])) + " bf16"
                         + (f", N={shape[3]}" if len(shape) > 3 else "")
                         + (", h0 given" if what == "decode" else ", h0 None")}
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": ("src/repro/kernels/mamba_scan/kernel.py:55"
                         if name == "mamba_scan"
                         else "src/repro/kernels/rglru/kernel.py:45"),
            "max_abs_err": errs["bfloat16"],
            "max_abs_err_float32": errs["float32"],
            "tolerance": f"{SCAN_TOL} + {SCAN_TOL}·|plain| (y and h, float32 "
                         "outputs)",
            "cases_compared": n_cases, "bit_equal_to_plain": bit_equal,
            **timing["decode"], "prefill": timing["prefill"],
            "library_ms": None,
            "library_call": "none: no PyTorch call computes the scan",
            "layers_per_call": layers}
    return rows


def scan_work(name, args):
    """Bytes each input read once and each output written once (y and
    h_final float32), float32 operations, and special-function operations
    (exp, sqrt) of one scan call."""
    if name == "mamba_scan":
        x, dt, bm, cm, a, d, h0 = args
        b, s, di = x.shape
        n = a.shape[1]
        nbytes = (x.numel() * x.element_size() + 4 * dt.numel()
                  + 2 * b * s * n * bm.element_size() + 4 * (a.numel() + di)
                  + 4 * b * di * n * (2 if h0 is not None else 1)
                  + 4 * b * s * di)
        # per state value: dt·A, dt·B, ·x, dA·h, +, h·C, + and one exp;
        # per channel: D·x, +
        return (float(nbytes), float(b * s * di * (7 * n + 2)),
                float(b * s * di * n))
    x, rg, ig, la, h0 = args
    b, s, w = x.shape
    nbytes = (x.numel() * x.element_size() + 8 * rg.numel() + 4 * w
              + 4 * b * w * (2 if h0 is not None else 1) + 4 * b * s * w)
    # la·r, a·a, 1 −, max, i·x, a·h, ·, + and one exp and one sqrt
    return float(nbytes), float(8 * b * s * w), float(2 * b * s * w)


def main_path_phase(torch, dev, stream, counts_reset, counts_read):
    """The serving round on the kernels, then on the plain versions."""
    from repro_torch.core.cost_model import SystemConfig, fps_norm, res_norm
    from repro_torch.core.gating import GateConfig
    from repro_torch.kernels.c6_tail.ops import c6_tail
    from repro_torch.serving.policy import make_policy
    from repro_torch.serving.session import ServeSession

    sys_ = SystemConfig()
    gcfg = GateConfig(d_feature=35)

    def session(force):
        pol = make_policy("r2evid", sys_, device=dev, gate_cfg=gcfg,
                          generator=torch.Generator().manual_seed(0),
                          force=force)
        return ServeSession(pol, n_streams=M, device=dev)

    sess = session("auto")
    counts_reset()
    mets = sess.run(stream)
    torch.cuda.synchronize()
    launches = counts_read()
    expect = {"gate_cell": ROUNDS, "ccg_solve": ROUNDS, "lpt_queue": ROUNDS}
    for name, n in expect.items():
        if launches.get(name) != n:
            raise AssertionError(f"main path launched {name} "
                                 f"{launches.get(name)} times, want {n}")
    if not 1 <= launches.get("c6_tail", 0) <= ROUNDS * 8:
        raise AssertionError(f"c6_tail launches {launches.get('c6_tail')}")

    # outputs: shapes, finiteness, ranges
    for k in ("delay", "energy", "cost", "accuracy", "tau"):
        if tuple(mets[k].shape) != (ROUNDS, M) or \
                not bool(torch.isfinite(mets[k]).all()):
            raise AssertionError(f"metric {k} has bad shape or non-finite")
    ranges = {"route": 2, "r": sys_.n_res, "p": sys_.n_fps,
              "v": sys_.num_versions}
    for k, hi in ranges.items():
        if not bool(((mets[k] >= 0) & (mets[k] < hi)).all()):
            raise AssertionError(f"decision {k} out of range")
    if not bool(((mets["accuracy"] >= 0) & (mets["accuracy"] <= 1)).all()):
        raise AssertionError("accuracy outside [0, 1]")

    # C6: the budget holds on every round unless no feasible demotion is left
    lat = sess.policy.lat
    held, stuck = 0, 0
    for t in range(ROUNDS):
        sol = {k: mets[k][t] for k in ("route", "r", "p", "v")}
        draw = float(lat.solution_bandwidth(sol).sum())
        if draw <= sys_.total_bw_mbps + 1e-3:
            held += 1
            continue
        panel = torch.movedim(lat.bw, -1, 0)[sol["route"]].reshape(M, -1)
        _, gain, _ = c6_tail(
            panel, *(sol[k].to(torch.int32) for k in ("r", "p", "v", "route")),
            stream.z[t], stream.aq[t] + sys_.acc_margin_robust,
            res_norm(sys_, dev), fps_norm(sys_, dev), n_fps=sys_.n_fps,
            force="ref")
        if bool((gain > 0).any()):
            raise AssertionError(f"round {t}: draw {draw} over the budget "
                                 f"with feasible demotions left")
        stuck += 1

    # the same run on the plain versions, on the card
    ref = session("ref")
    counts_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_mets = ref.run(stream)
    torch.cuda.synchronize()
    plain_run_s = time.perf_counter() - t0
    if counts_read():
        raise AssertionError("force='ref' run launched a kernel")
    same = torch.ones((ROUNDS, M), dtype=torch.bool, device=dev)
    for k in ranges:
        same &= mets[k] == ref_mets[k]
    agree = float(same.double().mean())
    if agree < 0.999:
        raise AssertionError(f"kernel vs plain decisions agree on {agree}")
    max_rel = {}
    rounds_equal = same.all(dim=1)
    for k in ("delay", "energy", "cost", "accuracy"):
        a, b = mets[k][rounds_equal], ref_mets[k][rounds_equal]
        max_rel[k] = float(((a - b).abs() / b.abs().clamp_min(1e-12)).max()) \
            if a.numel() else None
    tau_err = float((mets["tau"] - ref_mets["tau"]).abs().max())

    # throughput: median of three timed runs after one warm-up
    def timed():
        s = session("auto")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(stream)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed()
    secs = statistics.median(timed() for _ in range(3))
    trace = trace_round(torch, session("auto"), stream, secs)
    return launches, trace, {
        "phase": "main_path", "streams": M, "rounds": ROUNDS,
        "launches": launches, "c6_budget_held_rounds": held,
        "c6_no_feasible_demotion_rounds": stuck,
        "decision_agreement_vs_plain": agree,
        "rounds_bitequal_vs_plain": int(rounds_equal.sum()),
        "metric_max_rel_vs_plain": max_rel, "tau_max_abs_vs_plain": tau_err,
        "run_s": secs, "plain_run_s_one_sample": plain_run_s,
        "rounds_per_s": ROUNDS / secs,
        "segments_per_s": ROUNDS * M / secs,
        "mean_accuracy": float(mets["accuracy"].mean()),
        "mean_delay_s": float(mets["delay"].mean()),
        "cloud_frac": float(mets["route"].double().mean()),
    }


def solve_phase(torch, dev, stream, counts_reset, counts_read):
    """The unrolled CCG solver on its kernels, on the plain versions with
    the running-η master, and as the fused solve: equal decisions."""
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.robust import (
        RobustProblem,
        solve_ccg,
        solve_ccg_fused,
    )
    from repro_torch.core.router import stage1_configure

    sys_ = SystemConfig()
    prob = RobustProblem.build(sys_, dev)
    lat = prob.lat
    n_steps = min(8, prob.poles.shape[0] + 1)
    z, aq = stream.z[0].contiguous(), stream.aq[0].contiguous()
    none = torch.full((M,), -1, dtype=torch.int64, device=dev)
    route, r = stage1_configure(lat, z, z, aq, none, torch.zeros_like(z))
    warm_y = lat.flatten_index(route, r, sys_.n_fps - 1)
    decisions = ("route", "r", "p", "v", "iters", "infeasible")
    per_solve = {"ccg_encode": 1, "ccg_master": n_steps}
    totals = collections.Counter()
    rec = {"phase": "solve_ccg", "streams": M, "round": 0,
           "master_steps": n_steps}
    for start, wy in (("cold", None), ("warm", warm_y)):
        def kernels():
            return solve_ccg(prob, z, aq, warm_y=wy)

        def plain():
            return solve_ccg(prob, z, aq, warm_y=wy, force="ref",
                             slab_master=False)

        def fused():
            return solve_ccg_fused(prob, z, aq, warm_y=wy)

        counts_reset()
        sol = kernels()
        torch.cuda.synchronize()
        launches = counts_read()
        if launches != per_solve:
            raise AssertionError(f"solve_ccg ({start}) launched {launches}, "
                                 f"want {per_solve}")
        totals.update(launches)
        counts_reset()
        sol_plain = plain()
        torch.cuda.synchronize()
        if counts_read():
            raise AssertionError("the plain solve launched a kernel")
        counts_reset()
        sol_fused = fused()
        torch.cuda.synchronize()
        if counts_read() != {"ccg_solve": 1}:
            raise AssertionError("solve_ccg_fused did not launch ccg_solve")
        row = {"launches": launches}
        for other, o in (("plain_running_eta", sol_plain),
                         ("fused", sol_fused)):
            lanes = torch.ones((M,), dtype=torch.bool, device=dev)
            for k in decisions:
                lanes &= sol[k] == o[k].to(sol[k].dtype)
            n_eq = int(lanes.sum())
            if n_eq != M:
                raise AssertionError(f"solve_ccg ({start}) vs {other}: "
                                     f"{M - n_eq} lanes differ")
            row[f"lanes_equal_vs_{other}"] = n_eq
            for k in ("o_up", "o_down"):
                row[f"{k}_max_abs_vs_{other}"] = float(
                    (sol[k] - o[k]).abs().max())
        row.update({
            "iters_mean": float(sol["iters"].double().mean()),
            "iters_max": int(sol["iters"].max()),
            "infeasible_tasks": int(sol["infeasible"].sum()),
            "cloud_frac": float(sol["route"].double().mean()),
            "ms_kernels": event_ms(torch, kernels, reps=20),
            "ms_plain_running_eta": event_ms(torch, plain, reps=5, warmup=1),
            "ms_fused": event_ms(torch, fused, reps=20),
        })
        rec[start] = row
    warm = lambda: solve_ccg(prob, z, aq, warm_y=warm_y)
    rec["device_ms_per_launch_in_warm_solve"] = {
        name: device_ms(torch, warm, f"{name}_kernel", reps=10)
        for name in per_solve}
    return totals, rec


POLICY_VARIANTS = {
    "a2_cloud_only": ("a2_cloud_only", {}),
    "jcab": ("jcab", {}),
    "rdap": ("rdap", {}),
    "sniper": ("sniper", {}),
    "r2evid_tau_proxy": ("r2evid", {}),
    "r2evid_no_stage1": ("r2evid", {"use_stage1": False}),
    "r2evid_no_stage2": ("r2evid", {"use_stage2": False}),
}


def policies_phase(torch, dev, stream, counts_reset, counts_read):
    """Every registered policy through ``ServeSession.run``, scored with
    the simulator's noise model as the paper's tables are."""
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.serving.policy import make_policy
    from repro_torch.serving.session import ServeSession
    from repro_torch.serving.simulator import SimConfig, Simulator

    sys_ = SystemConfig()
    obs = dataclasses.replace(stream, dx=None)    # no policy here reads dx
    ranges = {"route": 2, "r": sys_.n_res, "p": sys_.n_fps,
              "v": sys_.num_versions}
    rows = {}
    for label, (name, kw) in POLICY_VARIANTS.items():
        def session(force):
            pol = make_policy(name, sys_, device=dev, force=force, **kw)
            return ServeSession(pol, n_streams=M, device=dev)

        counts_reset()
        mets = session("auto").run(obs)
        torch.cuda.synchronize()
        launches = counts_read()
        want = {"lpt_queue": ROUNDS}
        if label == "r2evid_tau_proxy":
            want["ccg_solve"] = ROUNDS
            n_c6 = launches.get("c6_tail", 0)
            if not 1 <= n_c6 <= ROUNDS * 8:
                raise AssertionError(f"{label}: c6_tail launches {n_c6}")
            want["c6_tail"] = n_c6
        if launches != want:
            raise AssertionError(f"{label} launched {launches}, want {want}")
        for k in ("delay", "energy", "cost", "accuracy"):
            if tuple(mets[k].shape) != (ROUNDS, M) or \
                    not bool(torch.isfinite(mets[k]).all()):
                raise AssertionError(f"{label}: metric {k} bad shape or "
                                     f"non-finite")
        for k, hi in ranges.items():
            if tuple(mets[k].shape) != (ROUNDS, M) or \
                    not bool(((mets[k] >= 0) & (mets[k] < hi)).all()):
                raise AssertionError(f"{label}: decision {k} out of range")
        scalars = Simulator(sys_, SimConfig(n_tasks=M, seed=0),
                            device=dev).aggregate(mets, stream.aq)
        row = {"policy": name, "kw": kw, "launches": launches, **scalars}
        if label == "r2evid_tau_proxy":
            counts_reset()
            ref = session("ref").run(obs)
            torch.cuda.synchronize()
            if counts_read():
                raise AssertionError("force='ref' run launched a kernel")
            same = torch.ones((ROUNDS, M), dtype=torch.bool, device=dev)
            for k in ranges:
                same &= mets[k] == ref[k]
            n_same = int(same.sum())
            if n_same != ROUNDS * M:
                raise AssertionError(f"{label}: kernel vs plain decisions "
                                     f"differ on {ROUNDS * M - n_same} "
                                     f"lane-rounds")
            row["lane_rounds_bitequal_vs_plain"] = n_same
            row["metric_max_rel_vs_plain"] = {
                k: float(((mets[k] - ref[k]).abs()
                          / ref[k].abs().clamp_min(1e-12)).max())
                for k in ("delay", "energy", "cost", "accuracy")}

        def timed():
            sess = session("auto")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.run(obs)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        secs = statistics.median(timed() for _ in range(3))
        row.update({"run_s": secs, "rounds_per_s": ROUNDS / secs,
                    "segments_per_s": ROUNDS * M / secs})
        rows[label] = row
    return {"phase": "policies", "streams": M, "rounds": ROUNDS,
            "variants": rows}


def _plain_margin(torch, pool, tokens, ids, t):
    """The plain pool's top-2 logit margin at decoded position ``t`` of one
    request (its prompt, then its first ``t`` ids, decoded alone)."""
    from repro_torch.models.model import decode_step, prefill

    logits, cache = prefill(pool.ctx, pool.params,
                            {"tokens": torch.as_tensor(tokens[None]).long()
                             .to(pool.device)})
    for i in range(t):
        tok = torch.tensor([[int(ids[i])]], device=pool.device)
        logits, cache = decode_step(pool.ctx, pool.params, cache,
                                    {"tokens": tok})
    top2 = logits[0].topk(2).values
    return float(top2[0] - top2[1])


def _compare_ids(torch, got, want, reqs, ref_pools):
    """Per tier: streams whose decoded ids agree; a stream that differs
    must differ first where the plain path's margin is under LOGIT_MARGIN."""
    out = {}
    for req in reqs:
        rec = out.setdefault(req.tier, {"streams": 0, "ids_equal": 0,
                                        "flips_under_margin": 0,
                                        "flip_margins": []})
        rec["streams"] += 1
        g, w = got[req.stream], want[req.stream]
        if (g == w).all():
            rec["ids_equal"] += 1
            continue
        t = int((g != w).argmax())
        margin = _plain_margin(torch, ref_pools[req.tier], req.tokens, w, t)
        if margin > LOGIT_MARGIN:
            raise AssertionError(
                f"stream {req.stream} (tier {req.tier}): kernel and plain "
                f"ids differ at token {t} where the plain margin is "
                f"{margin} > {LOGIT_MARGIN}")
        rec["flips_under_margin"] += 1
        rec["flip_margins"].append(margin)
    return out


def trace_pools(torch, pools: dict, reps: int = 5) -> dict:
    """Where a tier's time goes, on each path ({"kernels": pool, "plain":
    pool}, the same weights): a decode step over a full slab (every slot at
    80 entries) and a prefill of 8 × 80 tokens.  Wall time per call (host
    clock to a synchronize, mean of ``reps``) is taken in the order
    kernels, plain, plain, kernels, so that a drift of the host's speed
    shows as a spread; then one profiled window per path: device busy time,
    idle share, the attention kernels' device time, device activities per
    call, the costliest device activities and host operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = {}
    for path, pool in pools.items():
        slab = pool.make_slab(SLOTS, PROMPTS[-1])
        slab["length"].fill_(PROMPTS[-1])
        ids = torch.zeros(SLOTS, dtype=torch.long, device=pool.device)
        toks = torch.zeros((8, PROMPTS[-1]), dtype=torch.long,
                           device=pool.device)
        calls[path] = {
            "decode_step_16_slots":
                lambda pool=pool, slab=slab, ids=ids: pool.decode_slab(slab,
                                                                       ids),
            "prefill_8x80": lambda pool=pool, toks=toks: pool.prefill_batch(
                toks)}

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    out = {}
    for what in ("decode_step_16_slots", "prefill_8x80"):
        for path in pools:
            calls[path][what]()                          # warm-up
        walls = {path: [] for path in pools}
        for path in ("kernels", "plain", "plain", "kernels"):
            walls[path].append(wall_ms(calls[path][what]))
        for path in pools:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    calls[path][what]()
                torch.cuda.synchronize()
            events = prof.key_averages()
            dev_ev = [e for e in events if e.device_type == DeviceType.CUDA]
            host_ev = [e for e in events if e.device_type == DeviceType.CPU]
            busy = sum(e.self_device_time_total for e in dev_ev) / 1e3 / reps
            wall = statistics.mean(walls[path])
            out[f"{path}_{what}"] = {
                "wall_ms": walls[path], "device_busy_ms": busy,
                "device_idle_share": 1.0 - busy / wall,
                "ported_kernels_ms": sum(
                    e.self_device_time_total for e in dev_ev
                    if any(k in e.key for k in PORTED_MODEL_KERNELS))
                / 1e3 / reps,
                "device_activities": sum(e.count for e in dev_ev) / reps,
                "top_device_time": [
                    {"name": e.key[:80],
                     "ms": e.self_device_time_total / 1e3 / reps}
                    for e in sorted(dev_ev, key=lambda e:
                                    -e.self_device_time_total)[:5]],
                "top_host_time": [
                    {"name": e.key[:60], "per_call": e.count / reps,
                     "ms": e.self_cpu_time_total / 1e3 / reps}
                    for e in sorted(host_ev, key=lambda e:
                                    -e.self_cpu_time_total)[:5]]}
    return out


# the kernel each layer kind launches once per prefill and per decode step
LAYER_KERNELS = {"attn": ("flash_attention", "decode_attention"),
                 "ssm": ("mamba_scan", "mamba_scan"),
                 "rglru": ("rglru_scan", "rglru_scan")}


def expected_launches(cfgs: dict, calls: dict) -> dict:
    """Launches per kernel = layers of its kind × calls, summed over the
    tiers; ``calls``: {tier: (prefills, decode steps)}."""
    want = collections.Counter()
    for t, (prefills, steps) in calls.items():
        for kind, n in collections.Counter(cfgs[t].layer_kinds()).items():
            on_prefill, on_step = LAYER_KERNELS[kind]
            want[on_prefill] += n * prefills
            want[on_step] += n * steps
    return {k: v for k, v in want.items() if v}


def dispatch_phase(torch, dev, stream, counts_reset, counts_read, *,
                   phase="dispatch", archs=("qwen1.5-0.5b", "qwen3-8b"),
                   m=256, trace_reps=5):
    """The tier pools (``archs``: edge, cloud) on the kernels and on the
    plain versions: a routed round of the first ``m`` streams through
    ``ServeSession.dispatch`` and a fixed mixed request set, then the
    feedback loop and ``trace_pools`` with ``trace_reps`` calls a window."""
    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.gating import GateConfig
    from repro_torch.models.model import cache_specs, prefill
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.dispatch import DispatchExecutor, Request
    from repro_torch.serving.policy import make_policy
    from repro_torch.serving.pools import ModelPool, make_tier_pools
    from repro_torch.serving.session import ServeSession

    def slab_gb(cfg):
        specs = cache_specs(cfg, SLOTS, PROMPTS[-1])["segments"]
        return sum(math.prod(sp.shape) * torch.empty(
            (), dtype=getattr(torch, sp.dtype)).element_size()
            for sp in tree_leaves(specs)) / 1e9

    sys_ = SystemConfig()
    cfgs = {t: get_config(a) for t, a in enumerate(archs)}
    gc.collect()
    torch.cuda.empty_cache()
    memory_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pools = make_tier_pools(cfgs[0], cfgs[1], device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ref_pools = {t: ModelPool(p.cfg, name=p.name, device=dev, force="ref",
                              params=p.params) for t, p in pools.items()}
    layers = {t: dict(collections.Counter(c.layer_kinds()))
              for t, c in cfgs.items()}

    def first(obs_round):
        return dataclasses.replace(obs_round, **{
            k: getattr(obs_round, k)[:m].contiguous()
            for k in ("z", "aq", "dx")})

    pol = make_policy("r2evid", sys_, device=dev,
                      gate_cfg=GateConfig(d_feature=35),
                      generator=torch.Generator().manual_seed(0))
    sess = ServeSession(pol, n_streams=m, device=dev, pools=pools)
    ref_sess = ServeSession(pol, n_streams=m, device=dev, pools=ref_pools)
    routed = sess.step(first(stream.round(0)))

    vocab = {t: c.vocab_size for t, c in cfgs.items()}
    mixed = [Request(stream=i, tier=t, decode_tokens=8,
                     tokens=((i * 131 + np.arange(n)) % vocab[t]).astype(
                         np.int32))
             for i, (t, n) in enumerate((t, n) for t in (0, 1)
                                        for n in PROMPTS for _ in range(3))]

    def run(kernels: bool, which: str):
        """One request set on one path -> (ids, stats, launches, calls)."""
        ps = pools if kernels else ref_pools
        before = {t: (p.stats.prefills, p.stats.decode_steps)
                  for t, p in ps.items()}
        counts_reset()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        if which == "routed":
            s = sess if kernels else ref_sess
            stats = s.dispatch(routed)
            ex = s.executor
        else:
            ex = DispatchExecutor(ps, max_prefill_len=PROMPTS[-1])
            stats = ex.serve([dataclasses.replace(r) for r in mixed])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = counts_read()
        calls = {t: (p.stats.prefills - before[t][0],
                     p.stats.decode_steps - before[t][1])
                 for t, p in ps.items()}
        ids = {c.stream: c.ids for t in ex.execs
               for c in ex.execs[t].completions}
        return ids, stats, launches, calls, wall

    # warm-up, untimed and uncounted: every prefill and decode shape of the
    # mixed set on both tiers and both paths (cuBLAS and module loading)
    for ps in (pools, ref_pools):
        DispatchExecutor(ps, max_prefill_len=PROMPTS[-1]).serve(
            [dataclasses.replace(r) for r in mixed])
    torch.cuda.synchronize()

    rec = {"phase": phase, "edge": cfgs[0].name, "cloud": cfgs[1].name,
           "layers": layers, "depth_cut": None, "dtype": "bfloat16",
           "routed_streams": m,
           "weights_init_s": init_s,
           "weights_gb": {p.name: sum(t.numel() * t.element_size()
                                      for t in tree_leaves(p.params)) / 1e9
                          for p in pools.values()},
           "device_memory_gb_before": memory_before / 1e9,
           "slab": {p.name: {"slots": SLOTS, "max_prompt": PROMPTS[-1],
                             "gb": slab_gb(p.cfg)} for p in pools.values()}}
    totals = collections.Counter()
    for which in ("routed", "mixed"):
        reqs = ([Request(stream=i, tier=int(t), tokens=(
            (i * 131 + np.arange(16 * (1 + int(r)))) % vocab[int(t)]).astype(
                np.int32)) for i, (t, r) in enumerate(
            zip(routed["route"].tolist(), routed["r"].tolist()))]
            if which == "routed" else mixed)
        ids_k, stats_k, launches, calls, wall_k = run(True, which)
        want = expected_launches(cfgs, calls)
        if launches != want:
            raise AssertionError(f"{phase} ({which}) launched {launches}, "
                                 f"want {want} (layers × calls {calls})")
        totals.update(launches)
        ids_p, stats_p, plain_launches, _, wall_p = run(False, which)
        if plain_launches:
            raise AssertionError("force='ref' pools launched a kernel")
        if set(ids_k) != {r.stream for r in reqs} or set(ids_p) != set(ids_k):
            raise AssertionError(f"{phase} ({which}): streams missing")
        tier_of = {r.stream: r.tier for r in reqs}
        for ids in (ids_k, ids_p):
            if any(v.shape != (8,) or not (
                    (v >= 0) & (v < vocab[tier_of[s_]])).all()
                   for s_, v in ids.items()):
                raise AssertionError(f"{phase} ({which}): bad ids")
        rec[which] = {
            "requests": len(reqs), "launches": launches,
            "prefills_and_decode_steps": calls,
            "wall_s_kernels": wall_k, "wall_s_plain": wall_p,
            "kernels": stats_k, "plain": stats_p,
            "ids_vs_plain": _compare_ids(torch, ids_k, ids_p, reqs,
                                         ref_pools)}

    # first-token logits on both paths, one prefill per tier and length,
    # beside the largest |logit| (bf16 rounds it to 2^-8 of its magnitude)
    dlog, top = {}, {}
    for t in (0, 1):
        worst = top[t] = 0.0
        for n in PROMPTS:
            toks = torch.as_tensor(np.stack([r.tokens for r in mixed
                                             if r.tier == t
                                             and len(r.tokens) == n]),
                                   device=dev).long()
            lk, _ = prefill(pools[t].ctx, pools[t].params, {"tokens": toks})
            lp, _ = prefill(ref_pools[t].ctx, pools[t].params,
                            {"tokens": toks})
            if not bool(torch.isfinite(lk).all()):
                raise AssertionError("non-finite first-token logits")
            worst = max(worst, float((lk - lp).abs().max()))
            top[t] = max(top[t], float(lp.abs().max()))
        dlog[t] = worst
    rec["first_token_logits_max_abs_diff"] = dlog
    rec["first_token_logits_max_abs"] = top

    # the router <-> serving loop: the measured feedback into the next round
    fb = sess.feedback()
    adjusted = sess.apply_feedback(first(stream.round(1)))
    nxt = sess.step(adjusted)
    for k in ("delay", "energy", "cost", "accuracy"):
        if not bool(torch.isfinite(nxt[k]).all()):
            raise AssertionError(f"fed-back round: non-finite {k}")
    rec["feedback"] = {
        "bw_mult": [float(x) for x in fb["bw_mult"][:2]],
        "bw_scale": float(adjusted.bw_scale),
        "cloud_frac_round0": float(routed["route"].double().mean()),
        "cloud_frac_fed_back_round": float(nxt["route"].double().mean()),
        "mean_r_round0": float(routed["r"].double().mean()),
        "mean_r_fed_back_round": float(nxt["r"].double().mean())}
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["trace"] = {pools[t].name: trace_pools(
        torch, {"kernels": pools[t], "plain": ref_pools[t]}, trace_reps)
        for t in pools}
    return totals, rec


def trace_round(torch, sess, stream, untraced_s: float) -> dict:
    """Where the time goes: one profiled run of the main path.

    Device busy time is the sum of the trace's device activities (kernels,
    copies, fills); the idle share compares it with the untraced run's wall
    time, since the profiler slows the host.  Copies from the device to the
    host would be syncs of the round loop: their count is reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sess.run(stream)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    acts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in acts) / 1e3
    ours = ("gate_cell_kernel", "ccg_solve_kernel", "c6_tail_kernel",
            "lpt_queue_kernel")
    ours_ms = sum(e.self_device_time_total for e in acts
                  if any(k in e.key for k in ours)) / 1e3
    top = sorted(acts, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "phase": "trace", "rounds": ROUNDS,
        "device_busy_ms_per_round": busy_ms / ROUNDS,
        "untraced_ms_per_round": untraced_s * 1e3 / ROUNDS,
        "traced_ms_per_round": traced_s * 1e3 / ROUNDS,
        "device_idle_share": 1.0 - busy_ms / (untraced_s * 1e3),
        "device_activities_per_round": sum(e.count for e in acts) / ROUNDS,
        "dtoh_copies_per_round": sum(e.count for e in acts
                                     if "DtoH" in e.key) / ROUNDS,
        "htod_copies_per_round": sum(e.count for e in acts
                                     if "HtoD" in e.key) / ROUNDS,
        "ported_kernels_share_of_busy": ours_ms / busy_ms if busy_ms else None,
        "top_device_time": [
            {"name": e.key[:90], "ms_per_round":
             e.self_device_time_total / 1e3 / ROUNDS,
             "per_round": e.count / ROUNDS} for e in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the build log and phase records")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.serving.simulator import SimConfig, Simulator

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = []
    last = [time.perf_counter()]

    def record(obj):
        """Emit a phase's record with the seconds since the previous one."""
        now = time.perf_counter()
        obj["seconds"] = now - last[0]
        last[0] = now
        records.append(obj)
        emit(obj)

    smi = nvidia_smi()
    record({"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda})

    _build.library()
    record({"phase": "build",
            "library": str(_build.library_path().relative_to(ROOT))})
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        shutil.copy(_build.build_dir() / "build.log", args.out / "build.log")

    stream = Simulator(SystemConfig(), SimConfig(n_tasks=M, seed=0),
                       device=dev).sample_stream(n_rounds=ROUNDS,
                                                 feature_seed=1)
    rows = kernel_phase(torch, stream, dev)
    rows.update(attention_rows(torch, dev))
    rows.update(scan_rows(torch, dev))
    record({"phase": "kernels", "compared": [
        {k: rows[n][k] for k in ("name", "max_abs_err", "tolerance")}
        for n in rows]})

    launches, trace, main_rec = main_path_phase(
        torch, dev, stream, reset_launch_counts, launch_counts)
    record(main_rec)
    record(trace)
    solve_launches, solve_rec = solve_phase(
        torch, dev, stream, reset_launch_counts, launch_counts)
    record(solve_rec)
    record(policies_phase(torch, dev, stream, reset_launch_counts,
                          launch_counts))
    dispatch_launches, dispatch_rec = dispatch_phase(
        torch, dev, stream, reset_launch_counts, launch_counts)
    record(dispatch_rec)
    recurrent_launches, recurrent_rec = dispatch_phase(
        torch, dev, stream, reset_launch_counts, launch_counts,
        phase="dispatch_recurrent",
        archs=("falcon-mamba-7b", "recurrentgemma-9b"), m=64, trace_reps=2)
    record(recurrent_rec)
    # launches of each kernel on its paths, each counted from zero just
    # before its run and read just after: the main path's serving round for
    # the slice-1 kernels, the cold and the warm solve for ccg_encode and
    # ccg_master, the kernel-path request sets of the two dispatch phases
    # for the attention kernels and the scans
    phases = {"main_path": launches, "solve_ccg": solve_launches,
              "dispatch": dispatch_launches,
              "dispatch_recurrent": recurrent_launches}
    for name, row in rows.items():
        by_phase = {ph: c[name] for ph, c in phases.items() if c.get(name)}
        row["launches"] = sum(by_phase.values())
        row["launches_by_phase"] = by_phase
    kernels = {"kernels": list(rows.values())}
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(
            json.dumps({"records": records, **kernels}, indent=1))
    emit(kernels)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
