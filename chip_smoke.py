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
                 gate_cell within 1e-5, ccg_solve, c6_tail, lpt_queue,
                 ccg_encode (also with a real availability mask) and
                 ccg_master (also on slabs with ties, empty scenario rows
                 and all-infeasible rows) exact; kernel, plain and library
                 times (CUDA events, median after warm-up) and each
                 kernel's bound.
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

The last three lines are the kernels' JSON line, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.  ``--out DIR`` also
writes the nvcc/ptxas build log and every phase's record there.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
M, M_RAGGED, ROUNDS = 4096, 4093, 16
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOP_PER_S = 67e12          # H100 SXM float32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of one call (stream time, wrapper included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, symbol: str, reps: int = 20):
    """Mean device time of the kernel named ``symbol`` per call, from the
    profiler's CUPTI trace; None when the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if symbol in evt.key:
            total += getattr(evt, "self_device_time_total", 0.0)
            count += evt.count
    return total / 1e3 / count if count and total > 0 else None


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        return {"ccg_encode": [(ccg_encode, enc_args(z, aq),
                                dict(enc_kw, y_ok=cloud_down))],
                "ccg_master": [(ccg_master, master_ties(m), {})]}

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
            "lpt_queue": (lpt_queue, (rand((m,), 0.001, 0.5), route, 4, 1),
                          {}),
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
    # argmin over its tier's servers and one add
    _, (_, r_lpt, n_edge, n_cloud), _ = main_cases["lpt_queue"]
    on_edge = float((r_lpt == 0).sum())
    lpt_bytes = M * (4 + 4 + 8 + 4)
    lpt_flops = on_edge * n_edge + (M - on_edge) * n_cloud
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
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound(nbytes, flops)
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

    def record(obj):
        records.append(obj)
        emit(obj)

    smi = nvidia_smi()
    record({"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.library()
    record({"phase": "build", "seconds": time.perf_counter() - t0,
            "library": str(_build.library_path().relative_to(ROOT))})
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        shutil.copy(_build.build_dir() / "build.log", args.out / "build.log")

    stream = Simulator(SystemConfig(), SimConfig(n_tasks=M, seed=0),
                       device=dev).sample_stream(n_rounds=ROUNDS,
                                                 feature_seed=1)
    rows = kernel_phase(torch, stream, dev)
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
    # launches of each kernel on its path: the main path's serving round
    # for the slice-1 kernels, the cold and the warm solve for ccg_encode
    # and ccg_master
    for name, row in rows.items():
        row["launches"] = launches.get(name, 0) + solve_launches.get(name, 0)
        row["launches_from"] = ("solve_ccg" if name in solve_launches
                                else "main_path")
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
