#!/usr/bin/env python3
"""Smoke run of the PyTorch port of the R2E-VID router on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, one JSON line each; any failure exits non-zero:

1. ``device``    the card (``torch.cuda``) and its name and power limit
                 (``nvidia-smi``); no CUDA means exit 1 with no result.
2. ``build``     nvcc builds ``src/repro_torch/kernels/csrc/*.cu`` into
                 ``build/repro_torch_kernels/`` (or loads the built library).
3. ``kernels``   every kernel of the main path against its plain PyTorch
                 version on the card, at the main path's shapes (M = 4096)
                 and at a ragged M = 4093: gate_cell within 1e-5, ccg_solve,
                 c6_tail and lpt_queue exact; kernel, plain and library times
                 (CUDA events, median after warm-up) and each kernel's bound.
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

The last three lines are the kernels' JSON line, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.  ``--out DIR`` also
writes the nvcc/ptxas build log and every phase's record there.
"""
from __future__ import annotations

import argparse
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
    from repro_torch.kernels.c6_tail.ops import c6_tail
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
        }

    tol = {"gate_cell": 1e-5, "ccg_solve": 0.0, "c6_tail": 0.0,
           "lpt_queue": 0.0}
    source = {"gate_cell": "temporal_gate.cu", "ccg_solve": "ccg_solve.cu",
              "c6_tail": "c6_tail.cu", "lpt_queue": "lpt_queue.cu"}
    replaces = {
        "gate_cell": "src/repro/kernels/temporal_gate/kernel.py:50",
        "ccg_solve": "src/repro/kernels/ccg_solve/kernel.py:168",
        "c6_tail": "src/repro/kernels/c6_tail/kernel.py:69",
        "lpt_queue": "src/repro/serving/simulator.py:70 (not a TPU kernel: "
                     "realization helper)",
    }
    symbol = {"gate_cell": "gate_cell_kernel",
              "ccg_solve": "ccg_solve_kernel", "c6_tail": "c6_tail_kernel",
              "lpt_queue": "lpt_queue_kernel"}
    plain_reps = {"lpt_queue": 3}
    rows = {}
    main_cases = cases(M)
    ragged_cases = cases(M_RAGGED)
    for name, (fn, args, kw) in main_cases.items():
        err = 0.0
        for fn_, args_, kw_ in (main_cases[name], ragged_cases[name]):
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
            "tolerance": tol[name],
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
    work = {"gate_cell": (gate_bytes, gate_flops),
            "ccg_solve": (ccg_bytes, ccg_flops),
            "c6_tail": (c6_bytes, c6_flops),
            "lpt_queue": (lpt_bytes, lpt_flops)}
    for name, (nbytes, flops) in work.items():
        rows[name]["bytes"], rows[name]["flops"] = nbytes, flops
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound(nbytes, flops)
    rows["ccg_solve"]["ccg_steps_in_run"] = steps
    rows["ccg_solve"]["infeasible_tasks"] = n_infeasible
    rows["c6_tail"]["feasible_demotions"] = n_demote

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
    for name, row in rows.items():
        row["launches"] = launches.get(name, 0)
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
