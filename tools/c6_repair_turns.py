#!/usr/bin/env python3
"""The C6 repair above the one-block kernel's 16,384 tasks on one NVIDIA
GPU: the cluster kernel against the per-round path it replaced, in turns.

    python3 tools/c6_repair_turns.py [--reps 10] [--rounds 16]

1. The repair alone at M = 16,385, 53,248 and the cluster's cap (262,144),
   on ``chip_smoke.py``'s demoting case and main path's round tiled to M
   (``c6_repair_tiled``; the latter has no feasible demotion, so the
   repair stops after round 0): ``c6_repair`` (one cluster
   launch) and ``repair_rounds`` on the ``c6_tail`` kernel (a launch a
   round and the selection in torch), taken cluster, per-round, per-round,
   cluster: per call the device busy ms and device activities (the
   profiler over ``--reps`` calls) and the CUDA-event ms of a call.
2. The gathered sharded round of gate-mode R2E-VID on one NCCL rank
   (``ServeSession(..., mesh=, hierarchical=False)``, captured, pools
   16 + 8, 2.5 Mbps a stream: ``chip_smoke.py``'s scale cell) at M = 53,248
   and 65,536 for ``--rounds`` rounds, once with the cluster repair and once
   with the per-round path (``c6_tail.ops.CLUSTER_CAP`` lowered to the
   one-block cap while that session captures its round): rounds/s of the
   two sessions in turns (median of three), launches a round, and one
   profiled run each (device busy ms, activities and idle share a round).

Prints one JSON line per measurement, then the card's name and power limit.
Exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def repair_turns(torch, smoke, reps: int) -> None:
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.kernels.c6_tail.ops import CLUSTER_CAP, c6_repair, c6_tail
    from repro_torch.kernels.c6_tail.ref import repair_rounds
    from repro_torch.serving.simulator import SimConfig, Simulator

    dev = torch.device("cuda")
    stream = Simulator(SystemConfig(), SimConfig(n_tasks=smoke.M, seed=0),
                       device=dev).sample_stream(n_rounds=1, feature_seed=1)
    cases = smoke.c6_repair_cases(torch, stream, dev)
    tail = lambda *a, n_fps: c6_tail(*a, n_fps=n_fps, force="kernel")
    for m in (16385, smoke.CLUSTER_M, CLUSTER_CAP):
        for what in ("demoting", "main_path"):
            big, b = smoke.c6_repair_tiled(cases, what, m)
            fns = {"cluster": lambda: c6_repair(*big, b, n_fps=5, rounds=8,
                                                force="kernel"),
                   "per_round": lambda: repair_rounds(tail, *big, b, 5, 8)}
            got, want = fns["cluster"](), fns["per_round"]()
            prof = {name: [] for name in fns}
            for name in ("cluster", "per_round", "per_round", "cluster"):
                for _ in range(3):   # a trace now and then comes back empty
                    rec = smoke.trace_calls(torch, fns[name], (), reps)
                    if rec["device_activities"] >= 1:
                        break
                prof[name].append(rec)
            events = smoke.event_ms_turns(torch, fns, reps)
            emit({"measure": "repair", "tasks": m, "case": what,
                  "decisions_equal": bool(torch.equal(got[0], want[0])
                                          and torch.equal(got[1], want[1])),
                  **{name: {"device_busy_ms": [p["device_busy_ms"]
                                               for p in runs],
                            "device_activities": runs[0][
                                "device_activities"],
                            "call_ms": events[name]}
                     for name, runs in prof.items()}})


def gathered_turns(torch, smoke, rounds: int) -> None:
    from repro_torch.core.cost_model import SystemConfig
    import repro_torch.kernels.c6_tail.ops as c6_ops
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import host_mesh, single_rank_group
    from repro_torch.serving.session import ServeSession

    dev = torch.device("cuda")
    total_bw = SystemConfig().total_bw_mbps
    with single_rank_group("nccl"):
        mesh = host_mesh()
        for m in (smoke.SHARD_GATHER_M, smoke.SHARD_SCALE_M):
            cell = smoke.sharded_cell(torch, dev, m, rounds,
                                      smoke.SHARD_SCALE_BW * m / total_bw)
            pol = smoke.shard_policy(torch, "r2evid", dev)
            sessions, launches, outs = {}, {}, {}
            cap = c6_ops.CLUSTER_CAP
            for name in ("cluster", "per_round"):
                if name == "per_round":      # the repair's path before it
                    c6_ops.CLUSTER_CAP = c6_ops.REPAIR_CAP
                try:
                    sess = sessions[name] = ServeSession(
                        pol, m, device=dev, mesh=mesh, hierarchical=False,
                        **smoke.SHARD_POOLS)
                    reset_launch_counts()
                    outs[name] = sess.run(cell)
                    torch.cuda.synchronize()
                    launches[name] = {k: v / rounds for k, v in
                                      launch_counts().items()}
                finally:
                    c6_ops.CLUSTER_CAP = cap
            secs = smoke.run_turns(torch, sessions, cell)
            rec = {"measure": "gathered_round", "streams": m,
                   "rounds": rounds,
                   "decisions_equal": all(
                       torch.equal(outs["cluster"][k], outs["per_round"][k])
                       for k in ("route", "r", "p", "v"))}
            for name, sess in sessions.items():
                trace = smoke.trace_round(torch, sess, cell, secs[name],
                                          rounds=rounds, host=False)
                rec[name] = {
                    "rounds_per_s": rounds / secs[name],
                    "launches_per_round": launches[name],
                    **{k: trace[k] for k in (
                        "device_busy_ms_per_round",
                        "device_activities_per_round", "device_idle_share",
                        "kernel_launches_per_round")}}
            emit(rec)
            del sessions, sess


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=16)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("c6_repair_turns: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    repair_turns(torch, chip_smoke, args.reps)
    gathered_turns(torch, chip_smoke, args.rounds)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
