#!/usr/bin/env python3
"""Where the main path's serving round spends its time, for one checkout of
the repository, on one NVIDIA GPU.

    python3 tools/round_trace.py [--tree DIR] [--runs 3] [--uncaptured]

Loads ``src/`` and ``chip_smoke.py`` of ``DIR`` (default: this checkout),
builds that tree's kernels into ``DIR/build/``, and serves the main path
of ``chip_smoke.py`` (gate-mode R2E-VID, M = 4096 streams, R = 16 rounds of
the seeded stream; ``--uncaptured``: a session with ``capture=False``, its
rounds run from Python a round): one warm-up run, ``--runs`` untraced runs
timed by the host's clock to a synchronize (median), then that tree's own
``chip_smoke.trace_round``: device busy ms and device activities a round,
the idle share, the costliest device activities.  Then the unrolled
solver ``solve_ccg`` on round 0, warm-started from Stage 1 (the solve of
``chip_smoke.py``'s ``solve_ccg`` phase): wall ms a solve (host clock to a
synchronize, median of ``--runs`` × 10 solves) and one profiled window of
10 solves: device busy ms, device activities and the ``ccg_encode`` and
``ccg_master`` device time a solve.  Run it on two trees in one call, in
turns (parent, change, change, parent), to compare them on one card.
Prints one JSON line, then the card's name and power limit.  Exits 1
without CUDA.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path


def trace_solve(torch, sys_, stream, runs: int, reps: int = 10) -> dict:
    """Wall and device time of the warm unrolled solve of round 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.robust import RobustProblem, solve_ccg
    from repro_torch.core.router import stage1_configure

    dev = stream.z.device
    prob = RobustProblem.build(sys_, dev)
    lat = prob.lat
    z, aq = stream.z[0].contiguous(), stream.aq[0].contiguous()
    none = torch.full(z.shape, -1, dtype=torch.int64, device=dev)
    route, r = stage1_configure(lat, z, z, aq, none, torch.zeros_like(z))
    warm_y = lat.flatten_index(route, r, sys_.n_fps - 1)

    def solves():
        for _ in range(reps):
            solve_ccg(prob, z, aq, warm_y=warm_y)
        torch.cuda.synchronize()

    solves()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        solves()
        walls.append((time.perf_counter() - t0) * 1e3 / reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solves()
    acts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]

    def ms(events):
        return sum(e.self_device_time_total for e in events) / 1e3 / reps

    return {"wall_ms": statistics.median(walls), "wall_ms_runs": walls,
            "device_busy_ms": ms(acts),
            "device_activities": sum(e.count for e in acts) / reps,
            **{f"{k}_ms": ms([e for e in acts if f"{k}_kernel" in e.key])
               for k in ("ccg_encode", "ccg_master")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--uncaptured", action="store_true",
                    help="serve with ServeSession(capture=False)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("round_trace: CUDA is not available", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.gating import GateConfig
    from repro_torch.kernels import _build
    from repro_torch.serving.policy import make_policy
    from repro_torch.serving.session import ServeSession
    from repro_torch.serving.simulator import SimConfig, Simulator

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    m, rounds = smoke.M, smoke.ROUNDS
    sys_ = SystemConfig()
    stream = Simulator(sys_, SimConfig(n_tasks=m, seed=0),
                       device=dev).sample_stream(n_rounds=rounds,
                                                 feature_seed=1)

    def session():
        pol = make_policy("r2evid", sys_, device=dev,
                          gate_cfg=GateConfig(d_feature=35),
                          generator=torch.Generator().manual_seed(0))
        kw = {"capture": False} if args.uncaptured else {}
        return ServeSession(pol, n_streams=m, device=dev, **kw)

    def timed():
        sess = session()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run(stream)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed()
    runs = [timed() for _ in range(args.runs)]
    rec = smoke.trace_round(torch, session(), stream, statistics.median(runs))
    rec.update({"tree": str(tree), "uncaptured": args.uncaptured,
                "run_s": runs,
                "rounds_per_s": rounds / statistics.median(runs),
                "solve_ccg_warm": trace_solve(torch, sys_, stream, args.runs)})
    print(json.dumps(rec), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
