#!/usr/bin/env python3
"""Which rounds of a profiled serving run the profiler's trace loses, and
whether a margin of idle host time around the run keeps them, on one
NVIDIA GPU.

    python3 tools/trace_window.py [--traces 40] [--pad-ms 20]

Serves ``chip_smoke.py``'s main path (gate-mode R2E-VID, M = 4096 streams,
R = 16 rounds of the seeded stream) on a captured and on an uncaptured
session, and R2E-VID without Stage 2 (no ``dx``) on a captured one.  Each
session is profiled ``--traces`` times with no margin and as many times
with ``--pad-ms`` of host sleep inside the profiler before the run and
after its last synchronize, the two in turns.  Each trace reads the
``lpt_queue`` kernels (one a round in every one of these runs), and per
trace: how many rounds it holds, and where its first and last device
activity lie against the run's start and the end of its synchronize, in
microseconds from the opening of the profiler's window (the trace's own
clock for the device, the host's for the run).  A trace that lost its first rounds starts its device activity
later after the run's start than a whole trace; one that lost its last
rounds ends it earlier before the run's end.  Prints one JSON line, then
the card's name and power limit.  Exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_trace(torch, sess, stream, pad_s: float) -> dict:
    """One profiled run (device activities only, as ``chip_smoke.py``
    traces its checked runs): rounds found, and the device span against
    the run's start and end on the host's clock, both from the moment the
    profiler's window opened."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sess.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_open = time.perf_counter()
        time.sleep(pad_s)
        t_run = time.perf_counter()
        sess.run(stream)
        torch.cuda.synchronize()
        t_done = time.perf_counter()
        time.sleep(pad_s)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    lpt = sorted(e.time_range.start for e in dev
                 if "lpt_queue_kernel" in e.name)
    run_start_us = (t_run - t_open) * 1e6
    run_end_us = (t_done - t_open) * 1e6
    return {
        "rounds": len(lpt),
        "device_activities": len(dev),
        "first_device_after_run_start_us":
            min(e.time_range.start for e in dev) - run_start_us
            if dev else None,
        "last_device_before_run_end_us":
            run_end_us - max(e.time_range.end for e in dev)
            if dev else None,
        "first_lpt_after_run_start_us":
            lpt[0] - run_start_us if lpt else None,
    }


def summary(traces: list, rounds: int) -> dict:
    """The traces that lost rounds, each in full, and the medians of the
    whole ones."""
    whole = [t for t in traces if t["rounds"] == rounds]
    keys = ("first_device_after_run_start_us",
            "last_device_before_run_end_us", "first_lpt_after_run_start_us")
    return {
        "traces": len(traces), "short": len(traces) - len(whole),
        "short_traces": [t for t in traces if t["rounds"] != rounds],
        "whole_median": {k: statistics.median(t[k] for t in whole)
                         for k in keys} if whole else None,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=40)
    ap.add_argument("--pad-ms", type=float, default=20.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("trace_window: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import dataclasses

    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.gating import GateConfig
    from repro_torch.kernels import _build
    from repro_torch.serving.policy import make_policy
    from repro_torch.serving.session import ServeSession
    from repro_torch.serving.simulator import SimConfig, Simulator

    dev = torch.device("cuda")
    _build.library()
    m, rounds = smoke.M, smoke.ROUNDS
    sys_ = SystemConfig()
    stream = Simulator(sys_, SimConfig(n_tasks=m, seed=0),
                       device=dev).sample_stream(n_rounds=rounds,
                                                 feature_seed=1)
    gate = make_policy("r2evid", sys_, device=dev,
                       gate_cfg=GateConfig(d_feature=35),
                       generator=torch.Generator().manual_seed(0))
    no_stage2 = make_policy("r2evid", sys_, device=dev, use_stage2=False)
    cases = {
        "main_path/captured": (ServeSession(gate, m, device=dev), stream),
        "main_path/uncaptured": (ServeSession(gate, m, device=dev,
                                              capture=False), stream),
        "no_stage2/captured": (ServeSession(no_stage2, m, device=dev),
                               dataclasses.replace(stream, dx=None)),
    }
    pads = {"none": 0.0, "pad": args.pad_ms / 1e3}
    out = {}
    for name, (sess, obs) in cases.items():
        sess.run(obs)                      # capture / warm-up
        traces = {p: [] for p in pads}
        for i in range(args.traces):
            for p in list(pads) if i % 2 == 0 else list(pads)[::-1]:
                traces[p].append(one_trace(torch, sess, obs, pads[p]))
        out[name] = {p: summary(t, rounds) for p, t in traces.items()}
    print(json.dumps({"tool": "trace_window", "rounds": rounds,
                      "streams": m, "pad_ms": args.pad_ms,
                      "torch": torch.__version__, "cases": out}), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
