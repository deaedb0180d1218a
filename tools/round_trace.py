#!/usr/bin/env python3
"""Where the main path's serving round spends its time, for one checkout of
the repository, on one NVIDIA GPU.

    python3 tools/round_trace.py [--tree DIR] [--runs 3]

Loads ``src/`` and ``chip_smoke.py`` of ``DIR`` (default: this checkout),
builds that tree's kernels into ``DIR/build/``, and serves the main path
of ``chip_smoke.py`` (gate-mode R2E-VID, M = 4096 streams, R = 16 rounds of
the seeded stream): one warm-up run, ``--runs`` untraced runs timed by the
host's clock to a synchronize (median), then that tree's own
``chip_smoke.trace_round``: device busy ms and device activities a round,
the idle share, the costliest device activities.  Run it on two trees in
one call, in turns (parent, change, change, parent), to compare them on
one card.  Prints one JSON line, then the card's name and power limit.
Exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--runs", type=int, default=3)
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
        return ServeSession(pol, n_streams=m, device=dev)

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
    rec.update({"tree": str(tree), "run_s": runs,
                "rounds_per_s": rounds / statistics.median(runs)})
    print(json.dumps(rec), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
