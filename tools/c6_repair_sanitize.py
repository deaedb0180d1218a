#!/usr/bin/env python3
"""The C6 cluster repair under CUDA's compute-sanitizer, and its repeats in
a fresh process, on one NVIDIA GPU.

    python3 tools/c6_repair_sanitize.py [--out DIR] [--launches 100]
        [--tools racecheck,synccheck,initcheck,memcheck]

1. ``--repeat`` (a child process, no sanitizer): the first cluster launch
   after the kernel's attributes are set in a fresh CUDA context, then
   ``--launches`` more on the same inputs, each held bit-equal (r, p and
   the draw history) to the first; the plain repair run 5 times on the
   card and ``torch.cumsum`` 100 times on each round's sorted gains (the
   plain repair's prefix sums), each held bit-equal to its first run.
2. For each tool, ``compute-sanitizer --tool TOOL`` over a child that
   calls ``c6_repair(..., force="kernel")`` once on each case
   (``--child``; only the ``c6_repair`` kernels instrumented; racecheck
   with ``--racecheck-report all``): the tool's exit code, its summary
   lines and its verdict; each tool's whole output in ``DIR/TOOL.log``.

The cases are ``chip_smoke.py``'s demoting case and main path's round
(``c6_repair_cases``) tiled to 20,000 tasks (a cluster whose last block is
partial), 53,248 and 262,144 (``c6_repair_tiled``).  Prints one JSON line
a measurement, then the card's name and power limit.  Exits 1 without
CUDA or without ``compute-sanitizer`` (after the repeats).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TASKS = (20000, 53248, 262144)
TILES = ("demoting", "main_path")
TOOLS = ("racecheck", "synccheck", "initcheck", "memcheck")
TOOL_TIMEOUT_S = {"racecheck": 240, "synccheck": 150, "initcheck": 150,
                  "memcheck": 150}
PLAIN_RUNS = 5
CUMSUM_RUNS = 100


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _setup():
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.router import RouterConfig
    from repro_torch.serving.simulator import SimConfig, Simulator

    dev = torch.device("cuda")
    stream = Simulator(SystemConfig(), SimConfig(n_tasks=chip_smoke.M,
                                                 seed=0),
                       device=dev).sample_stream(n_rounds=1, feature_seed=1)
    cases = chip_smoke.c6_repair_cases(torch, stream, dev)
    tiled = {(m, what): chip_smoke.c6_repair_tiled(cases, what, m)
             for m in TASKS for what in TILES}
    return torch, chip_smoke, tiled, SystemConfig().n_fps, \
        RouterConfig().repair_rounds


def cluster_shape(m: int) -> dict:
    """The cluster that ``c6_tail.cu`` ``cluster_shape`` launches for m
    tasks: its blocks, the tasks a block holds and the last block's."""
    from repro_torch.kernels.c6_tail.ops import CLUSTER_BLOCKS, REPAIR_CAP

    blocks = max(-(-m // REPAIR_CAP), CLUSTER_BLOCKS)
    tasks = -(-(-(-m // blocks)) // 32) * 32
    return {"blocks": blocks, "tasks_a_block": tasks,
            "last_block_tasks": m - (blocks - 1) * tasks}


def _same(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def child(launches: int, repeat: bool) -> int:
    """One process on the card: every case once on the kernel; with
    ``repeat``, each case's first launch held against ``launches`` more,
    the plain repair's runs on the card and its prefix sums."""
    import torch

    if not torch.cuda.is_available():
        print("c6_repair_sanitize: CUDA is not available", file=sys.stderr)
        return 1
    _, _, tiled, nz, rounds = _setup()
    from repro_torch.kernels.c6_tail.ops import c6_repair
    from repro_torch.kernels.c6_tail.ref import c6_tail_ref

    def kernel(args, budget):
        return c6_repair(*args, budget, n_fps=nz, rounds=rounds,
                         force="kernel")

    def plain(args, budget, k=rounds):
        return c6_repair(*args, budget, n_fps=nz, rounds=k, force="ref")

    for (m, what), (args, budget) in tiled.items():
        t0 = time.perf_counter()
        first = [t.clone() for t in kernel(args, budget)]
        torch.cuda.synchronize()
        rec = {"measure": "case", "tasks": m, "case": what,
               "cluster": cluster_shape(m),
               "first_launch_s": time.perf_counter() - t0}
        if repeat:
            differ = [i + 1 for i in range(launches)
                      if not _same(torch, kernel(args, budget), first)]
            runs = [plain(args, budget) for _ in range(PLAIN_RUNS)]
            # the plain repair's prefix sums, round by round on its own
            # states: each round's sorted gains scanned again and again
            sums_differ = []
            for k in range(rounds):
                r, p, _ = plain(args, budget, k)
                _, gain, _ = c6_tail_ref(args[0], r, p, *args[3:], nz)
                g = gain[torch.argsort(-gain, stable=True)]
                once = torch.cumsum(g, 0)
                sums_differ.append(sum(not torch.equal(torch.cumsum(g, 0),
                                                       once)
                                       for _ in range(CUMSUM_RUNS)))
            rec.update({
                "launches_compared": launches,
                "launches_differing": len(differ),
                "first_differing_launch": differ[0] if differ else None,
                "plain_on_card_runs": PLAIN_RUNS,
                "plain_on_card_runs_bitequal": all(
                    _same(torch, run, runs[0]) for run in runs[1:]),
                "plain_vs_kernel_equal": _same(torch, runs[0][:2],
                                               first[:2]),
                "cumsum_runs_per_round": CUMSUM_RUNS,
                "cumsum_runs_differing_per_round": sums_differ})
        emit(rec)
    return 0


def summary(text: str) -> list:
    return [ln.strip() for ln in text.splitlines()
            if re.search(r"(ERROR|RACECHECK|SYNCCHECK|INITCHECK|LEAK) "
                         r"SUMMARY|not supported|unsupported|Error:",
                         ln)][:20]


def sanitize(tool: str, out: Path) -> dict:
    exe = shutil.which("compute-sanitizer") or \
        "/usr/local/cuda/bin/compute-sanitizer"
    cmd = [exe, "--tool", tool, "--kernel-name", "kns=c6_repair",
           "--error-exitcode", "9", "--print-limit", "50"]
    if tool == "racecheck":
        cmd += ["--racecheck-report", "all"]
    cmd += [sys.executable, str(Path(__file__).resolve()), "--child"]
    t0 = time.perf_counter()
    # its own process group: a tool past its time is stopped with the
    # Python child it runs
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, cwd=ROOT,
                            start_new_session=True)
    try:
        raw, _ = proc.communicate(timeout=TOOL_TIMEOUT_S[tool])
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        raw, _ = proc.communicate()
        rc = None
    text = raw.decode(errors="replace")
    (out / f"{tool}.log").write_text(text)
    cases = [json.loads(ln) for ln in text.splitlines()
             if ln.startswith('{"measure": "case"')]
    verdict = ("timed out" if rc is None else
               "device not supported" if "Device not supported" in text else
               "clean" if rc == 0 and len(cases) == len(TASKS) * len(TILES)
               else "errors reported" if rc == 9 else f"exit {rc}")
    return {"measure": "sanitizer", "tool": tool, "exit_code": rc,
            "verdict": verdict, "cases_run": len(cases),
            "seconds": time.perf_counter() - t0, "summary": summary(text)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "c6_sanitize", help="directory for each tool's log")
    ap.add_argument("--launches", type=int, default=100)
    ap.add_argument("--tools", default=",".join(TOOLS))
    ap.add_argument("--child", action="store_true",
                    help="one run of every case (what the sanitizer runs)")
    ap.add_argument("--repeat", action="store_true",
                    help="the repeats in this process")
    args = ap.parse_args()
    if args.child or args.repeat:
        return child(args.launches, args.repeat)

    import torch

    if not torch.cuda.is_available():
        print("c6_repair_sanitize: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.library()        # built once, outside the sanitizer
    args.out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--repeat", "--launches", str(args.launches)],
                          cwd=ROOT, env=dict(os.environ))
    rc = proc.returncode
    exe = shutil.which("compute-sanitizer") or \
        "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(exe):
        emit({"measure": "sanitizer", "verdict": "compute-sanitizer is not "
              "installed", "looked_for": exe})
        rc = rc or 1
    else:
        version = subprocess.run([exe, "--version"], capture_output=True,
                                 text=True).stdout.strip().splitlines()
        emit({"measure": "sanitizer_version", "version": version[-1:]})
        for tool in args.tools.split(","):
            emit(sanitize(tool, args.out))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    print(chip_smoke.nvidia_smi())
    return rc


if __name__ == "__main__":
    sys.exit(main())
