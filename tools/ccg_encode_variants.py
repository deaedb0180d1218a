#!/usr/bin/env python3
"""Where the time of the ``ccg_encode`` CUDA kernel goes, on one NVIDIA GPU.

    python3 tools/ccg_encode_variants.py [--reps 200]

Builds the kernel as committed (``src/repro_torch/kernels/csrc/
ccg_encode.cu``) and variants of it made by editing its source, each into
its own library under ``build/ccg_encode_variants/``, and times one launch
of each at M = 4096 on round 0 of the seeded stream that ``chip_smoke.py``
serves (CUDA events around ``--reps`` back-to-back launches, median of
five).  The committed kernel must equal the plain version exactly; the
variants that drop work compute wrong results on purpose and are only
timed:

  committed       one task per warp (8 per block)
  four_per_warp   each warp loops over four tasks (blocks of 32 tasks)
  no_fold         stores a value that needs no shared-memory reads
  no_stores       folds, but stores no recourse value
  no_recourse     accuracy, bitmask and argmax only

Prints one JSON line per variant and, last, the card's name and power
limit.  Exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
M = 4096
FOLD = "if ((code >> k) & 1) v = fminf(v, s_b2s[(k * P + pole) * F + f]);"
STORE = "rec[(size_t)pole * F] = v;"
TASK = ("const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);\n"
        "  if (task >= M) return;   // warp-uniform\n")


def variants(src: str) -> dict:
    for needle in (FOLD, STORE, TASK, "for (int pole = 0; pole < P; ++pole)"):
        assert needle in src, needle
    four = (src.replace(TASK, "const int warp = threadIdx.x >> 5;\n"
                        "  for (int task = blockIdx.x * kWarps * 4 + warp; "
                        "task < (blockIdx.x + 1) * kWarps * 4 && task < M; "
                        "task += kWarps) {\n")
            .replace("  if (lane == 0) best_out[task] = bi;\n}",
                     "  if (lane == 0) best_out[task] = bi;\n  }\n}")
            .replace("const int grid = (M + kWarps - 1) / kWarps;",
                     "const int grid = (M + 4 * kWarps - 1) / (4 * kWarps);"))
    return {
        "committed": src,
        "four_per_warp": four,
        "no_fold": src.replace(FOLD, "v = fminf(v, (float)(code >> k));"),
        "no_stores": src.replace(
            STORE, "if (v == 12345.0f) rec[(size_t)pole * F] = v;"),
        "no_recourse": src.replace("for (int pole = 0; pole < P; ++pole)",
                                   "for (int pole = 0; pole < 0; ++pole)"),
    }


def build(cmd: list, name: str, src: str, out: Path):
    """Start nvcc on one variant (``cmd``: compiler, flags, include dir)."""
    cu = out / f"{name}.cu"
    cu.write_text(src)
    return subprocess.Popen([*cmd, "-shared", "-o", str(out / f"{name}.so"),
                             str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ccg_encode_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.robust import RobustProblem
    from repro_torch.kernels import _build
    from repro_torch.kernels.ccg_encode.ops import ccg_encode
    from repro_torch.serving.simulator import SimConfig, Simulator

    csrc = _build.CSRC
    out = ROOT / "build" / "ccg_encode_variants"
    out.mkdir(parents=True, exist_ok=True)
    srcs = variants((csrc / "ccg_encode.cu").read_text())
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc)]
    procs = {n: build(cmd, n, s, out) for n, s in srcs.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")

    dev = torch.device("cuda")
    sys_ = SystemConfig()
    prob = RobustProblem.build(sys_, dev)
    lat = prob.lat
    stream = Simulator(sys_, SimConfig(n_tasks=M, seed=0),
                       device=dev).sample_stream(n_rounds=1)
    z, aq = stream.z[0].contiguous(), stream.aq[0].contiguous()
    want = ccg_encode(z, aq, lat.rn_flat, lat.pn_flat, lat.tier_flat,
                      prob.b2_scaled, prob.rec_table,
                      margin=sys_.acc_margin_robust,
                      num_versions=sys_.num_versions, force="ref")
    f, p, k = lat.n_flat, prob.poles.shape[0], sys_.num_versions
    b2s = prob.b2_scaled.permute(2, 0, 1).contiguous()           # (K, P, F)
    ins = [z, aq, lat.rn_flat, lat.pn_flat, lat.tier_flat,
           _build.all_ones(f, dev), b2s]
    for name in srcs:
        fn = ctypes.CDLL(str(out / f"{name}.so")).ccg_encode_launch
        fn.argtypes = _build._SIGNATURES["ccg_encode_launch"]
        # sentinels, so that a variant that skips a store cannot pass on
        # memory an earlier variant left behind
        outs = [torch.full((M, f), -7, dtype=torch.int32, device=dev),
                torch.full((M, p, f), float("nan"), device=dev),
                torch.full((M,), -7, dtype=torch.int32, device=dev)]
        call = [t.data_ptr() for t in ins + outs] + [
            M, f, k, p, sys_.acc_margin_robust, _build.stream_ptr(dev)]
        _build.check(fn(*call), name)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, w) for g, w in zip(outs, want))
        if name in ("committed", "four_per_warp") and not exact:
            raise AssertionError(f"{name} differs from the plain version")
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                fn(*call)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / args.reps)
        print(json.dumps({"variant": name, "ms": statistics.median(times),
                          "exact_vs_plain": exact}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
