#!/usr/bin/env python3
"""Variants of the port's CUDA kernels, checked and timed in turns on one
NVIDIA GPU.

    python3 tools/kernel_variants.py [--kernel ccg_encode|mamba_scan|
                                      flash_attention|decode_attention|
                                      lpt_queue] [--rounds 2]
                                     [--diagnose] [--reps 200]

Builds each kernel as committed (``src/repro_torch/kernels/csrc/``) and
variants made by editing its source, each into its own library under
``build/kernel_variants/`` (one ``nvcc`` per variant, all started
together), then checks and times every library in turn, ``--rounds`` times
over and in the reverse order every other round, so that a drift of the
card reaches them alike.  A variant outside its tolerance is reported, not
timed.

  ccg_encode       committed      one task per warp (8 per block)
                   four_per_warp  each warp loops over four tasks
  mamba_scan       committed      2^(dt·(A·log2 e)) by ex2.approx.ftz, A
                                  scaled once; steps unrolled by 4
                   exp2f          exp2f (subnormal results kept) instead
                   expf           IEEE expf of dt·A, as the plain version
                   unroll8        steps unrolled by 8
                   tile64         64 steps staged at once, not 32
  flash_attention  committed      tiles of 32 keys, double-buffered
                   keys64         tiles of 64 keys
                   keys16         tiles of 16 keys
                   no_min_blocks  registers not capped (committed: for 4
                                  blocks an SM, 2 at D = 256)
  decode_attention committed      the wrapper's split rule (3 / 2 / 5
                                  splits at the cloud / edge /
                                  RecurrentGemma slabs)
                   splits2/4/8    2, 4 or 8 splits at every shape
  lpt_queue        committed      the sorted walk where the inputs allow it
                                  (each tier's loads kept sorted by load and
                                  index), else the tree walk
                   tree           the tree walk always: a balanced-tree
                                  argmin over a tier's loads each task
                   linear         the tree walk with a linear chain of
                                  compare-selects for the argmin

``ccg_encode`` runs at M = 4096 on round 0 of the seeded stream that
``chip_smoke.py`` serves, ``lpt_queue`` at M = 4096 on all-edge routes (the
main path's) and on mixed ones: each must equal the plain version exactly,
and is timed by CUDA events around ``--reps`` back-to-back launches (median
of five).  ``mamba_scan``, ``flash_attention`` and ``decode_attention`` go
through ``chip_smoke.py``'s own checks and timings with the variant's
library in place of ``_build.library()``: every case of the kernel-vs-plain
comparison within its tolerance, the device time (profiler) and the call
time (CUDA events) at the serving shapes.

With ``--diagnose`` it builds instead variants that drop one part of the
work, compute wrong results on purpose and are only timed, to show where a
kernel's time goes:

  ccg_encode       no_fold        stores a value that needs no shared-memory
                                  reads
                   no_stores      folds, but stores no recourse value
                   no_recourse    accuracy, bitmask and argmax only
  mamba_scan       no_exp         dt·A in place of its exponential
                   no_shuffle     no quad sum of y
                   no_bc_loads    B_t, C_t not read from shared memory
                   no_xdt_loads   x_t, dt_t not read from shared memory
                   no_staging     nothing staged in shared memory
  flash_attention  no_mma         no tensor-core product
                   no_loads       no copy into shared memory
                   no_stores      no output store
  decode_attention no_combine     each split's own partial out: no cluster
                                  sync, no distributed shared memory
                   no_cluster     the same, launched without clusters
                   no_loads       no copy of K/V into shared memory
  lpt_queue        no_prefetch    each batch of 32 tasks read from shared
                                  memory as its walk starts, not a batch
                                  ahead
                   no_walk        gather and scatter only

Prints one JSON line per (round, variant) and, last, the card's name and
power limit.  Exits 1 without CUDA.
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
M = 4096                          # ccg_encode's tasks, as chip_smoke.py

# ccg_encode.cu
FOLD = "if ((code >> k) & 1) v = fminf(v, s_b2s[(k * P + pole) * F + f]);"
STORE = "rec[(size_t)pole * F] = v;"
TASK = ("const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);\n"
        "  if (task >= M) return;   // warp-uniform\n")
POLES = "for (int pole = 0; pole < P; ++pole)"
# mamba_scan.cu
EX2 = "const float da = ex2_approx(dv * a[i]);"
SCALE = ("#pragma unroll\n  for (int i = 0; i < kPerLane; ++i) "
         "a[i] *= 1.4426950408889634f;   // log2(e)\n")
UNROLL = "#pragma unroll 4\n    for (int tt = 0; tt < nt; ++tt) {"
TILE = "constexpr int kTileT = 32;"
BC_LOADS = ("const float4 b4 = *reinterpret_cast<const float4*>(&b_s[tt][n0]);"
            "\n        const float4 c4 = *reinterpret_cast<const float4*>"
            "(&c_s[tt][n0]);\n")
XDT_LOADS = ("const float xv = x_s[tt][ch];\n"
             "      const float dv = dt_s[tt][ch];\n")
SHUFFLES = ("      acc += __shfl_xor_sync(0xffffffffu, acc, 1);\n"
            "      acc += __shfl_xor_sync(0xffffffffu, acc, 2);\n")
# flash_attention.cu
KEYS = "constexpr int kKeys = 32;"
FLASH_BOUNDS = ("__global__ void __launch_bounds__(kThreads, D <= 128 ? 4 : 2)"
                "\n    flash_attention_kernel_bf16(")
MMA = '''  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
CP_ASYNC = ('asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" '
            '::"r"(dst),')
STORE_SKIP = "    if (off < 0) continue;\n    *reinterpret_cast<uint4*>(out"
# decode_attention.cu
LAUNCH_STREAM = "cudaStream_t st = (cudaStream_t)stream;"
PEER_M = "      if (r < splits) {\n        m_i[r] = *peer(m_s + g, r);"
PEER_ACC = ("      if (r < splits) {\n"
            "        const float w = exp2f(m_i[r] - m);")
PEER = ("auto peer = [&](float* p, int r) { return cluster.map_shared_rank(p, "
        "r); };")
SYNC_READY = "cluster.sync();                            // every split's"
SYNC_DONE = "cluster.sync();                            // peers done"
CLUSTER_ATTR = "cfg.numAttrs = 1;"
CP16 = 'asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(d),'
# lpt_queue.cu
TREE = """  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) {
      const bool right = val[i + w] < val[i];
      val[i] = right ? val[i + w] : val[i];
      idx[i] = right ? idx[i + w] : idx[i];
    }
  }"""
LINEAR = """  for (int i = 1; i < N; ++i) {
    const bool right = val[i] < val[0];
    val[0] = right ? val[i] : val[0];
    idx[0] = right ? idx[i] : idx[0];
  }"""
AHEAD = ("      t[4 * u] = next[u].x;\n      t[4 * u + 1] = next[u].y;\n"
         "      t[4 * u + 2] = next[u].z;\n      t[4 * u + 3] = next[u].w;\n")
SORTED_WALK = "const bool sorted = !odd & cloud_alive;"
WALKERS = ("(tid == 0) & (n_edge_tasks > 0)", "(tid == 32) & (n_cloud_tasks > 0)",
           "} else if (!sorted & (tid == 0)) {")


def edit(src: str, *pairs) -> str:
    """``src`` with each (old, new) pair replaced; each old text must occur
    exactly once."""
    for old, new in pairs:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def variants(kernel: str, src: str) -> dict:
    """The committed source and the variants that keep its results."""
    if kernel == "ccg_encode":
        return {"committed": src, "four_per_warp": edit(
            src,
            (TASK, "const int warp = threadIdx.x >> 5;\n  for (int task = "
             "blockIdx.x * kWarps * 4 + warp; task < (blockIdx.x + 1) * "
             "kWarps * 4 && task < M; task += kWarps) {\n"),
            ("  if (lane == 0) best_out[task] = bi;\n}",
             "  if (lane == 0) best_out[task] = bi;\n  }\n}"),
            ("const int grid = (M + kWarps - 1) / kWarps;",
             "const int grid = (M + 4 * kWarps - 1) / (4 * kWarps);"))}
    if kernel == "mamba_scan":
        return {
            "committed": src,
            "exp2f": edit(src, (EX2, "const float da = exp2f(dv * a[i]);")),
            "expf": edit(src, (EX2, "const float da = expf(dv * a[i]);"),
                         (SCALE, "")),
            "unroll8": edit(src, (UNROLL, UNROLL.replace("4", "8", 1))),
            "tile64": edit(src, (TILE, TILE.replace("32", "64"))),
        }
    if kernel == "decode_attention":
        return {"committed": src, **{
            f"splits{n}": edit(src, (LAUNCH_STREAM, f"splits = min({n}, S);"
                                     f"\n  {LAUNCH_STREAM}"))
            for n in (2, 4, 8)}}
    if kernel == "lpt_queue":
        tree = edit(src, (SORTED_WALK, "const bool sorted = false;"))
        return {"committed": src, "tree": tree,
                "linear": edit(tree, (TREE, LINEAR))}
    return {
        "committed": src,
        "keys64": edit(src, (KEYS, KEYS.replace("32", "64"))),
        "keys16": edit(src, (KEYS, KEYS.replace("32", "16"))),
        "no_min_blocks": edit(src, (FLASH_BOUNDS, FLASH_BOUNDS.replace(
            "(kThreads, D <= 128 ? 4 : 2)", "(kThreads)"))),
    }


def diagnostics(kernel: str, src: str) -> dict:
    """The committed source and variants that drop one part of the work
    (wrong results: timed only)."""
    if kernel == "ccg_encode":
        return {
            "committed": src,
            "no_fold": edit(src, (FOLD, "v = fminf(v, (float)(code >> k));")),
            "no_stores": edit(src, (STORE, "if (v == 12345.0f) "
                                    "rec[(size_t)pole * F] = v;")),
            "no_recourse": edit(src, (POLES, POLES.replace("< P", "< 0"))),
        }
    if kernel == "mamba_scan":
        return {
            "committed": src,
            "no_exp": edit(src, (EX2, "const float da = dv * a[i];")),
            "no_shuffle": edit(src, (SHUFFLES, "")),
            "no_bc_loads": edit(src, (BC_LOADS, "const float4 b4 = make_float4("
                                      "xv, dv, xv, dv), c4 = make_float4("
                                      "dv, xv, dv, xv);\n")),
            "no_xdt_loads": edit(src, (XDT_LOADS, "const float xv = 0.5f + "
                                       "1e-3f * (tt + ch);\n      const "
                                       "float dv = 0.25f + 1e-3f * tt;\n")),
            "no_staging": edit(
                src, ("i < nt * N; i += kThreads", "i < 0; i += kThreads"),
                ("i < nt * kChannels; i += kThreads",
                 "i < 0; i += kThreads")),
        }
    if kernel == "decode_attention":
        no_combine = ((PEER_M, PEER_M.replace("r < splits", "r < 1")),
                      (PEER_ACC, PEER_ACC.replace("r < splits", "r < 1")),
                      (PEER, "auto peer = [&](float* p, int r) { return p; };"),
                      (SYNC_READY, "__syncthreads();  // "),
                      (SYNC_DONE, "// "))
        return {
            "committed": src,
            "no_combine": edit(src, *no_combine),
            "no_cluster": edit(src, *no_combine,
                               (CLUSTER_ATTR, "cfg.numAttrs = 0;")),
            "no_loads": edit(src, (CP16, "if (d == 1u) " + CP16)),
        }
    if kernel == "lpt_queue":
        return {"committed": src,
                "no_prefetch": edit(src, (AHEAD, "".join(
                    f"      t[4 * u + {k}] = times[i0 + 4 * u + {k}];\n"
                    for k in range(4)))),
                "no_walk": edit(src, *((w, "(tid < 0)") for w in WALKERS[:2]),
                                (WALKERS[2], "} else if (tid < 0) {"))}
    return {
        "committed": src,
        "no_mma": edit(src, (MMA, "  c[0] += __uint_as_float((a[0] ^ a[1] ^ "
                             "a[2] ^ a[3] ^ b0 ^ b1) & 0x3f800000u) * 1e-30f;")),
        "no_loads": edit(src, (CP_ASYNC, "if (dst == 1u) asm volatile("
                               "\"cp.async.cg.shared.global [%0], [%1], 16, "
                               "%2;\\n\" ::\"r\"(dst),")),
        "no_stores": edit(src, (STORE_SKIP, STORE_SKIP.replace(
            "off < 0", "off < 0 || l[0] != -1.0f"))),
    }


class Library:
    """The kernel library with one entry point taken from a variant."""

    def __init__(self, base, name: str, fn):
        self._base, self._name, self._fn = base, name, fn

    def __getattr__(self, attr):
        return self._fn if attr == self._name else getattr(self._base, attr)


def build(kernels, diagnose: bool) -> dict:
    """Every variant of ``kernels`` built and loaded: {kernel: {variant:
    Library}}."""
    from repro_torch.kernels import _build

    base = _build.library()
    csrc = _build.CSRC
    out = ROOT / "build" / "kernel_variants"
    out.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc)]
    make = diagnostics if diagnose else variants
    procs = {}
    for kernel in kernels:
        for name, src in make(kernel, (csrc / f"{kernel}.cu")
                              .read_text()).items():
            cu = out / f"{kernel}_{name}.cu"
            cu.write_text(src)
            so = out / f"{kernel}_{name}.so"
            procs[kernel, name] = (so, subprocess.Popen(
                [*cmd, "-shared", "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (kernel, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {kernel} {name}:\n{log}")
        entry = f"{kernel}_launch"
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        libs.setdefault(kernel, {})[name] = Library(base, entry, fn)
    return libs


class CcgEncode:
    """``ccg_encode`` at M = 4096, launched through its entry point with
    sentinel outputs, so that a variant that skips a store cannot pass on
    memory an earlier variant left behind."""

    def __init__(self, torch, reps: int):
        from repro_torch.core.cost_model import SystemConfig
        from repro_torch.core.robust import RobustProblem
        from repro_torch.kernels import _build
        from repro_torch.kernels.ccg_encode.ops import ccg_encode
        from repro_torch.serving.simulator import SimConfig, Simulator

        self.torch, self.reps = torch, reps
        dev = self.dev = torch.device("cuda")
        sys_ = SystemConfig()
        prob = RobustProblem.build(sys_, dev)
        lat = prob.lat
        stream = Simulator(sys_, SimConfig(n_tasks=M, seed=0),
                           device=dev).sample_stream(n_rounds=1)
        z, aq = stream.z[0].contiguous(), stream.aq[0].contiguous()
        self.want = ccg_encode(z, aq, lat.rn_flat, lat.pn_flat,
                               lat.tier_flat, prob.b2_scaled, prob.rec_table,
                               margin=sys_.acc_margin_robust,
                               num_versions=sys_.num_versions, force="ref")
        self.f, self.p = lat.n_flat, prob.poles.shape[0]
        b2s = prob.b2_scaled.permute(2, 0, 1).contiguous()       # (K, P, F)
        self.ins = [z, aq, lat.rn_flat, lat.pn_flat, lat.tier_flat,
                    _build.all_ones(self.f, dev), b2s]
        self.sizes = [M, self.f, sys_.num_versions, self.p,
                      sys_.acc_margin_robust]

    def __call__(self, lib, exact_required: bool) -> dict:
        from repro_torch.kernels import _build

        torch, dev, f, p = self.torch, self.dev, self.f, self.p
        outs = [torch.full((M, f), -7, dtype=torch.int32, device=dev),
                torch.full((M, p, f), float("nan"), device=dev),
                torch.full((M,), -7, dtype=torch.int32, device=dev)]
        call = [t.data_ptr() for t in self.ins + outs] + self.sizes + [
            _build.stream_ptr(dev)]
        fn = lib.ccg_encode_launch
        _build.check(fn(*call), "ccg_encode")
        torch.cuda.synchronize()
        exact = all(torch.equal(g, w) for g, w in zip(outs, self.want))
        if exact_required and not exact:
            return {"outside_tolerance": "differs from the plain version"}
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self.reps):
                fn(*call)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / self.reps)
        return {"ms": statistics.median(times), "exact_vs_plain": exact}


class LptQueue:
    """``lpt_queue`` at M = 4096, launched through its entry point on the
    sorted order the wrapper computes, with a sentinel output: all-edge
    routes, as the main path's, and mixed ones."""

    def __init__(self, torch, reps: int):
        from repro_torch.kernels.lpt_queue.ops import lpt_queue

        self.torch, self.reps = torch, reps
        dev = self.dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(5)
        t = (torch.rand(M, generator=gen) * 0.5 + 0.001).to(dev)
        self.cases = {}
        for routes in ("all_edge", "mixed"):
            route = (torch.zeros(M, dtype=torch.int32) if routes == "all_edge"
                     else torch.randint(0, 2, (M,), generator=gen,
                                        dtype=torch.int32)).to(dev)
            self.cases[routes] = (t, route, torch.argsort(-t, stable=True),
                                  lpt_queue(t, route, 4, 1, force="ref"))

    def __call__(self, lib, exact_required: bool) -> dict:
        from repro_torch.kernels import _build

        torch, rec = self.torch, {}
        for routes, (t, route, order, want) in self.cases.items():
            start = torch.full_like(t, float("nan"))
            call = [t.data_ptr(), route.data_ptr(), order.data_ptr(), None,
                    start.data_ptr(), 1, M, 4, 1, _build.stream_ptr(self.dev)]
            fn = lib.lpt_queue_launch
            _build.check(fn(*call), "lpt_queue")
            torch.cuda.synchronize()
            exact = torch.equal(start, want)
            if exact_required and not exact:
                return {"outside_tolerance": f"{routes}: differs from the "
                                             f"plain version"}
            times = []
            for _ in range(5):
                begin = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                begin.record()
                for _ in range(self.reps):
                    fn(*call)
                end.record()
                end.synchronize()
                times.append(begin.elapsed_time(end) / self.reps)
            rec[routes] = {"ms": statistics.median(times),
                           "exact_vs_plain": exact}
        return rec


class SmokeRows:
    """``mamba_scan``, ``flash_attention`` or ``decode_attention`` through
    ``chip_smoke.py``'s checks and timings (``scan_rows`` /
    ``attention_rows``), or, for a diagnostic variant, its device time
    alone at the serving shapes."""

    KEYS = ("ms", "ms_from", "call_ms", "max_abs_err", "max_abs_err_float32")

    def __init__(self, torch, chip_smoke, kernel: str):
        from repro_torch.kernels.decode_attention.ops import decode_attention
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.mamba_scan.ops import selective_scan

        self.torch, self.chip_smoke, self.kernel = torch, chip_smoke, kernel
        self.fn = {"mamba_scan": selective_scan,
                   "flash_attention": flash_attention,
                   "decode_attention": decode_attention}[kernel]
        dev = self.dev = torch.device("cuda")
        gen = torch.Generator(dev).manual_seed(13)

        def normal(*shape, dtype=torch.float32, scale=1.0):
            return (scale * torch.randn(shape, generator=gen,
                                        device=dev)).to(dtype)

        bf16 = torch.bfloat16
        if kernel == "decode_attention":
            # the slabs at ragged lengths 1..S, read through permuted views
            self.shapes = {}
            for tier, (h, kv, d, s) in {
                    "cloud": (32, 8, 128, 144), "edge": (16, 16, 64, 144),
                    "recurrentgemma": (16, 1, 256, 80)}.items():
                length = torch.randint(1, s + 1, (16,), generator=gen,
                                       device=dev, dtype=torch.int32)
                self.shapes[tier] = ((
                    normal(16, h, d, dtype=bf16),
                    normal(16, s, kv, d, dtype=bf16).permute(0, 2, 1, 3),
                    normal(16, s, kv, d, dtype=bf16).permute(0, 2, 1, 3),
                    length), {})
        elif kernel == "flash_attention":
            self.shapes = {
                tier: ((normal(8, 80, h, d, dtype=bf16).transpose(1, 2),
                        normal(8, 80, kv, d, dtype=bf16).transpose(1, 2),
                        normal(8, 80, kv, d, dtype=bf16).transpose(1, 2)), kw)
                for tier, (h, kv, d, kw) in {
                    "cloud": (32, 8, 128, {}), "edge": (16, 16, 64, {}),
                    "recurrentgemma": (16, 1, 256, {"window": 2048})}.items()}
        else:
            self.shapes = {
                what: ((normal(b, s, 8192, dtype=bf16),
                        torch.nn.functional.softplus(normal(b, s, 8192,
                                                            scale=0.5)),
                        normal(b, s, 16, dtype=bf16),
                        normal(b, s, 16, dtype=bf16),
                        -torch.exp(normal(8192, 16, scale=0.2)), normal(8192),
                        normal(b, 8192, 16) if s == 1 else None), {})
                for what, (b, s) in {"decode": (16, 1),
                                     "prefill": (8, 80)}.items()}

    def __call__(self, lib, exact_required: bool) -> dict:
        from repro_torch.kernels import _build

        torch, smoke, kernel = self.torch, self.chip_smoke, self.kernel
        _build.library = lambda: lib
        if not exact_required:
            return {what: smoke.device_ms(
                torch, lambda: self.fn(*args, force="kernel", **kw),
                f"{kernel}_kernel")
                for what, (args, kw) in self.shapes.items()}
        try:
            rows = (smoke.scan_rows(torch, self.dev) if kernel == "mamba_scan"
                    else smoke.attention_rows(torch, self.dev))
        except AssertionError as err:
            return {"outside_tolerance": str(err)}
        row = rows[kernel]
        rec = {k: row[k] for k in self.KEYS}
        for sub in ("prefill", "edge", "recurrentgemma"):
            if sub in row:
                rec[sub] = {k: row[sub][k] for k in self.KEYS
                            if k in row[sub]}
        return rec


KERNELS = ("ccg_encode", "mamba_scan", "flash_attention", "decode_attention",
           "lpt_queue")
EVENT_TIMED = {"ccg_encode": CcgEncode, "lpt_queue": LptQueue}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=KERNELS, action="append")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--diagnose", action="store_true",
                    help="time the variants that drop one part of the work")
    ap.add_argument("--reps", type=int, default=200,
                    help="ccg_encode / lpt_queue launches per timing")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build

    kernels = args.kernel or list(KERNELS)
    libs = build(kernels, args.diagnose)
    library = _build.library
    runs = {k: EVENT_TIMED[k](torch, args.reps) if k in EVENT_TIMED
            else SmokeRows(torch, chip_smoke, k) for k in kernels}
    try:
        for rnd in range(args.rounds):
            for kernel, by_name in libs.items():
                for name in list(by_name)[::-1 if rnd % 2 else 1]:
                    rec = {"round": rnd, "kernel": kernel, "variant": name}
                    rec.update(runs[kernel](by_name[name],
                                            exact_required=not args.diagnose))
                    print(json.dumps(rec), flush=True)
    finally:
        _build.library = library
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
