"""Build and load the port's CUDA kernels (nvcc → one ``.so`` → ``ctypes``).

Every ``csrc/*.cu`` (with the ``csrc/*.cuh`` headers they include) is
compiled for Hopper (``sm_90a``) with ``-fmad=false`` and IEEE math (no
``--use_fast_math``): the kernels must reproduce the plain PyTorch versions'
float32 operations one for one, and a contracted multiply-add rounds once
where PyTorch rounds twice.  The sources compile in parallel (one
``nvcc -c`` each, all started together) and link into one shared library
under ``<repo>/build/repro_torch_kernels/``, named by a hash of the flags,
the sources and the headers, so a fresh checkout builds it on first use,
later calls load it, and an edited header builds anew.  Nothing here runs
at import time.

Each C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("temporal_gate.cu", "temporal_gate_bwd.cu", "ccg_solve.cu",
           "c6_tail.cu", "lpt_queue.cu", "ccg_encode.cu", "ccg_master.cu",
           "decode_attention.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "mamba_scan.cu", "mamba_scan_bwd.cu",
           "rglru_scan.cu", "rglru_scan_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches per wrapper: each ops wrapper adds one where it launches its
# kernel and nowhere else (the plain version never counts)
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the entry points: pointers and the stream are void*
_SIGNATURES = {
    # dx, h, vol, w_x, u_gr, b_g, alpha, b_r, u_h, b_h, w_o, b_o,
    # h_out, tau, g_mean, B, d, m, stream
    "gate_cell_launch": [_P] * 15 + [_I, _I, _I, _P],
    # dx, h, vol, w_g, u_g, b_g, alpha, w_r, u_r, b_r, w_h, u_h, b_h, w_o,
    # b_o, dh_new, dtau, dg_mean (each or null), dh (or null), partial,
    # its rows, grads, B, d, m, stream
    "gate_cell_bwd_launch": [_P] * 20 + [_I, _P, _I, _I, _I, _P],
    # z, aq, warm_y, rn, pn, tier, y_ok, b2k, u_all, c1,
    # y_f, v_star, o_up, o_down, iters, infeasible,
    # M, F, K, P, n_steps, margin, theta, stream
    "ccg_solve_launch": [_P] * 16 + [_I] * 5 + [_F, _F, _P],
    # panel, r, p, v, route, z, acc_thr, rn, pn, bw, gain, can_p,
    # M, N, Z, stream
    "c6_tail_launch": [_P] * 12 + [_I, _I, _I, _P],
    # panel, r, p, v, route, z, acc_thr, rn, pn, budget (or null), alive
    # (bool, or null), r_out, p_out, hist, M, N, Z, rounds, budget value,
    # stream
    "c6_repair_launch": [_P] * 14 + [_I] * 4 + [_F, _P],
    # blocks of a cluster -> clusters the device holds at once (or -error)
    "c6_repair_max_clusters": [_I],
    # t_comp, route, order, init (or null), start, R, M, n_edge, n_cloud,
    # stream
    "lpt_queue_launch": [_P] * 5 + [_I] * 4 + [_P],
    # t_comp, route, order, init (or null), start, scratch, R, M, n_edge,
    # n_cloud, stream
    "lpt_queue_chunked_launch": [_P] * 6 + [_I] * 4 + [_P],
    # z, aq, rn, pn, tier, y_ok, b2s, code, rec_all, best, M, F, K, P,
    # margin, stream
    "ccg_encode_launch": [_P] * 10 + [_I] * 4 + [_F, _P],
    # rec_all, scen_mask, fs_ok, c1, y_star, o_down, M, P, F, stream
    "ccg_master_launch": [_P] * 6 + [_I] * 3 + [_P],
    # q, k, v, length, out, q strides (b, h), k and v strides (b, h, s),
    # B, H, KV, S, D, splits, scale, dtype, stream
    "decode_attention_launch": [_P] * 5 + [_L] * 8 + [_I] * 6 + [_F, _I, _P],
    # q, k, v, length, out (float32), lse (float32 (B, H)), q strides (b, h),
    # k and v strides (b, h, s), B, H, KV, S, D, splits, scale, dtype, stream
    "decode_attention_partial_launch": [_P] * 6 + [_L] * 8 + [_I] * 6
    + [_F, _I, _P],
    # q, k, v, positions (int32 (B, S), or null), out, lse (or null), q/k/v
    # strides (b, h, s), B, H, KV, Sq, Sk, D, BQ, window, causal, scale,
    # dtype, stream
    "flash_attention_launch": [_P] * 6 + [_L] * 9 + [_I] * 9 + [_F, _I, _P],
    # q, k, v, o, dout, positions (or null), dq, dk, dv, stats, lse (or
    # null), q/k/v/o/dout strides (b, h, s), B, H, KV, Sq, Sk, D, BQ,
    # window, causal, scale, dtype, stream
    "flash_attention_bwd_launch": [_P] * 11 + [_L] * 15 + [_I] * 9
    + [_F, _I, _P],
    # x, dt, B, C, A, D, h0, h_out, y, h_tiles (or null), x/dt/B/C strides
    # (b, s), B, S, Di, N, dtype, stream
    "mamba_scan_launch": [_P] * 10 + [_L] * 8 + [_I] * 5 + [_P],
    # x, dt, B, C, A, D, h_tiles, dy, dh (or null), dx, ddt, dB, dC,
    # part_bc, part_ad, dAD, dh0 (or null), h_last (or null), x/dt/B/C
    # strides (b, s), B, S, Di, N, dtype, stream
    "mamba_scan_bwd_launch": [_P] * 18 + [_L] * 8 + [_I] * 5 + [_P],
    # x, r, i, la, h0, h_out, y, B, S, W, dtype, stream
    "rglru_scan_launch": [_P] * 7 + [_I] * 4 + [_P],
    # x, r, i, la, h0 (or null), y, dy, dh (or null), dx, dr, di, part,
    # dla, dh0 (or null), B, S, W, dtype, stream
    "rglru_scan_bwd_launch": [_P] * 14 + [_I] * 4 + [_P],
}


def build_dir() -> Path:
    """``<repo>/build/repro_torch_kernels`` (listed in ``.gitignore``)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _digest() -> str:
    """Hash of the flags, the sources and every header they may include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"librepro_torch_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the sources into the hashed ``.so`` unless it exists.

    The ptxas report (registers, shared memory, spills) of every kernel is
    kept in ``build.log`` beside the library."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs, failed = [], [], []
        for name, obj, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {name}\n{text}")
            objs.append(str(obj))
            if proc.returncode != 0:
                failed.append(name)
        (out.parent / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_so), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, out)     # atomic: concurrent builders agree
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), signatures declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def check_cuda(name: str, *tensors) -> None:
    """Kernel inputs must be contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: every operand must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def check_dtype(name: str, dtype, **tensors) -> None:
    for key, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")


# dtype codes of the attention kernels' C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_strided(name: str, *tensors, align: int = 4) -> int:
    """Operands of a kernel that reads by strides: on one CUDA device, of
    one dtype of ``DTYPE_CODES``, with a contiguous last dimension and, in
    bfloat16, every row start (the pointer and each other stride, in bytes)
    on an ``align``-byte boundary: the kernels load ``align`` bytes at a
    time (4: element pairs; 16: ``cp.async`` chunks).  Returns the dtype
    code."""
    first, dt = tensors[0], tensors[0].dtype
    if dt not in DTYPE_CODES:
        raise TypeError(f"{name}: operands must be float32 or bfloat16, "
                        f"got {dt}")
    index = first.get_device()          # -1 on the CPU
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{name}: every operand must be on one CUDA "
                             f"device, got {t.device} and {first.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: operands must share one dtype, got "
                            f"{t.dtype} and {dt}")
        stride = t.stride()
        if stride[-1] != 1:
            raise ValueError(f"{name}: the last dimension must be "
                             f"contiguous")
        if dt == torch.bfloat16 and (
                t.data_ptr() % align
                or any(st * 2 % align for st in stride[:-1])):
            raise ValueError(f"{name}: bfloat16 operands must start every "
                             f"row on a {align}-byte boundary (pointer "
                             f"{t.data_ptr()}, strides {stride})")
    return DTYPE_CODES[dt]


def dispatch(name: str, force: str, device) -> bool:
    """True when the wrapper must launch its kernel, False for the plain
    version.  ``"auto"``: the kernel for a CUDA tensor, the plain version
    for a CPU tensor; ``"ref"``: the plain version anywhere; ``"kernel"``:
    the kernel, and a CPU tensor raises."""
    if force not in ("auto", "ref", "kernel"):
        raise ValueError(f"{name}: force must be auto|ref|kernel, got {force!r}")
    if force == "ref":
        return False
    if device.type == "cuda":
        return True
    if force == "kernel":
        raise ValueError(f"{name}: force='kernel' needs CUDA tensors, "
                         f"got {device}")
    return False


def refuse_grad(name: str, *tensors, hint: str = "") -> None:
    """Raise where autograd would need a backward that the kernel lacks
    (grad enabled and an operand that requires it): its output would carry
    no gradient.  Kernels with a backward run through their autograd
    functions, whose forward runs with grad disabled."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise NotImplementedError(
            f"{name}: the kernel has no backward, so its output would carry "
            "no gradient; call it under torch.no_grad() or take the plain "
            "version (force='ref')" + (f"; {hint}" if hint else ""))


def pad_rows(t, rows: int, value=0):
    """Append ``rows`` neutral rows along dim 0 (no copy when rows == 0)."""
    if rows == 0:
        return t
    fill = torch.full((rows,) + tuple(t.shape[1:]), value, dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, fill])


@functools.lru_cache(maxsize=None)
def all_ones(f: int, device: torch.device):
    """A cached (F,) float32 availability mask with every option up, for
    kernels that take one (cached and shared: callers must not write it)."""
    return torch.ones((f,), dtype=torch.float32, device=device)


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` (its ``cudaStream_t``) as an
    int.  ``torch._C._cuda_getCurrentRawStream`` reads it without building
    a ``torch.cuda.Stream`` object at every launch; PyTorch's own generated
    code calls it the same way."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
