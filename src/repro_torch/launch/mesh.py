"""Meshes over the ranks of a ``torch.distributed`` process group, and the
starter of ranks that the tests, the training launcher and
``chip_smoke.py`` use.

:func:`host_mesh` is a 1-D mesh over whatever ranks the running process
group has, its one dim named ``"data"`` (the stream axis the serving path
shards).  :func:`make_host_mesh` is the counterpart of
``repro/launch/mesh.py``'s (:17): a 2-D ``("data", "model")`` mesh over
those ranks, shape (1, n) by default as the reference's, or any shape
whose product is n (the trainer's).  ``make_production_mesh`` (the
256/512-device TPU pod shapes) is ROADMAP queue A.17: it raises.

The backend is the caller's explicit choice and follows the device: NCCL
for CUDA, one rank a card; gloo for the CPU.  Several ranks on one card
take gloo, asked for by name: their collectives then stage each tensor
through the host (``sharding/collectives.py``).  Nothing picks gloo
quietly.

A process group cannot shrink: after a ``NodeFailure`` the world ends and
the survivors start a new one of their count, whose ranks build the
``runtime.cluster.elastic_remesh`` mesh and restore the checkpoint onto it.

:func:`run_ranks` starts D ranks as spawned processes that meet through a
``FileStore`` in a fresh temporary directory (no ports), runs one function
on each and returns what each returned; :func:`single_rank_group` runs a
world of one in the calling process.  Each start has its own time limit:
a rank that fails, or a world that outlasts the limit, stops every rank
and raises.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BACKENDS = ("nccl", "gloo")


def mesh_device_type(backend: str | None = None) -> str:
    """The device type a mesh over ``backend``'s ranks exchanges on:
    ``"cuda"`` for NCCL, ``"cpu"`` for gloo (whose CUDA operands are staged
    through the host).  ``None`` reads the running default group's."""
    backend = dist.get_backend() if backend is None else backend
    return "cuda" if backend == "nccl" else "cpu"


def host_mesh(axis: str = "data") -> DeviceMesh:
    """A 1-D mesh over every rank of the running default process group,
    its dim named ``axis``.  A collective call: every rank makes it."""
    if not dist.is_initialized():
        raise RuntimeError("host_mesh needs a running process group "
                           "(run_ranks / single_rank_group start one)")
    return DeviceMesh(mesh_device_type(),
                      list(range(dist.get_world_size())),
                      mesh_dim_names=(axis,))


def make_host_mesh(shape: tuple | None = None) -> DeviceMesh:
    """A ``("data", "model")`` mesh over every rank of the running default
    process group, rank ``d·M + m`` at (d, m): shape (1, n) by default, or
    ``shape`` (its product must be n).  A collective call."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a running process group "
                           "(run_ranks / single_rank_group start one)")
    n = dist.get_world_size()
    shape = (1, n) if shape is None else tuple(shape)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} for {n} ranks")
    ranks = torch.arange(n).reshape(shape).tolist()
    return DeviceMesh(mesh_device_type(), ranks,
                      mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "make_production_mesh: the reference's 16 × 16 and 2 × 16 × 16 "
        "TPU pod meshes (256 / 512 devices) are ROADMAP queue A.17; train "
        "across ranks on make_host_mesh")


def _check_backend(backend: str, world: int = 1) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend='nccl' needs CUDA, which is not "
                           "available")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"backend='nccl' takes one rank a card: {world} "
                         f"ranks on {torch.cuda.device_count()} cards (ranks "
                         f"sharing a card take gloo, asked for by name)")


def _init(backend: str, store_path: str, rank: int, world: int,
          timeout: float) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))


@contextlib.contextmanager
def single_rank_group(backend: str, timeout: float = 120.0):
    """A world of one rank in this process, on ``backend`` (NCCL on the
    card, gloo on the CPU), torn down on exit."""
    _check_backend(backend)
    if dist.is_initialized():
        raise RuntimeError("a process group is already running here")
    tmp = tempfile.mkdtemp(prefix="repro_torch_store_")
    try:
        _init(backend, os.path.join(tmp, "store"), 0, 1, timeout)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(fn, args, rank: int, world: int, backend: str,
               store_path: str, timeout: float, threads, results) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, put
    ``(rank, ok, result or traceback)`` on ``results``."""
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        _init(backend, store_path, rank, world, timeout)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def run_ranks(fn, world: int, *, backend: str, args=(),
              timeout: float = 120.0, threads: int | None = 1) -> list:
    """Start ``world`` ranks on ``backend`` and call ``fn(*args)`` in each,
    inside the running group; returns each rank's result, in rank order.

    ``fn`` must be importable (a module-level function) and return
    picklable host objects (numpy, Python), not CUDA tensors.  Each rank
    sets ``threads`` CPU threads (None leaves torch's default).  The
    ranks are spawned, never forked, and meet through a ``FileStore`` in a
    fresh temporary directory.  A rank that raises, dies, or a world that
    has not finished within ``timeout`` seconds stops every rank and
    raises (``RuntimeError`` / ``TimeoutError``)."""
    _check_backend(backend, world)
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_store_")
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, rank, world, backend, store_path,
                               timeout, threads, results), daemon=True)
             for rank in range(world)]
    deadline = time.monotonic() + timeout
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world} ranks on {backend} did not finish within "
                    f"{timeout} s ({sorted(got)} did)")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if not dead:
                    continue
                try:        # a failed rank's traceback may still be queued
                    rank, ok, out = results.get(timeout=2.0)
                except queue_mod.Empty:
                    raise RuntimeError(f"a rank exited with code {dead[0]} "
                                       f"before reporting") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
