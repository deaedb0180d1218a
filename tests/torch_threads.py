"""The CPU threads of a port test process, capped once per process.

Every ``tests/test_torch_*.py`` and every shared ``tests/torch_*.py``
helper imports this module first, before any torch work.  Under
``pytest -n N`` (xdist sets ``PYTEST_XDIST_WORKER_COUNT``) each worker's
torch gets ``os.cpu_count() // N`` intra-op threads (at least one) and a
single inter-op thread, so N workers together use about the machine's
cores instead of N times them; without xdist the process keeps all of
them.  Oversubscribed on an 8-core CPU, a torch process beside five busy
workers ran its test more than three times slower than with one thread
each.

The JAX subprocesses that the parity harnesses start get the same cap:
:func:`subprocess_env` sets ``OMP_NUM_THREADS`` and names this worker's
block of cores, and :func:`child_script` puts the script on them before
it imports JAX.  XLA sizes its CPU thread pools by the cores a process
may run on; its ``XLA_FLAGS`` for intra-op threads
(``--xla_cpu_multi_thread_eigen=false``, ``intra_op_parallelism_threads``)
left a jax 0.9 process's matrix products on about three cores of an
8-core CPU.  The
ranks that ``repro_torch.launch.mesh.run_ranks`` spawns are pinned to one
torch thread there.

Where torch is not installed, importing this module skips the importing
test file at collection (``pytest.importorskip``), so a run of ``tests/``
collects the JAX package's tests alone.
"""
from __future__ import annotations

import os
import textwrap

import pytest

torch = pytest.importorskip("torch")


def workers() -> int:
    """The xdist worker count, 1 without xdist."""
    return max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1))


THREADS = max(1, (os.cpu_count() or 1) // workers())

torch.set_num_threads(THREADS)
torch.set_num_interop_threads(1)

CPUS_VAR = "REPRO_TEST_CHILD_CPUS"
_PIN = f"""\
import os
if os.environ.get({CPUS_VAR!r}):
    os.sched_setaffinity(0, [int(c) for c in
                             os.environ[{CPUS_VAR!r}].split(",")])
"""


def child_cpus(child: int = 0) -> list:
    """The block of ``THREADS`` cores of this xdist worker's ``child``-th
    concurrent subprocess (worker gwN's first child the N-th block, its
    next ones a worker count of blocks further, round the machine), or
    every core without xdist."""
    n = os.cpu_count() or 1
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    if workers() == 1 or not worker.startswith("gw"):
        return list(range(n))
    first = (int(worker[2:]) + child * workers()) * THREADS
    return [(first + i) % n for i in range(THREADS)]


def subprocess_env(child: int = 0, **extra) -> dict:
    """This process's environment for a child process, its threads capped
    as this process's are: ``OMP_NUM_THREADS`` the cap, and the cores
    that :func:`child_script` pins the child to (``child``: which of the
    caller's concurrent subprocesses it is)."""
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS),
               **{CPUS_VAR: ",".join(map(str, child_cpus(child)))})
    env.update(extra)
    return env


def child_script(script: str) -> str:
    """``script`` (dedented) after a prologue that pins the process to the
    cores :func:`subprocess_env` names."""
    return _PIN + textwrap.dedent(script)
