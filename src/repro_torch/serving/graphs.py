"""One serving round as a CUDA graph — the port's counterpart of the
reference's compiled drivers (``_serve_run``, ``_decide_scan`` and
``_serve_run_churn`` in ``repro/serving/session.py``: one ``lax.scan`` per
run, one compiled program).

A :class:`RoundGraph` captures ONE round, replayed once a round, whatever
the run's length R:

* the round-stacked observation is copied (device to device) into static
  (capacity, ...) buffers once a run; the round reads its row through a
  device-side index (``index_select``), writes its outputs into static
  (capacity, ...) buffers with ``index_copy_`` and advances the index;
* the carry (the policy state, and a slot pool's alive / degrade / queue)
  stays in the tensors given to the graph: each round copies its new
  values into them in place, so a graph holds them by address and a
  session that refills them (``reset``) keeps its graph valid;
* the round itself is ``step(carry, obs) -> (carry, out)``, the very
  function the eager loop calls a round.

The first round of a graph's first run is its warm-up: it runs on a side
stream for real (the kernels' once-per-device set-up and every lazily
built table happen there), then the round is captured
(``capture_error_mode`` "global"), and the later rounds replay it.  A
failed capture raises; nothing falls back to the eager loop.  A replay
makes no wrapper call, so it adds the launches the capture recorded to
``kernels._build.LAUNCHES``, and a sharded round's collectives to
``sharding.collectives.COLLECTIVES`` (the capture itself launched and
exchanged nothing and counts nothing).  Without capture
(``capture=False``, the CPU) every round runs the same function eagerly.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import time

import torch

from repro_torch.kernels._build import LAUNCHES
from repro_torch.serving.policy import Observation
from repro_torch.serving.tree import tree_leaves
from repro_torch.sharding.collectives import COLLECTIVES


def assign(dst: list, src: list) -> None:
    """Copy each tensor of ``src`` into its place in ``dst``, in place.  A
    source that shares memory with another destination is copied aside
    first, so no value is overwritten before it is read."""
    if len(dst) != len(src):
        raise ValueError(f"carry has {len(src)} tensors, expected "
                         f"{len(dst)}")
    ptrs = {d.data_ptr() for d in dst}
    src = [s.clone() if s is not d and s.data_ptr() in ptrs else s
           for d, s in zip(dst, src)]
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)


def signature(stream: Observation) -> tuple:
    """What a graph is specialised to: the fields a round-stacked stream
    carries, with their per-round shapes and dtypes."""
    return tuple((f.name, tuple(t.shape[1:]), t.dtype)
                 for f in dataclasses.fields(stream)
                 if (t := getattr(stream, f.name)) is not None)


class RoundGraph:
    """One round of ``step`` over static buffers (see the module doc).

    ``carry``: the tensors the round reads and updates in place;
    ``stream``: a round-stacked observation of the kind the graph will
    run, whose length sets the capacity (a longer run needs a new graph);
    ``capture``: capture on the card (CUDA only), or run every round
    eagerly through the same function.
    """

    def __init__(self, step, carry, stream: Observation, *,
                 capture: bool = True):
        dev = stream.z.device
        if capture and dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tensors, got {dev}")
        self.step = step
        self.carry = carry
        self.leaves = tree_leaves(carry)
        self.capacity = stream.n_rounds
        self.signature = signature(stream)
        self.inputs = {
            f.name: torch.empty((self.capacity,) + tuple(t.shape[1:]),
                                dtype=t.dtype, device=dev)
            for f in dataclasses.fields(stream)
            if (t := getattr(stream, f.name)) is not None}
        self.index = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.outs = None
        self.capture = capture
        self.graph = None
        self.capture_s = None          # host seconds of the capture
        self.launches = collections.Counter()   # kernel launches a replay
        self.collectives = []       # collectives a replay (a sharded round)
        self.replays = 0

    def holds(self, carry) -> bool:
        """Whether the graph was built on exactly these carry tensors."""
        leaves = tree_leaves(carry)
        return len(leaves) == len(self.leaves) and all(
            a is b for a, b in zip(leaves, self.leaves))

    def _round(self) -> None:
        """Round ``index``: read its observation, step, write its outputs
        and the new carry, advance the index."""
        obs = Observation(**{name: buf.index_select(0, self.index)[0]
                             for name, buf in self.inputs.items()})
        new, out = self.step(self.carry, obs)
        if self.outs is None:
            self.outs = {k: torch.empty((self.capacity,) + tuple(v.shape),
                                        dtype=v.dtype, device=v.device)
                         for k, v in out.items()}
        for k, v in out.items():
            self.outs[k].index_copy_(0, self.index, v.unsqueeze(0))
        assign(self.leaves, tree_leaves(new))
        self.index.add_(1)

    def _warm_up_and_capture(self) -> None:
        """Run the current round for real on a side stream, then capture
        the round (the capture runs nothing)."""
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._round()
        main.wait_stream(side)
        before = collections.Counter(LAUNCHES)
        n_exchanges = len(COLLECTIVES)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # no cyclic collection while capturing: freeing another graph (or
        # anything that calls the CUDA API) mid-capture invalidates it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._round()
        except Exception as e:
            raise RuntimeError(
                "capturing the serving round failed: a round must make no "
                "host synchronisation and no host-to-device copy "
                "(ServeSession(capture=False) runs it uncaptured)") from e
        finally:
            if collecting:
                gc.enable()
            recorded = collections.Counter(LAUNCHES)
            recorded.subtract(before)
            LAUNCHES.clear()
            LAUNCHES.update(before)
            exchanges = COLLECTIVES[n_exchanges:]
            del COLLECTIVES[n_exchanges:]
        self.capture_s = time.perf_counter() - t0
        self.launches = +recorded
        self.collectives = exchanges
        self.graph = graph

    def run(self, stream: Observation) -> dict:
        """Serve the R <= capacity rounds of ``stream``; the per-round
        outputs stacked to (R, ...), copies the next run cannot touch."""
        n = stream.n_rounds
        if signature(stream) != self.signature or not 1 <= n <= self.capacity:
            raise ValueError("stream does not fit this round graph")
        for name, buf in self.inputs.items():
            buf[:n].copy_(getattr(stream, name))
        self.index.zero_()
        first = 0
        if self.capture and self.graph is None:
            self._warm_up_and_capture()
            first = 1
        for _ in range(first, n):
            if self.graph is None:
                self._round()
            else:
                self.graph.replay()
                LAUNCHES.update(self.launches)
                COLLECTIVES.extend(self.collectives)
                self.replays += 1
        return {k: v[:n].clone() for k, v in self.outs.items()}
