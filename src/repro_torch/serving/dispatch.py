"""Continuous-batching dispatch executor: token-level batching across tier
pools with measured feedback into the router — port of
``repro/serving/dispatch.py``, host Python whose logic is the reference's
line for line; the pools it drives are :mod:`repro_torch.serving.pools`.

The router (``ServeSession.run``) emits per-round solutions; this
module is the layer that *executes* them on live :class:`ModelPool` tiers.
Routed segments become :class:`Request`\\ s (stream id, tier, fidelity-sized
token prompt, enqueue time) on per-pool queues, and each pool runs an
admit → prefill → decode scheduling loop:

* **bucketed prefill** — pending requests batch by exact prompt length
  (fidelity sizes are discrete, so buckets are too) with the batch axis
  padded to a power of two; one bucket admits per scheduling step.
* **token-level decode** — ONE decode step advances *every* in-flight
  segment of the pool against a fixed cache-slot slab with per-slot
  progress; segments join the decode batch the step after their prefill and
  leave the step they finish, their slot returning to the free pool.
* **interleave** — every scheduling step first admits (if slots are free
  and requests are pending) then decodes, so a long decode never starves
  new arrivals and a deep queue never starves resident segments.

Scheduling invariant (asserted in tests): the oldest pending request is
always part of the next admitted prefill bucket — bounded wait, no
length-class starvation.

The executor measures what the router's Stage-2 assumes it knows: per-tier
sojourn (wait + service) EWMAs and token throughput.  :meth:`feedback`
exposes them as a per-tier multiplier ``bw_mult = service / sojourn``
(clipped to ``[floor, 1]``) — 1.0 when the pool keeps up, shrinking as
queueing dominates — which ``ServeSession.apply_feedback`` folds into the
next round's :class:`Observation` (``bw_mult`` for realization, and its
capacity-weighted twin ``bw_scale`` for the C6 repair budget), closing the
router ↔ serving loop.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.runtime.straggler import p99, quantile


def _host(x) -> np.ndarray:
    """A device tensor or array-like as a host numpy array."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@dataclasses.dataclass
class Request:
    """One routed segment's token workload."""
    stream: int                 # stream / slot-lane id (router's task index)
    tier: int                   # 0 = edge, 1 = cloud
    tokens: np.ndarray          # (n_prefill,) int32 prompt
    decode_tokens: int = 8
    enqueue_t: float = 0.0      # stamped at submit when left 0


@dataclasses.dataclass
class Completion:
    """A finished request plus its measured lifecycle."""
    stream: int
    tier: int
    ids: np.ndarray             # (decode_tokens,) int32 decoded ids
    n_prefill: int
    enqueue_t: float
    admit_t: float
    finish_t: float

    @property
    def wait_s(self) -> float:
        return self.admit_t - self.enqueue_t

    @property
    def service_s(self) -> float:
        return self.finish_t - self.admit_t

    @property
    def latency_s(self) -> float:
        return self.finish_t - self.enqueue_t

    @property
    def tokens(self) -> int:
        return self.n_prefill + len(self.ids)


@dataclasses.dataclass
class _Slot:
    req: Request
    admit_t: float
    ids: list               # decoded ids so far (first one from prefill)
    remaining: int          # decode steps still owed


def _bucket_pad(n: int, cap: int) -> int:
    """Smallest power of two >= n (capped): a few prefill batch shapes."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class PoolExecutor:
    """The admit→prefill→decode loop for ONE tier pool.

    Owns the pool's pending queue, the fixed cache-slot slab, and the
    per-slot bookkeeping.  ``step()`` is one scheduling iteration; the
    multi-tier :class:`DispatchExecutor` round-robins it across pools.
    """

    def __init__(self, pool, *, n_slots: int = 16, max_prefill_len: int = 48,
                 max_prefill_batch: int = 8, clock=time.perf_counter):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.pool = pool
        self.n_slots = n_slots
        self.max_prefill_len = max_prefill_len
        self.max_prefill_batch = max_prefill_batch
        self.clock = clock
        self.pending: deque[Request] = deque()
        self.slab = pool.make_slab(n_slots, max_prefill_len)
        self.slots: list[Optional[_Slot]] = [None] * n_slots
        self.last_ids = np.zeros((n_slots,), np.int32)
        self.completions: list[Completion] = []
        # admission trace for the no-starvation invariant: one entry per
        # prefill bucket, (admitted stream ids, oldest-pending stream id)
        self.admission_log: list[tuple[list, int]] = []
        # sojourn EWMAs feeding DispatchExecutor.feedback()
        self.wait_ewma = 0.0
        self.service_ewma = 0.0
        self._ewma_n = 0

    def reset_measurements(self):
        """Forget completed-request measurements (EWMAs, completions, the
        admission trace) — e.g. after a warm-up — without touching the
        queue, the slab, or in-flight segments."""
        self.completions.clear()
        self.admission_log.clear()
        self.wait_ewma = 0.0
        self.service_ewma = 0.0
        self._ewma_n = 0

    # -- queue --------------------------------------------------------------
    def submit(self, req: Request):
        n = int(np.asarray(req.tokens).shape[0])
        if n < 1 or n > self.max_prefill_len:
            raise ValueError(
                f"request prompt length {n} outside this executor's "
                f"1..{self.max_prefill_len} slab sizing")
        if req.decode_tokens < 1:
            raise ValueError("decode_tokens must be >= 1")
        if req.enqueue_t == 0.0:
            req.enqueue_t = self.clock()
        self.pending.append(req)

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def idle(self) -> bool:
        return not self.pending and self.n_active == 0

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    # -- scheduling ---------------------------------------------------------
    def step(self) -> bool:
        """One scheduling iteration: admit one prefill bucket (if slots are
        free), then one token-level decode step over the slab.  Returns
        whether any work was done."""
        did = False
        free = self._free_slots()
        if self.pending and free:
            self._admit(free)
            did = True
        if self.n_active:
            self._decode_step()
            did = True
        return did

    def drain(self, max_steps: int | None = None):
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

    def _admit(self, free: list[int]):
        """Admit the oldest pending request's length bucket: FIFO scan
        collecting same-length requests (other lengths keep their queue
        position), one prefill, scatter into the free slots."""
        want = min(len(free), self.max_prefill_batch)
        head_len = int(np.asarray(self.pending[0].tokens).shape[0])
        batch, keep = [], deque()
        while self.pending and len(batch) < want:
            req = self.pending.popleft()
            if int(np.asarray(req.tokens).shape[0]) == head_len:
                batch.append(req)
            else:
                keep.append(req)
        keep.extend(self.pending)
        self.pending = keep
        oldest = batch[0].stream
        slots = free[:len(batch)]

        b_pad = _bucket_pad(len(batch), self.max_prefill_batch)
        toks = np.zeros((b_pad, head_len), np.int32)
        for i, req in enumerate(batch):
            toks[i] = np.asarray(req.tokens, np.int32)
        ids, cache = self.pool.prefill_batch(torch.from_numpy(toks))
        self.slab = self.pool.insert_slab(self.slab, cache, slots)
        ids = _host(ids)
        now = self.clock()
        for i, (req, slot) in enumerate(zip(batch, slots)):
            first = int(ids[i])
            self.last_ids[slot] = first
            self.slots[slot] = _Slot(req=req, admit_t=now, ids=[first],
                                     remaining=req.decode_tokens - 1)
        self.admission_log.append(([r.stream for r in batch], oldest))
        # decode_tokens=1 segments are done at prefill (serial parity:
        # serve_segment's decode loop runs zero iterations)
        self._retire_finished(now)

    def _decode_step(self):
        """Advance every resident segment by one token; retire finishers."""
        ids, self.slab = self.pool.decode_slab(self.slab,
                                               torch.from_numpy(self.last_ids))
        ids = _host(ids)
        now = self.clock()
        for slot, st in enumerate(self.slots):
            if st is None or st.remaining == 0:
                continue
            tok = int(ids[slot])
            st.ids.append(tok)
            st.remaining -= 1
            self.last_ids[slot] = tok
        self._retire_finished(now)

    def _retire_finished(self, now: float):
        for slot, st in enumerate(self.slots):
            if st is None or st.remaining > 0:
                continue
            req = st.req
            comp = Completion(
                stream=req.stream, tier=req.tier,
                ids=np.asarray(st.ids, np.int32),
                n_prefill=int(np.asarray(req.tokens).shape[0]),
                enqueue_t=req.enqueue_t, admit_t=st.admit_t, finish_t=now)
            self.completions.append(comp)
            self.slots[slot] = None
            stats = self.pool.stats
            stats.requests += 1
            stats.tokens += comp.tokens
            stats.latencies.append(comp.latency_s)
            a = 2.0 / (self._ewma_n + 2)    # warmup-weighted EWMA
            self.wait_ewma += a * (comp.wait_s - self.wait_ewma)
            self.service_ewma += a * (comp.service_s - self.service_ewma)
            self._ewma_n += 1


class DispatchExecutor:
    """Continuous-batching executor over ALL tier pools.

    ``step()`` round-robins one scheduling iteration across the tiers so no
    pool serializes behind another; ``serve(requests)`` is the submit+drain
    convenience the session's ``dispatch`` shim calls.
    """

    def __init__(self, pools: dict, *, n_slots: int = 16,
                 max_prefill_len: int = 48, max_prefill_batch: int = 8,
                 feedback_floor: float = 0.25, clock=time.perf_counter):
        if not 0.0 < feedback_floor <= 1.0:
            raise ValueError(f"feedback_floor must be in (0, 1], "
                             f"got {feedback_floor}")
        self.pools = pools
        self.feedback_floor = feedback_floor
        self.execs = {
            tier: PoolExecutor(pool, n_slots=n_slots,
                               max_prefill_len=max_prefill_len,
                               max_prefill_batch=max_prefill_batch,
                               clock=clock)
            for tier, pool in pools.items()
        }

    def submit(self, requests):
        for req in requests:
            if req.tier not in self.execs:
                raise ValueError(
                    f"request for stream {req.stream} targets unknown tier "
                    f"{req.tier}; pools serve {sorted(self.execs)}")
            self.execs[req.tier].submit(req)

    @property
    def idle(self) -> bool:
        return all(ex.idle for ex in self.execs.values())

    def reset_measurements(self):
        for ex in self.execs.values():
            ex.reset_measurements()

    def step(self) -> bool:
        did = False
        for ex in self.execs.values():
            did |= ex.step()
        return did

    def drain(self, max_steps: int | None = None):
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

    def serve(self, requests) -> dict:
        """Submit + drain, returning the per-tier stats of THIS request set
        (completions recorded since the call began)."""
        marks = {t: len(ex.completions) for t, ex in self.execs.items()}
        self.submit(requests)
        self.drain()
        return {t: self._tier_stats(t, since=marks[t])
                for t in self.execs
                if len(self.execs[t].completions) > marks[t]}

    # -- measurement --------------------------------------------------------
    def _tier_stats(self, tier: int, since: int = 0) -> dict:
        comps = self.execs[tier].completions[since:]
        if not comps:
            return {"requests": 0, "tokens": 0}
        lat = [c.latency_s for c in comps]
        span = (max(c.finish_t for c in comps)
                - min(c.enqueue_t for c in comps))
        toks = sum(c.tokens for c in comps)
        return {
            "requests": len(comps),
            "tokens": toks,
            "tokens_per_s": toks / max(span, 1e-9),
            "p50_s": quantile(lat, 0.5),
            "p99_s": p99(lat),
            "mean_wait_s": float(np.mean([c.wait_s for c in comps])),
            "mean_service_s": float(np.mean([c.service_s for c in comps])),
        }

    def stats(self) -> dict:
        return {t: self._tier_stats(t) for t in self.execs}

    def feedback(self) -> dict:
        """Measured per-tier serving state for the router's next round.

        ``bw_mult[t] = clip(service / (service + wait), floor, 1)`` — the
        EWMA fraction of a request's sojourn spent actually being served.
        An unloaded pool reports 1.0 (the observation passes through
        unchanged); a pool whose queue dominates shrinks toward ``floor``,
        telling the router that tier's effective capacity is lower than
        nominal.  Tiers that never completed a request report 1.0 (no
        evidence, no adjustment).
        """
        tiers = sorted(self.execs)
        mult = np.ones((max(tiers) + 1,), np.float32) if tiers else \
            np.ones((2,), np.float32)
        per_tier = {}
        for t in tiers:
            ex = self.execs[t]
            if ex._ewma_n:
                sojourn = ex.service_ewma + ex.wait_ewma
                m = ex.service_ewma / max(sojourn, 1e-9)
                mult[t] = np.clip(m, self.feedback_floor, 1.0)
            per_tier[t] = {
                "bw_mult": float(mult[t]),
                "wait_ewma_s": ex.wait_ewma,
                "service_ewma_s": ex.service_ewma,
                "tokens_per_s": ex.pool.stats.tokens_per_s,
                "queue_depth": len(ex.pending),
                "in_flight": ex.n_active,
            }
        return {"bw_mult": mult, "per_tier": per_tier}


def serve_serial_oracle(pools: dict, requests, decode_tokens: int | None = None):
    """The serial reference execution of a request set: per tier, per prompt
    length, one :meth:`ModelPool.serve_segment` call in arrival order — no
    queueing, no interleave, no cross-batch token-level merge.  Returns
    {(stream) -> (decode ids)} so tests can assert the executor's outputs
    request-for-request, and the dispatch bench can measure the speedup
    against the exact same workload.
    """
    out = {}
    by_group: dict[tuple, list] = {}
    for req in requests:
        n = int(np.asarray(req.tokens).shape[0])
        by_group.setdefault((req.tier, n), []).append(req)
    for (tier, n), reqs in by_group.items():
        toks = torch.from_numpy(np.stack([np.asarray(r.tokens, np.int32)
                                          for r in reqs]))
        dt = decode_tokens if decode_tokens is not None \
            else reqs[0].decode_tokens
        ids = _host(pools[tier].serve_segment(toks, decode_tokens=dt))
        for i, r in enumerate(reqs):
            out[r.stream] = ids[i]
    return out
