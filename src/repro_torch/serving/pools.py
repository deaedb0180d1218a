"""Model pools: the edge and cloud tiers as live serving endpoints — port of
``repro/serving/pools.py``.

A pool owns one model (weights in the compute dtype on one device) and
serves token batches through two surfaces:

* :meth:`ModelPool.serve_segment` — the serial path (one prefill, then an
  eager decode loop per batch), the parity oracle of the executor;
* the cache-slot slab (:meth:`make_slab`, :meth:`prefill_batch`,
  :meth:`insert_slab`, :meth:`decode_slab`) that
  :mod:`repro_torch.serving.dispatch` schedules: ``n_slots`` cache rows
  with per-slot progress, so segments join and leave the decode batch
  between steps.  Where the reference donates the slab to a jitted update,
  the port writes the slab's tensors in place and returns the same slab.

On a CUDA device each prefill and each decode step runs, once per layer,
the kernel of that layer's mixer: ``flash_attention`` (prefill) or
``decode_attention`` (decode step) for an attention layer, ``mamba_scan``
for an SSM layer, ``rglru_scan`` for an RG-LRU layer (``force`` pins the
plain versions instead).  A MoE config's pool routes every token of a call
(bucket padding rows and inactive slab slots included, as the reference)
through its experts with the capacity of that call.

A pool serves token ids; a config whose front end feeds embeddings
(``embed_inputs=False``: Qwen2-VL-2B, MusicGen-medium) has no token table,
and building its pool raises: such models are driven through
``models.model.prefill`` / ``decode_step`` with ``{"embeddings": ...}``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.model import (
    cache_specs,
    check_supported,
    decode_step,
    model_specs,
    prefill,
)
from repro_torch.models.params import init_params, tree_map
from repro_torch.runtime.straggler import p99, quantile


@dataclasses.dataclass
class PoolStats:
    """Counters plus per-request latency samples (seconds; enqueue→finish
    on the executor, batch wall time on the serial path).  ``prefills`` and
    ``decode_steps`` count the model calls, so a run can check the
    kernels' launches against layers × calls."""
    requests: int = 0
    tokens: int = 0
    busy_s: float = 0.0
    prefills: int = 0
    decode_steps: int = 0
    latencies: list = dataclasses.field(default_factory=list)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.busy_s, 1e-9)

    def p50_s(self) -> float:
        return quantile(self.latencies, 0.5) if self.latencies else 0.0

    def p99_s(self) -> float:
        return p99(self.latencies) if self.latencies else 0.0

    def summary(self) -> dict:
        return {"requests": self.requests, "tokens": self.tokens,
                "busy_s": self.busy_s, "tokens_per_s": self.tokens_per_s,
                "p50_s": self.p50_s(), "p99_s": self.p99_s()}


def _argmax_ids(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


class ModelPool:
    """One tier's model.  ``generator`` (on ``device``) draws the random
    weights; ``params`` instead shares an existing pool's weights (e.g. a
    plain-path pool beside a kernel-path one, without a second copy)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None
                 = None, name: str = "pool", *, device="cuda",
                 force: str = "auto", params=None):
        check_supported(cfg)
        if not cfg.embed_inputs:
            raise ValueError(
                f"{cfg.name}: its front end feeds embeddings "
                "(embed_inputs=False) and it has no token table, so a pool "
                "cannot serve token ids; drive it through models.model."
                "prefill / decode_step with {'embeddings': (B, S, d)}")
        self.cfg = cfg
        self.name = name
        self.device = resolve_device(device)
        self.ctx = Ctx(cfg=cfg, force=force)
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = init_params(model_specs(cfg), generator, self.device,
                                 self.ctx.compute_dtype)
        self.params = params
        self.stats = PoolStats()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tokens(self, tokens):
        return torch.as_tensor(tokens, device=self.device).long()

    def serve_segment(self, tokens, decode_tokens: int = 8):
        """Prefill a (B, S) token batch, then decode; returns the (B,
        decode_tokens) int32 ids (the first from the prefill)."""
        t0 = time.perf_counter()
        tokens = self._tokens(tokens)
        b, s = tokens.shape
        if b == 0:
            # a fully drained tier is a legal dispatch: serve nothing
            return torch.zeros((0, decode_tokens), dtype=torch.int32,
                               device=self.device)
        logits, cache = prefill(self.ctx, self.params, {"tokens": tokens})
        self.stats.prefills += 1
        out = [_argmax_ids(logits)]
        for _ in range(decode_tokens - 1):
            logits, cache = decode_step(self.ctx, self.params, cache,
                                        {"tokens": out[-1][:, None].long()})
            self.stats.decode_steps += 1
            out.append(_argmax_ids(logits))
        self._sync()
        dt = time.perf_counter() - t0
        self.stats.requests += b
        self.stats.tokens += b * (s + decode_tokens)
        self.stats.busy_s += dt
        self.stats.latencies.extend([dt] * b)
        return torch.stack(out, dim=1)

    # -- continuous-batching slab entry points ------------------------------
    def make_slab(self, n_slots: int, max_prefill_len: int):
        """``n_slots`` zeroed cache rows sized for prompts up to
        ``max_prefill_len`` tokens plus the decode headroom, with a (n_slots,)
        per-slot ``length``."""
        specs = cache_specs(self.cfg, n_slots, max_prefill_len)
        slab = {"segments": tree_map(
            lambda sp: torch.zeros(sp.shape, dtype=getattr(torch, sp.dtype),
                                   device=self.device), specs["segments"])}
        slab["length"] = torch.zeros((n_slots,), dtype=torch.int32,
                                     device=self.device)
        return slab

    def prefill_batch(self, tokens):
        """Prefill one bucketed batch -> (first ids (B,), its fresh cache)."""
        t0 = time.perf_counter()
        logits, cache = prefill(self.ctx, self.params,
                                {"tokens": self._tokens(tokens)})
        ids = _argmax_ids(logits)
        self._sync()
        self.stats.prefills += 1
        self.stats.busy_s += time.perf_counter() - t0
        return ids, cache

    def insert_slab(self, slab, cache, slots):
        """Copy ``cache``'s first ``len(slots)`` rows into the slab's slots,
        in place.  Leaves carry the stacked layer axis in front, so the
        request axis is axis 1; each axis from 2 on of a cache leaf may be
        shorter than the slab's and is zero-padded, as in the reference: the
        K/V leaves' sequence axis (a shorter prompt; entries past the
        slot's length, which decode attention masks), while the recurrent
        leaves — ``conv`` (L, B, K-1, C), SSM ``h`` (L, B, Di, N), RG-LRU
        ``h`` (L, B, W) — match the slab's and are copied whole.  Rows past
        ``len(slots)`` are bucket padding and are dropped."""
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        n_real = idx.shape[0]

        def put(sl, cl):
            cl, pad = cl[:, :n_real], []
            for have, want in zip(reversed(cl.shape[2:]),
                                  reversed(sl.shape[2:])):
                pad += [0, want - have]
            sl[:, idx] = torch.nn.functional.pad(cl, pad) if any(pad) else cl
        tree_map(put, slab["segments"], cache["segments"])
        slab["length"][idx] = cache["length"].to(torch.int32)
        return slab

    def decode_slab(self, slab, last_ids):
        """One decode step over the whole slab: every slot advances one
        token against its own progress.  Returns ((n_slots,) next ids, the
        slab, written in place, with its lengths advanced).  Inactive slots
        compute values the executor ignores."""
        t0 = time.perf_counter()
        last = torch.as_tensor(last_ids, device=self.device).long()
        logits, slab = decode_step(self.ctx, self.params, slab,
                                   {"tokens": last[:, None]})
        ids = _argmax_ids(logits)
        self._sync()
        self.stats.decode_steps += 1
        self.stats.busy_s += time.perf_counter() - t0
        return ids, slab


def make_tier_pools(edge_cfg: ModelConfig, cloud_cfg: ModelConfig, *,
                    device="cuda", force: str = "auto"):
    """Tier 0 (edge) and tier 1 (cloud), weights drawn from generators
    seeded 1 and 2 on ``device`` (the reference's PRNGKey(1) / (2))."""
    dev = resolve_device(device)
    return {
        0: ModelPool(edge_cfg, torch.Generator(dev).manual_seed(1),
                     name="edge", device=dev, force=force),
        1: ModelPool(cloud_cfg, torch.Generator(dev).manual_seed(2),
                     name="cloud", device=dev, force=force),
    }
