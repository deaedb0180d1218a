"""Synthetic LM token pipeline: port of ``repro/data/tokens.py``.

Zipf-distributed tokens whose second half repeats the first, so a small
model has something learnable (copy heads).  Batches are numpy arrays
drawn from ``np.random.default_rng(seed)`` exactly as the reference draws
them, so both packages train on equal batches; the trainer moves them to
its device.
"""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, d_model: int = 0, embed_inputs: bool = True,
                 mrope: bool = False):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        self.d_model = d_model
        self.embed_inputs = embed_inputs
        self.mrope = mrope

    def _sample_tokens(self):
        b, s, v = self.batch, self.seq + 1, self.vocab
        base = self.rng.zipf(1.3, (b, s)).astype(np.int64) % v
        # repeated n-gram structure: second half repeats the first half
        half = s // 2
        base[:, half:half * 2] = base[:, :half]
        return base.astype(np.int32)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        """{tokens (B, S) int32 or embeddings (B, S, d) float32, labels
        (B, S) int32, positions (B, S), or (B, 3, S) for M-RoPE, int32}."""
        toks = self._sample_tokens()
        batch = {}
        pos = np.broadcast_to(np.arange(self.seq, dtype=np.int32),
                              (self.batch, self.seq))
        if self.embed_inputs:
            batch["tokens"] = toks[:, :-1]
        else:
            batch["embeddings"] = self.rng.normal(
                0, 1, (self.batch, self.seq, self.d_model)).astype(np.float32)
        batch["labels"] = toks[:, 1:]
        if self.mrope:
            batch["positions"] = np.broadcast_to(
                pos[:, None, :], (self.batch, 3, self.seq)).copy()
        else:
            batch["positions"] = pos.copy()
        return batch
