"""The attention's gradient on the plain path against the live JAX package.

``attention_vjp_ref`` (the plain version of the ``flash_attention_bwd``
kernel) and ``FlashAttentionFn`` pinned to the plain versions
(``force="ref"``) against ``jax.vjp`` of the reference model's
``chunked_attention`` and of the reference kernel's oracle
(``repro/kernels/flash_attention/ref.py``), for each mask mode the kernel
takes: causal, a window (the reference model's windowed block path and
its full one), non-causal cross-attention, and runtime positions (shuffled,
with and without a window).  GQA with G = 3; float32 inputs from seeded
numpy; every gradient within 1e-5 of max(1, its largest |entry|) (sums in
another order: measured ~1e-7).  The plain row log-sum-exp
(``attention_lse_ref``, what the forward's training launch stores for the
backward) against ``jax.nn.logsumexp`` of the same scores built in jnp, for
the same mask modes, within 1e-5 of max(1, |entry|); ``FlashAttentionFn``
on the plain path saves it in log2 units, as the kernel path does.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
import jax.numpy as jnp
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models.attention import chunked_attention as j_chunked
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention.ops import (
    LOG2E,
    FlashAttentionFn,
    flash_attention_autograd,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_lse_ref,
    attention_vjp_ref,
)

TOL = 1e-5
B, H, KV, D = 2, 6, 2, 16


def _inputs(sq, sk, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    return n(B, sq, H, D), n(B, sk, KV, D), n(B, sk, KV, D), n(B, sq, H, D)


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g.detach().numpy() - w).max()
        assert err <= TOL * max(1.0, float(np.abs(w).max())), err


def _port(q, k, v, do, **kw):
    """Both port paths in the reference model's (B, S, heads, D) layout:
    (attention_vjp_ref's gradients, FlashAttentionFn's)."""
    t = lambda x: torch.from_numpy(x).transpose(1, 2)
    direct = attention_vjp_ref(t(q), t(k), t(v), t(do), **kw)
    leaves = [t(x).detach().requires_grad_(True) for x in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, kw.get("positions"),
                                 kw.get("window"), kw.get("causal", True),
                                 "ref")
    out.backward(t(do))
    back = lambda x: x.transpose(1, 2)
    return ([back(g) for g in direct], [back(x.grad) for x in leaves])


MODEL_CASES = {
    "causal": dict(s=24, window=None, shuffled=False),
    "window_full_blocks": dict(s=24, window=12, shuffled=False),
    "window_windowed_blocks": dict(s=24, window=5, shuffled=False),
    "positions": dict(s=20, window=None, shuffled=True),
    # positions with a window on the full-block path: the reference's
    # windowed path gathers each q chunk's key span by index, which holds
    # only where positions follow the index
    "positions_window": dict(s=16, window=8, shuffled=True),
}


@pytest.mark.parametrize("case", MODEL_CASES)
def test_vjp_matches_the_reference_model(case):
    c = MODEL_CASES[case]
    s, window = c["s"], c["window"]
    q, k, v, do = _inputs(s, s)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
    if c["shuffled"]:
        rng = np.random.default_rng(1)
        pos = np.stack([rng.permutation(s) for _ in range(B)]).astype(
            np.int32)
    _, vjp = jax.vjp(lambda a, b, c_: j_chunked(
        a, b, c_, jnp.asarray(pos), window=window, q_chunk=8, k_chunk=8),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    kw = {"window": window}
    if c["shuffled"]:
        kw["positions"] = torch.from_numpy(pos)
    for got in _port(q, k, v, do, **kw):
        _close(got, want)


@pytest.mark.parametrize("sq,sk,window,causal", [
    (16, 16, None, True), (16, 16, 4, True), (5, 12, None, False),
    (12, 12, 3, False)])
def test_vjp_matches_the_reference_oracle(sq, sk, window, causal):
    q, k, v, do = _inputs(sq, sk, seed=2)
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    _, vjp = jax.vjp(lambda a, b, c: j_attention_ref(
        a, b, c, window=window, causal=causal), tr(q), tr(k), tr(v))
    want = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(tr(do))]
    for got in _port(q, k, v, do, window=window, causal=causal):
        _close(got, want)


def test_autograd_on_the_cpu_runs_the_plain_versions_uncounted():
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2)
                   for x in _inputs(10, 10, seed=3))
    reset_launch_counts()
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    flash_attention_autograd(*leaves, window=4).backward(do)
    want = flash_attention_bwd(q, k, v, None, do, window=4)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)
    assert launch_counts() == {}
    with pytest.raises(ValueError, match="force='kernel'"):
        flash_attention_autograd(*leaves, force="kernel")


LSE_CASES = {
    "causal": dict(sq=16, sk=16, window=None, causal=True, shuffled=False),
    "window": dict(sq=16, sk=16, window=5, causal=True, shuffled=False),
    "non_causal": dict(sq=5, sk=12, window=None, causal=False,
                       shuffled=False),
    "non_causal_window": dict(sq=12, sk=12, window=3, causal=False,
                              shuffled=False),
    "positions": dict(sq=20, sk=20, window=None, causal=True, shuffled=True),
    "positions_window": dict(sq=16, sk=16, window=8, causal=True,
                             shuffled=True),
}


@pytest.mark.parametrize("case", LSE_CASES)
def test_lse_matches_jax_logsumexp(case):
    c = LSE_CASES[case]
    sq, sk, window, causal = c["sq"], c["sk"], c["window"], c["causal"]
    q, k, v, _ = _inputs(sq, sk, seed=4)
    # the scores in jnp, heads grouped as the port groups them
    qj = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(B, KV, H // KV, sq, D)
    kj = jnp.asarray(k).transpose(0, 2, 1, 3)
    s = jnp.einsum("bkgqd,bksd->bkgqs", qj, kj) * D ** -0.5
    kw = {"window": window, "causal": causal}
    if c["shuffled"]:
        rng = np.random.default_rng(5)
        pos = np.stack([rng.permutation(sq) for _ in range(B)]).astype(
            np.int32)
        kw["positions"] = torch.from_numpy(pos)
        q_pos, k_pos = pos[:, None, None, :, None], pos[:, None, None, None, :]
    else:
        q_pos, k_pos = np.arange(sq)[:, None], np.arange(sk)[None, :]
    mask = np.ones(np.broadcast_shapes(q_pos.shape, k_pos.shape), bool)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    want = np.asarray(jax.nn.logsumexp(
        jnp.where(jnp.asarray(mask), s, -1e30), axis=-1)).reshape(B, H, sq)
    t = lambda x: torch.from_numpy(x).transpose(1, 2)
    got = attention_lse_ref(t(q), t(k), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, sq)
    err = np.abs(got.numpy() - want)
    assert (err <= TOL * np.maximum(1.0, np.abs(want))).all(), err.max()
    # the plain path's training launch saves it in the kernels' log2 units
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, kw.get("positions"), window,
                                 causal, "ref")
    saved = out.grad_fn.saved_tensors[5]
    assert torch.equal(saved, got * LOG2E)
