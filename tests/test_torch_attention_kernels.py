"""The port's attention on the CPU against the JAX package, on identical
numpy inputs:

* the plain versions of the two attention kernels
  (``repro_torch.kernels.{flash,decode}_attention``) against the reference's
  ``ref.py`` oracles and its Pallas kernels in interpret mode (on the shapes
  the Pallas kernels take: tile multiples), and against the oracles alone at
  ragged lengths;
* the model's plain attention (``repro_torch.models.attention``
  ``chunked_attention`` / ``decode_attention``) against the reference
  model's jnp functions.

Tolerances: float32 2e-5 absolute and relative (sums in another order);
bfloat16 2e-2 (one or two bf16 ulps of outputs near 1), as the reference's
own kernel tests.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax.numpy as jnp
from repro.kernels.decode_attention.kernel import decode_attention as j_decode_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref as j_decode_ref
from repro.kernels.flash_attention.kernel import flash_attention as j_flash_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_flash_ref
from repro.models.attention import chunked_attention as j_chunked
from repro.models.attention import decode_attention as j_model_decode
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.attention import chunked_attention, decode_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, dtype, *shapes):
    """numpy normals rounded to ``dtype``, as (jax, torch) pairs."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = rng.normal(size=shape).astype(np.float32)
        a = np.array(jnp.asarray(a, jdt).astype(jnp.float32))
        out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return out


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


# ---------------------------------------------------------------------------
# Kernel plain versions vs the reference oracles and Pallas (interpret)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,d,window,causal", [
    (2, 4, 4, 64, 16, None, True),      # G = 1 (MHA, the edge tier)
    (1, 8, 2, 64, 32, None, True),      # G = 4 (GQA, the cloud tier)
    (2, 8, 2, 64, 16, 20, True),        # sliding window
    (1, 4, 1, 64, 16, None, False),     # non-causal MQA
])
def test_flash_plain_matches_reference_and_pallas(dtype, b, h, kv, s, d,
                                                  window, causal):
    (jq, q), (jk, k), (jv, v) = _inputs(s + d, dtype, (b, h, s, d),
                                        (b, kv, s, d), (b, kv, s, d))
    got = flash_ops.flash_attention(q, k, v, window=window, causal=causal)
    _close(got, j_flash_ref(jq, jk, jv, window=window, causal=causal), dtype)
    pallas = j_flash_pallas(jq, jk, jv, window=window, causal=causal,
                            block_q=32, block_k=32, interpret=True)
    _close(got, pallas, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,window,causal", [
    (37, 37, None, True),      # not a tile multiple
    (5, 70, None, False),      # Sq < Sk
    (70, 45, 30, False),       # Sq > Sk, non-causal window
    (48, 48, 7, True),         # window narrower than a tile
])
def test_flash_plain_ragged_lengths(dtype, sq, sk, window, causal):
    (jq, q), (jk, k), (jv, v) = _inputs(sq * sk, dtype, (2, 8, sq, 16),
                                        (2, 2, sk, 16), (2, 2, sk, 16))
    got = flash_ops.flash_attention(q, k, v, window=window, causal=causal)
    _close(got, j_flash_ref(jq, jk, jv, window=window, causal=causal), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,d", [
    (4, 4, 4, 64, 16),      # G = 1
    (3, 8, 2, 64, 32),      # G = 4
    (2, 8, 1, 96, 16),      # MQA
])
def test_decode_plain_matches_reference_and_pallas(dtype, b, h, kv, s, d):
    (jq, q), (jk, k), (jv, v) = _inputs(b * s + d, dtype, (b, h, d),
                                        (b, kv, s, d), (b, kv, s, d))
    lengths = np.random.default_rng(b).integers(1, s + 1, b).astype(np.int32)
    lengths[0], lengths[-1] = 1, s
    got = decode_ops.decode_attention(q, k, v, torch.from_numpy(lengths))
    jl = jnp.asarray(lengths)
    _close(got, j_decode_ref(jq, jk, jv, jl), dtype)
    _close(got, j_decode_pallas(jq, jk, jv, jl, block_s=32, interpret=True),
           dtype)


def test_plain_versions_run_uncounted_and_pins_hold():
    (_, q), (_, k), (_, v) = _inputs(0, "float32", (1, 4, 8, 16),
                                     (1, 2, 8, 16), (1, 2, 8, 16))
    length = torch.tensor([3], dtype=torch.int32)
    reset_launch_counts()
    for force in ("auto", "ref"):
        flash_ops.flash_attention(q, k, v, force=force)
        decode_ops.decode_attention(q[:, :, 0], k, v, length, force=force)
    assert launch_counts() == {}
    torch.testing.assert_close(flash_ops.flash_attention(q, k, v),
                               attention_ref(q, k, v))
    torch.testing.assert_close(
        decode_ops.decode_attention(q[:, :, 0], k, v, length),
        decode_attention_ref(q[:, :, 0], k, v, length))


# ---------------------------------------------------------------------------
# The model's plain attention vs the reference model's jnp functions
# q: (B, S, H, D), k/v: (B, S, KV, D)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kv,chunk,window", [
    (40, 4, 4, 16, None),    # padded to chunk multiples, three k chunks
    (32, 8, 2, 16, None),
    (30, 8, 2, 8, 6),        # window: the reference gathers, the port masks
])
def test_model_chunked_attention_matches_reference(dtype, s, h, kv, chunk,
                                                   window):
    (jq, q), (jk, k), (jv, v) = _inputs(s * h, dtype, (2, s, h, 16),
                                        (2, s, kv, 16), (2, s, kv, 16))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    kw = dict(window=window, q_chunk=chunk, k_chunk=chunk)
    # with the window the reference takes its O(S·W) gather: the same
    # function, normalised before the P·V product instead of after it
    want = j_chunked(jq, jk, jv, jnp.asarray(pos), **kw)
    got = chunked_attention(q, k, v, torch.from_numpy(pos.copy()), **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_row", [True, False])
def test_model_decode_attention_matches_reference(dtype, per_row):
    b, s, h, kv, d = 4, 40, 8, 2, 16
    (jq, q), (jk, k), (jv, v) = _inputs(7, dtype, (b, 1, h, d),
                                        (b, s, kv, d), (b, s, kv, d))
    length = (np.array([1, 17, 40, 55], np.int32) if per_row
              else np.int32(23))
    want = j_model_decode(jq, jk, jv, length=jnp.asarray(length))
    got = decode_attention(q, k, v, length=torch.from_numpy(np.array(length)))
    _close(got, want, dtype)
