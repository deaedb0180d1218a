"""M-RoPE, the embedding-input front end and position-masked attention of
the port against the live JAX package on identical numpy inputs.

* ``apply_mrope`` against the reference's: the same angles (an index
  where the reference sums a one-hot, exact), cos and sin of two libraries:
  within 2e-6 absolute.
* Qwen2-VL-2B SMOKE (M-RoPE, embeddings in) through a prefill at Qwen2-VL's
  image-grid positions, then decode steps with explicit (B, 3, 1)
  positions; MusicGen-medium SMOKE (embeddings in, default positions):
  float32 compute, logits within 1e-4 and caches within 1e-5 (the
  tolerances of ``test_torch_model.py``).
* ``attention_ref(positions=)`` against the reference's
  ``chunked_attention`` over full blocks (its mask by positions alone), and
  the plain ``chunked_attention`` against it at chunks of 16 (with a window
  that binds, both gather each q chunk's key span by index, which agrees
  with the mask by positions only where positions follow the index): float32
  2e-5, bfloat16 2e-2 (``test_torch_attention_kernels``).
* The windowed prefill (``_windowed_blocks``, where ``sk > window +
  q_chunk``) in bfloat16 at S = 64, window 16, chunk 16: equal to the JAX
  function bit for bit (before the port took that path, 3,964 of 8,192
  entries differed, by up to 0.0078).
* The kernels' branch: positions that the caller passes reach
  ``flash_attention``; positions that ``forward`` builds do not.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import collections
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config as j_smoke
from repro.models import Ctx as JCtx
from repro.models import decode_step as j_decode_step
from repro.models import model_specs as j_model_specs
from repro.models import prefill as j_prefill
from repro.models.attention import chunked_attention as j_chunked
from repro.models.layers import apply_mrope as j_apply_mrope
from repro.models.params import init_params as j_init_params
from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_numpy, tree_to_numpy
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.attention import chunked_attention
from repro_torch.models.layers import Ctx, apply_mrope, mrope_positions
from repro_torch.models.model import decode_step, prefill
from repro_torch.models.params import tree_map
from repro_torch.serving.pools import ModelPool

FRONT_ENDS = ("qwen2-vl-2b", "musicgen-medium")
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rounded(rng, shape, dtype):
    """numpy normals rounded to ``dtype`` (as float32), for both sides."""
    a = rng.normal(size=shape).astype(np.float32)
    return np.array(jnp.asarray(a, DTYPES[dtype][0]).astype(jnp.float32))


def _positions(layout, b, s, seed=0):
    """(B, S) int32: Qwen2-VL's temporal stream (S = 80), a random
    permutation per row, or each position repeated three times."""
    if layout == "qwen2vl":
        return mrope_positions(16, (2, 4, 4), s - 48, b)[:, 0].numpy()
    if layout == "shuffled":
        rng = np.random.default_rng(seed)
        return np.stack([rng.permutation(s) for _ in range(b)]).astype(
            np.int32)
    return np.broadcast_to(np.arange(s, dtype=np.int32) // 3, (b, s)).copy()


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,sections,theta", [(16, (2, 3, 3), 10000.0),
                                              (128, (16, 24, 24), 1e6)])
def test_apply_mrope_matches_reference(d, sections, theta):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 80, 3, d)).astype(np.float32)
    pos = np.concatenate([mrope_positions(16, (2, 4, 4), 32, 1).numpy(),
                          rng.integers(0, 4000, (1, 3, 80)).astype(
                              np.int32)])
    want = np.asarray(j_apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta,
                                    sections))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta,
                      sections)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="sum"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta,
                    (1, 1, 1))


def test_mrope_positions_follow_qwen2_vl_layout():
    pos = mrope_positions(2, (2, 2, 3), 2, batch=2)
    assert pos.shape == (2, 3, 16) and pos.dtype == torch.int32
    t, h, w = pos[0].tolist()
    assert t == [0, 1] + [2] * 6 + [3] * 6 + [5, 6]
    assert h == [0, 1] + [2, 2, 2, 3, 3, 3] * 2 + [5, 6]
    assert w == [0, 1] + [2, 3, 4] * 4 + [5, 6]


# ---------------------------------------------------------------------------
# The front-end models, prefill then decode
# ---------------------------------------------------------------------------
def _front_end_runs(arch, explicit, ctx_kw=None, b=3, steps=3):
    """Both packages through a prefill of seeded embeddings (B, 80) and
    ``steps`` decode steps of seeded (B, 1, d) embeddings; ``explicit``:
    Qwen2-VL's image-grid positions, then (B, 3, 1) text positions after
    them.  Returns (port, reference) pairs."""
    jcfg = dataclasses.replace(j_smoke(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jp = jax.tree_util.tree_map(np.asarray, j_init_params(
        j_model_specs(jcfg), jax.random.PRNGKey(5)))
    p = model_params_from_numpy(jp, cfg, "cpu")
    jctx, ctx = JCtx(cfg=jcfg), Ctx(cfg=cfg, **(ctx_kw or {}))
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(b, 80, cfg.d_model)).astype(np.float32)
    batch = {"embeddings": emb}
    if explicit:
        batch["positions"] = mrope_positions(16, (2, 4, 4), 32, b).numpy()
    jl, jc = j_prefill(jctx, jax.tree_util.tree_map(jnp.asarray, jp),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = prefill(ctx, p, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    pairs = [("prefill", tl, jl), ("prefill cache", tree_to_numpy(tc), jc)]
    nxt = int(batch["positions"].max()) + 1 if explicit else None
    for step in range(steps):
        batch = {"embeddings": rng.normal(size=(b, 1, cfg.d_model)).astype(
            np.float32)}
        if explicit:
            batch["positions"] = np.full((b, 3, 1), nxt + step, np.int32)
        jl, jc = j_decode_step(jctx, jax.tree_util.tree_map(jnp.asarray, jp),
                               jc, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tl, tc = decode_step(ctx, p, tc, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        pairs += [(f"decode {step}", tl, jl),
                  (f"decode {step} cache", tree_to_numpy(tc), jc)]
    return pairs


def _check_pairs(pairs):
    for what, got, want in pairs:
        if isinstance(got, dict):
            np.testing.assert_array_equal(got["length"],
                                          np.asarray(want["length"]))
            tree_map(lambda g, w: np.testing.assert_allclose(
                g, np.asarray(w), rtol=0, atol=1e-5, err_msg=what),
                got["segments"], want["segments"])
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-4, err_msg=what)


@pytest.mark.parametrize("arch,explicit", [("qwen2-vl-2b", True),
                                           ("qwen2-vl-2b", False),
                                           ("musicgen-medium", False)])
def test_front_end_prefill_and_decode_match_reference(arch, explicit):
    _check_pairs(_front_end_runs(arch, explicit))


@pytest.mark.parametrize("explicit", [True, False])
def test_kernel_branch_takes_the_callers_positions(monkeypatch, explicit):
    """On the kernels' branch (stood in for by the plain versions here) a
    Qwen2-VL prefill passes the caller's positions, the temporal stream as
    int (B, S), to ``flash_attention`` once a layer, and ``forward``'s own
    arange as none (the index launch); the decode steps launch
    ``decode_attention`` once a layer; the model still matches the
    reference."""
    calls = collections.Counter()
    cfg = get_smoke_config("qwen2-vl-2b")

    def flash(q, k, v, *, window=None, causal=True, positions=None,
              force="auto"):
        assert force == "kernel" and causal
        assert (positions is not None) == explicit
        if explicit:
            assert positions.shape == (q.shape[0], q.shape[2])
            assert not positions.is_floating_point()
        calls["flash_attention"] += 1
        return attention_ref(q, k, v, window=window, causal=causal,
                             positions=positions)

    def decode(q, k_cache, v_cache, length, *, force="auto"):
        assert force == "kernel"
        calls["decode_attention"] += 1
        return decode_attention_ref(q, k_cache, v_cache, length)

    monkeypatch.setattr(_build, "dispatch", lambda name, force, dev: True)
    monkeypatch.setattr(flash_ops, "flash_attention", flash)
    monkeypatch.setattr(decode_ops, "decode_attention", decode)
    _check_pairs(_front_end_runs("qwen2-vl-2b", explicit,
                                 ctx_kw={"force": "kernel"}, steps=2))
    assert calls == {"flash_attention": cfg.num_layers,
                     "decode_attention": 2 * cfg.num_layers}


@pytest.mark.parametrize("arch", FRONT_ENDS)
def test_pool_refuses_an_embedding_input_model(arch):
    """The reference's pool cannot serve a model without a token table
    either; the port says how such a model is driven."""
    with pytest.raises(ValueError, match="embeddings"):
        ModelPool(get_smoke_config(arch), device="cpu")


# ---------------------------------------------------------------------------
# Attention at runtime positions, and the windowed prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,d,window,layout", [
    (2, 12, 2, 80, 16, None, "qwen2vl"),
    (2, 12, 2, 80, 16, 16, "qwen2vl"),
    (2, 4, 2, 40, 8, 12, "shuffled"),
    (1, 4, 4, 48, 16, None, "repeats"),
])
def test_attention_at_positions_matches_reference(dtype, b, h, kv, s, d,
                                                  window, layout):
    """``attention_ref(positions=)`` (one softmax over all keys, also
    through the kernel's wrapper on the CPU) against the reference model's
    ``chunked_attention`` over full blocks (chunks of S: the mask by
    positions alone); the plain ``chunked_attention`` against the
    reference's at chunks of 16, which with a window that binds gathers
    each q chunk's key span by index, as the reference does."""
    rng = np.random.default_rng(s + d)
    q, k, v = (_rounded(rng, (b, s, n, d), dtype) for n in (h, kv, kv))
    pos = _positions(layout, b, s, seed=s)
    jdt, tdt = DTYPES[dtype]

    def reference(chunk):
        return np.asarray(j_chunked(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(pos),
            window=window, q_chunk=chunk, k_chunk=chunk)).astype(np.float32)

    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    want = reference(s)
    for got in (attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), window=window,
                              positions=tpos),
                flash_ops.flash_attention(tq.transpose(1, 2),
                                          tk.transpose(1, 2),
                                          tv.transpose(1, 2), window=window,
                                          positions=tpos)):
        np.testing.assert_allclose(got.transpose(1, 2).float().numpy(), want,
                                   **TOL[dtype])
    got = chunked_attention(tq, tk, tv, tpos, window=window, q_chunk=16,
                            k_chunk=16)
    np.testing.assert_allclose(got.float().numpy(), reference(16),
                               **TOL[dtype])


def test_attention_ref_positions_need_causal_self_attention():
    q = torch.zeros((1, 2, 8, 8))
    pos = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="Sq = Sk"):
        attention_ref(q, q[:, :, :4], q[:, :, :4], positions=pos)
    with pytest.raises(ValueError, match="causal"):
        attention_ref(q, q, q, causal=False, positions=pos)


@pytest.mark.parametrize("window,layout", [(16, "arange"), (16, "repeats"),
                                           (5, "arange"), (20, "shuffled")])
def test_windowed_prefill_equals_reference_in_bf16(window, layout):
    """B = 2, S = 64, H = 4, KV = 2, D = 16, chunks of 16: with a window
    that binds (64 > window + 16) both packages take the windowed path,
    one softmax over each q chunk's key span normalised before the product
    with v; in bfloat16 the outputs are equal bit for bit."""
    rng = np.random.default_rng(window)
    q, k, v = (_rounded(rng, (2, 64, n, 16), "bfloat16") for n in (4, 2, 2))
    pos = (np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64)).copy()
           if layout == "arange" else _positions(layout, 2, 64, seed=1))
    want = np.asarray(j_chunked(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(pos),
        window=window, q_chunk=16, k_chunk=16)).astype(np.float32)
    got = chunked_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                              for a in (q, k, v)), torch.from_numpy(pos),
                            window=window, q_chunk=16, k_chunk=16)
    np.testing.assert_array_equal(got.float().numpy(), want)
