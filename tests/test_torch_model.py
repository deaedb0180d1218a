"""The port's tier models against the live JAX models on the same weights
(the reference's ``init_params``, converted with ``model_params_from_numpy``),
for both tier SMOKE configs: Qwen1.5-0.5B's (MHA, QKV bias) and Qwen3-8B's
(GQA, qk-norm).

A prefill of two prompt-length buckets, their caches scattered into a
cache-slot slab with per-row lengths (one slot left empty), then four
decode steps over the whole slab, teacher-forced with the reference's
greedy ids.  In float32 compute the logits must agree to 1e-4 (sums in
another order: measured ~1e-6) and the caches to 1e-5; in bfloat16 the
logits to 0.1 (the two frameworks round at other places; measured ~0.03).
Greedy ids must be equal wherever the reference's top-2 logit margin
exceeds that tolerance; lanes under it are counted and reported.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config as j_smoke
from repro.models import Ctx as JCtx
from repro.models import cache_specs as j_cache_specs
from repro.models import decode_step as j_decode_step
from repro.models import model_specs as j_model_specs
from repro.models import prefill as j_prefill
from repro.models.params import init_params as j_init_params
from repro.models.params import tree_map_specs as j_tree_map_specs
from repro.serving.pools import _insert_slab_impl as j_insert_slab
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import (
    cache_from_numpy,
    model_params_from_numpy,
    tree_to_numpy,
)
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import Ctx
from repro_torch.models.model import decode_step, model_specs, prefill
from repro_torch.models.params import (
    count_params,
    init_params,
    tree_leaves,
    tree_map,
)
from repro_torch.serving.pools import ModelPool

TIERS = ("qwen1.5-0.5b", "qwen3-8b")
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 0.05}


def _configs(arch, dtype):
    return (dataclasses.replace(j_smoke(arch), compute_dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype))


def _weights(jcfg, seed=3):
    """The reference's random init, with the zero-initialised biases and
    the unit norm scales perturbed so that both paths are exercised."""
    params = j_init_params(j_model_specs(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if any(k in name for k in ("'bq'", "'bk'", "'bv'")):
            return x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
        if any(k in name for k in ("scale", "q_norm", "k_norm")):
            return x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(perturb, params)


def _margin(logits):
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _ids_agree(got, want, tol):
    """Greedy ids equal wherever the reference's margin exceeds tol;
    returns the number of lanes under the margin."""
    want = np.asarray(want, np.float32)
    close = _margin(want) <= tol
    same = got.argmax(-1) == want.argmax(-1)
    assert (same | close).all(), np.nonzero(~same & ~close)
    return int(close.sum())


class _Runs:
    """Both packages through prefill → slab → decode on the same weights;
    collects (port, reference) pairs of logits and caches."""

    def __init__(self, arch, dtype, ctx_kw=None):
        self.jcfg, self.cfg = _configs(arch, dtype)
        jp = _weights(self.jcfg)
        self.jp = jax.tree_util.tree_map(jnp.asarray, jp)
        self.p = model_params_from_numpy(jp, self.cfg, "cpu")
        self.jctx, self.ctx = JCtx(cfg=self.jcfg), Ctx(cfg=self.cfg,
                                                       **(ctx_kw or {}))
        self.pairs = []
        rng = np.random.default_rng(0)
        v = self.cfg.vocab_size
        buckets = [(rng.integers(0, v, (3, 16)), [0, 2, 4]),
                   (rng.integers(0, v, (2, 24)), [1, 5])]
        n_slots, max_len = 6, 32
        jslab = j_tree_map_specs(lambda s: jnp.zeros(s.shape, s.dtype),
                                 j_cache_specs(self.jcfg, n_slots, max_len))
        jslab["length"] = jnp.zeros((n_slots,), jnp.int32)
        pool = ModelPool(self.cfg, device="cpu", params=self.p)
        slab = pool.make_slab(n_slots, max_len)
        last = np.zeros(n_slots, np.int32)
        jfill = jax.jit(lambda p, b: j_prefill(self.jctx, p, b))
        for toks, slots in buckets:
            toks = toks.astype(np.int32)
            jl, jc = jfill(self.jp, {"tokens": jnp.asarray(toks)})
            tl, tc = prefill(self.ctx, self.p,
                             {"tokens": torch.from_numpy(toks).long()})
            self.pairs.append(("prefill", tl, jl))
            self.pairs.append(("prefill cache", tree_to_numpy(tc), jc))
            jslab = j_insert_slab(jslab, jc, jnp.asarray(slots, jnp.int32))
            pool.insert_slab(slab, tc, slots)
            last[slots] = np.asarray(jl).argmax(-1)
        # the port writes the slab in place: keep a copy of this point
        self.pairs.append(("slab", tree_to_numpy(slab), jslab))
        jdec = jax.jit(lambda p, c, b: j_decode_step(self.jctx, p, c, b))
        for step in range(4):
            jl, jslab = jdec(self.jp, jslab,
                             {"tokens": jnp.asarray(last[:, None])})
            tl, slab = decode_step(self.ctx, self.p, slab, {
                "tokens": torch.from_numpy(last[:, None].astype(np.int64))})
            self.pairs.append((f"decode {step}", tl, jl))
            last = np.asarray(jl).argmax(-1).astype(np.int32)
        self.pairs.append(("final slab", tree_to_numpy(slab), jslab))


def _check(runs, dtype):
    under = 0
    for what, got, want in runs.pairs:
        if isinstance(got, dict):
            g = got
            w = jax.tree_util.tree_map(
                lambda x: np.asarray(x).astype(
                    np.float32 if x.dtype != jnp.int32 else np.int32), want)
            np.testing.assert_array_equal(g["length"], w["length"])
            tree_map(lambda gl, wl: np.testing.assert_allclose(
                gl, wl, rtol=0, atol=CACHE_TOL[dtype], err_msg=what),
                g["segments"], w["segments"])
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=LOGIT_TOL[dtype],
                                       err_msg=what)
            under += _ids_agree(got.numpy(), want, LOGIT_TOL[dtype])
    return under


@pytest.mark.parametrize("arch", TIERS)
def test_prefill_and_slab_decode_match_reference_f32(arch):
    under = _check(_Runs(arch, "float32"), "float32")
    print(f"{arch} float32: {under} greedy lanes under the margin")


def test_prefill_and_slab_decode_match_reference_bf16():
    under = _check(_Runs("qwen3-8b", "bfloat16"), "bfloat16")
    print(f"qwen3-8b bfloat16: {under} greedy lanes under the margin")


@pytest.mark.parametrize("arch", TIERS)
def test_kernel_branch_wiring(monkeypatch, arch):
    """The model's kernel branch on the CPU, the kernels stood in for by
    their plain versions: what reaches them is what the CUDA kernels take
    (q, k, v and the cache as strided views with a contiguous last
    dimension, not copies; int32 lengths within the cache), and the model
    still matches the reference."""
    calls = {"flash_attention": 0, "decode_attention": 0}

    def flash(q, k, v, *, window=None, causal=True, force="auto"):
        assert force == "kernel" and causal and window is None
        assert all(t.stride(-1) == 1 for t in (q, k, v))
        assert not q.is_contiguous()            # a view of (B, S, H, D)
        calls["flash_attention"] += 1
        return attention_ref(q, k, v, window=window, causal=causal)

    def decode(q, k_cache, v_cache, length, *, force="auto"):
        assert force == "kernel" and length.dtype == torch.int32
        assert not k_cache.is_contiguous()      # the slab, permuted
        assert k_cache.stride(-1) == v_cache.stride(-1) == 1
        assert int(length.min()) >= 1
        assert int(length.max()) <= k_cache.shape[2]
        calls["decode_attention"] += 1
        return decode_attention_ref(q, k_cache, v_cache, length)

    monkeypatch.setattr(_build, "dispatch", lambda name, force, dev: True)
    monkeypatch.setattr(flash_ops, "flash_attention", flash)
    monkeypatch.setattr(decode_ops, "decode_attention", decode)
    runs = _Runs(arch, "float32", ctx_kw={"force": "kernel"})
    _check(runs, "float32")
    layers = runs.cfg.num_layers
    assert calls == {"flash_attention": 2 * layers,
                     "decode_attention": 4 * layers}


# ---------------------------------------------------------------------------
# Configs, specs and weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registry_copies_or_names_the_roadmap_item(arch):
    from repro.configs import get_config as j_get_config
    try:
        cfg = get_config(arch)
    except NotImplementedError as e:
        assert "A.14" in str(e)
        with pytest.raises(NotImplementedError, match="A.14"):
            get_smoke_config(arch)
        return
    for full, jc in ((cfg, j_get_config(arch)),
                     (get_smoke_config(arch), j_smoke(arch))):
        for f in dataclasses.fields(full):
            assert getattr(full, f.name) == getattr(jc, f.name), f.name
        assert count_params(model_specs(full)) == full.param_count()


def test_init_params_dtypes_scales_and_seed():
    cfg = get_smoke_config("qwen3-8b")
    specs = model_specs(cfg)
    a = init_params(specs, torch.Generator().manual_seed(5), "cpu",
                    torch.bfloat16)
    b = init_params(specs, torch.Generator().manual_seed(5), "cpu",
                    torch.bfloat16)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    seg = a["segments"][0]["pos0"]
    assert seg["norm1"]["scale"].dtype == torch.float32
    assert seg["attn"]["q_norm"].dtype == torch.float32
    assert seg["attn"]["wq"].dtype == torch.bfloat16
    assert torch.equal(seg["norm1"]["scale"], torch.ones_like(
        seg["norm1"]["scale"]))
    tok = a["embed"]["tok"].float()
    assert abs(float(tok.std()) - 1.0) < 0.05       # the spec's stddev
    w = seg["mlp"]["w_gate"].float()
    assert abs(float(w.std()) / cfg.d_model ** -0.5 - 1.0) < 0.05


def test_params_and_cache_convert_both_ways():
    jcfg, cfg = _configs("qwen1.5-0.5b", "float32")
    jp = _weights(jcfg)
    back = tree_to_numpy(model_params_from_numpy(jp, cfg, "cpu"))
    tree_map(lambda x, y: np.testing.assert_array_equal(x, np.asarray(y)),
             back, jp)
    rng = np.random.default_rng(1)
    cache = {"length": np.array([3, 0], np.int32), "segments": [{"pos0": {
        k: rng.normal(size=(2, 2, 20, 4, 16)).astype(np.float32)
        for k in ("k", "v")}}]}
    t = cache_from_numpy(cache, cfg, "cpu")
    assert t["length"].dtype == torch.int32
    out = tree_to_numpy(t)
    np.testing.assert_array_equal(out["segments"][0]["pos0"]["k"],
                                  cache["segments"][0]["pos0"]["k"])
