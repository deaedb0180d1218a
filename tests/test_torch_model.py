"""The port's tier models against the live JAX models on the same weights
(the reference's ``init_params``, converted with ``model_params_from_numpy``),
for four tier SMOKE configs: Qwen1.5-0.5B's (MHA, QKV bias), Qwen3-8B's
(GQA, qk-norm), Falcon-Mamba-7B's (Mamba SSM blocks) and RecurrentGemma-9B's
(RG-LRU blocks and MQA local attention in a 5-layer pattern with a
remainder segment; its window of 16 is shorter than the 24-token prompts,
so the rolling window slab wraps as in the reference).

A prefill of two prompt-length buckets, their caches scattered into a
cache-slot slab with per-row lengths (one slot left empty), then four
decode steps over the whole slab, teacher-forced with the reference's
greedy ids.  In float32 compute the logits must agree to 1e-4 (sums in
another order: measured ~1e-6) and the caches to 1e-5; in bfloat16 the
logits to 0.1 (the two frameworks round at other places; measured ~0.03).
Greedy ids must be equal wherever the reference's top-2 logit margin
exceeds that tolerance; lanes under it are counted and reported.
"""
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
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru.ref import rglru_scan_ref
from repro_torch.models.layers import Ctx
from repro_torch.models.model import decode_step, model_specs, prefill
from repro_torch.models.params import (
    count_params,
    init_params,
    tree_leaves,
    tree_map,
)
from repro_torch.serving.pools import ModelPool

TIERS = ("qwen1.5-0.5b", "qwen3-8b", "falcon-mamba-7b", "recurrentgemma-9b")
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 0.05}


def _configs(arch, dtype):
    return (dataclasses.replace(j_smoke(arch), compute_dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype))


def _weights(jcfg, seed=3):
    """The reference's random init, with the zero-initialised biases and
    the unit norm scales and the recurrent mixers' float32 leaves perturbed
    so that every path is exercised."""
    params = j_init_params(j_model_specs(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if any(k in name for k in ("'bq'", "'bk'", "'bv'")):
            return x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
        if any(k in name for k in ("scale", "q_norm", "k_norm", "'A_log'",
                                   "'D'", "'dt_bias'", "'conv_b'", "'b_a'",
                                   "'b_x'", "'lambda_p'")):
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
    dimension, not copies; int32 lengths within the cache; the scans' B and
    C as column slices of the projection, the decode state passed as both
    h0 and h_out), each kernel runs once per layer of its kind per call, and
    the model still matches the reference."""
    cfg = get_smoke_config(arch)
    calls = collections.Counter()

    def flash(q, k, v, *, window=None, causal=True, positions=None,
              force="auto"):
        assert force == "kernel" and causal and window == cfg.attn_window
        assert positions is None                # forward's arange: by index
        assert all(t.stride(-1) == 1 for t in (q, k, v))
        assert not q.is_contiguous()            # a view of (B, S, H, D)
        calls["flash_attention"] += 1
        return attention_ref(q, k, v, window=window, causal=causal)

    def decode(q, k_cache, v_cache, length, *, force="auto"):
        assert force == "kernel" and length.dtype == torch.int32
        assert k_cache._base is not None        # the slab, permuted
        assert k_cache.stride(-1) == v_cache.stride(-1) == 1
        assert int(length.min()) >= 1
        assert int(length.max()) <= k_cache.shape[2]
        calls["decode_attention"] += 1
        return decode_attention_ref(q, k_cache, v_cache, length)

    def state(h0, h_out, h):
        assert (h0 is None) == (h_out is None)
        if h0 is None:
            return h
        assert h0 is h_out and h0.is_contiguous()
        assert h0.dtype == torch.float32
        return h_out.copy_(h)

    def mamba(x, dt, B, C, A, D, h0=None, *, h_out=None, force="auto"):
        assert force == "kernel" and dt.dtype == torch.float32
        assert all(t.stride(-1) == 1 for t in (x, dt, B, C))
        assert not B.is_contiguous() and not C.is_contiguous()
        calls["mamba_scan"] += 1
        y, h = selective_scan_ref(x, dt, B, C, A, D, h0)
        return y, state(h0, h_out, h)

    def rglru(x, r, i, la, h0=None, *, h_out=None, force="auto"):
        assert force == "kernel" and x.is_contiguous()
        assert r.dtype == i.dtype == la.dtype == torch.float32
        calls["rglru_scan"] += 1
        y, h = rglru_scan_ref(x, r, i, la, h0)
        return y, state(h0, h_out, h)

    monkeypatch.setattr(_build, "dispatch", lambda name, force, dev: True)
    monkeypatch.setattr(flash_ops, "flash_attention", flash)
    monkeypatch.setattr(decode_ops, "decode_attention", decode)
    monkeypatch.setattr(mamba_ops, "selective_scan", mamba)
    monkeypatch.setattr(rglru_ops, "rglru_scan", rglru)
    runs = _Runs(arch, "float32", ctx_kw={"force": "kernel"})
    _check(runs, "float32")
    layers = collections.Counter(cfg.layer_kinds())
    prefills, steps = 2, 4
    want = {"flash_attention": prefills * layers["attn"],
            "decode_attention": steps * layers["attn"],
            "mamba_scan": (prefills + steps) * layers["ssm"],
            "rglru_scan": (prefills + steps) * layers["rglru"]}
    assert calls == collections.Counter({k: v for k, v in want.items() if v})


# ---------------------------------------------------------------------------
# Configs, specs and weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registry_copies_or_names_the_roadmap_item(arch):
    """Every id of the reference's registry is copied: the config and its
    SMOKE equal the reference's field for field (sub-configs and sharding
    overrides included) but for the reference's Pallas switch, which the
    port has no counterpart of, and the spec tree counts the config's
    parameters.  A SMOKE pool of each config with a token table serves a
    segment on the CPU (the MoE ones included); one whose front end feeds
    embeddings refuses to build a pool."""
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro.configs import get_config as j_get_config
    assert set(ARCH_IDS) == set(J_ARCH_IDS)
    cfg = get_config(arch)
    for full, jc in ((cfg, j_get_config(arch)),
                     (get_smoke_config(arch), j_smoke(arch))):
        assert {f.name for f in dataclasses.fields(jc)} - {
            f.name for f in dataclasses.fields(full)} == {"kernels"}
        for f in dataclasses.fields(full):
            got, want = getattr(full, f.name), getattr(jc, f.name)
            if dataclasses.is_dataclass(got):      # MoE / SSM / RG-LRU
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, f.name
        assert count_params(model_specs(full)) == full.param_count()
        assert count_params(model_specs(full, serve=True)) == \
            full.param_count() + 3 * full.num_layers * (
                full.moe.num_experts if full.quant_experts_serve else 0)
    smoke = get_smoke_config(arch)
    if not smoke.embed_inputs:
        with pytest.raises(ValueError, match="embeddings"):
            ModelPool(smoke, device="cpu")
        return
    pool = ModelPool(smoke, device="cpu")
    ids = pool.serve_segment(torch.zeros((2, 16), dtype=torch.long), 3)
    assert ids.shape == (2, 3)
    assert ((ids >= 0) & (ids < smoke.vocab_size)).all()


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


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_recurrent_slab_converts_and_inserts_like_reference(arch):
    """A bf16 recurrent slab crosses from the reference with each leaf in
    its cache spec's dtype (K/V and ``conv`` bf16, ``h`` float32, exact
    both ways), and ``insert_slab`` scatters a prefill cache into it as the
    reference does: recurrent leaves whole, a shorter K/V sequence axis
    zero-padded, untouched slots kept."""
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    rng = np.random.default_rng(7)

    def rand(specs, n_len):
        tree = j_tree_map_specs(lambda s: jnp.asarray(
            rng.normal(size=s.shape).astype(np.float32), s.dtype), specs)
        tree["length"] = jnp.asarray(rng.integers(1, 30, n_len)
                                     if n_len else 8, jnp.int32)
        return tree

    jslab = rand(j_cache_specs(jcfg, 5, 32), 5)
    jcache = rand(j_cache_specs(jcfg, 3, 8), 0)
    slab = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jslab), cfg,
                            "cpu")
    for seg in slab["segments"]:
        for leaves in seg.values():
            for name, t in leaves.items():
                assert t.dtype == (torch.float32 if name == "h"
                                   else torch.bfloat16), name

    def same(got, want):
        np.testing.assert_array_equal(got["length"],
                                      np.asarray(want["length"]))
        tree_map(lambda g, w: np.testing.assert_array_equal(
            g, np.asarray(w).astype(np.float32)), got["segments"],
            want["segments"])

    same(tree_to_numpy(slab), jslab)
    cache = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache), cfg,
                             "cpu")
    want = j_insert_slab(jslab, jcache, jnp.asarray([4, 0], jnp.int32))
    pool = ModelPool(cfg, device="cpu")
    assert pool.insert_slab(slab, cache, [4, 0]) is slab
    same(tree_to_numpy(slab), want)
