"""The port's prefill and serve steps under the serve rules
(``make_prefill_step`` / ``make_serve_step`` with ``rules_for(cfg, mesh,
kind)``) against the live JAX steps under the reference's rules, float32
SMOKE configs, on the CPU.

* Qwen1.5-0.5B, Qwen3-8B, Moonshot-v1-16B-A3B, Falcon-Mamba-7B,
  RecurrentGemma-9B (one KV head: ``kv_whole``; a 16-entry window that
  wraps across a range boundary), Mixtral-8x22B (window 16) and Mixtral
  with its full config's serve rules (each expert's MLP dim over
  ``"model"``, int8 experts) at (data, model) = (1, 4) on 4 gloo ranks
  (one world) against the JAX steps on 4 host devices (two subprocesses,
  Auto axes as in ``test_torch_train_ranks.py``): a prefill of 20 tokens,
  per-row lengths on both sides of a range boundary, then 4 decode steps.
  Logits within 1e-5 of the largest |logit|, the same on every rank,
  greedy ids equal wherever the reference's top-2 margin exceeds that;
  each rank's cache block equal to its slice of the JAX cache within
  1e-6 of the leaf's largest |entry| (at least 1), after the prefill and
  after the last step.
* Each layer records the mode it ran, the attention cache its split
  (``("attn_cache", "seq")`` where 4 divides the cache length, ``"whole"``
  where it does not), and the test asserts them.
* Qwen1.5-0.5B at (2, 2), and Qwen3-8B at (1, 4) with a cache of 85
  entries (left whole), against the port's one-device steps; the
  one-device prefill's cache cut by ``cache_from_numpy(..., placements=,
  mesh=)`` equals the split prefill's blocks.
* Plain functions: ``decode_attention_partial_ref`` over 1-4 ranges,
  merged by ``merge_partials``, equals ``decode_attention_ref`` within
  1e-6, empty ranges among them; a row with every range empty gives no
  NaN; ``rules_for`` maps every logical axis as the reference's does.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import pickle
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_serve_tp import run_steps, serve_cfg, world

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
from repro.configs import get_smoke_config as j_smoke
from repro.launch.steps import rules_for as j_rules_for
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import model_params_from_numpy, tree_to_numpy
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partial_ref,
    decode_attention_ref,
)
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.steps import rules_for
from repro_torch.models.model import model_specs
from repro_torch.models.moe import quantize_expert_params
from repro_torch.models.params import init_params, tree_map
from repro_torch.sharding.tensor_parallel import merge_partials

B, S, STEPS = 4, 20, 4
TOL, CACHE_TOL = 1e-5, 1e-6
JAX_CASES = [{"name": f"{a}@1x4", "arch": a, "shape": (1, 4)} for a in (
    "qwen1.5-0.5b", "qwen3-8b", "moonshot-v1-16b-a3b", "falcon-mamba-7b",
    "recurrentgemma-9b", "mixtral-8x22b")] + [
    {"name": "mixtral_serve_rules@1x4", "arch": "mixtral-8x22b",
     "shape": (1, 4), "cfg": {"overrides": True}}]
JAX_CASES[1]["cut"] = True
VARIANTS = [
    {"name": "qwen3_whole_cache@1x4", "arch": "qwen3-8b", "shape": (1, 4),
     "prompt": S + 1},
    {"name": "qwen@2x2", "arch": "qwen1.5-0.5b", "shape": (2, 2),
     "cut": True}]
# (layer kind, mode) each case must record, and modes it must not
SEQ = ("attn_cache", "seq")
MODES = {
    "qwen1.5-0.5b@1x4": ({("attn", "split"), ("mlp", "split"), SEQ,
                          ("embed", "vocab"), ("head", "vocab")}, set()),
    "qwen3-8b@1x4": ({("attn", "kv_whole"), ("mlp", "split"), SEQ}, set()),
    "moonshot-v1-16b-a3b@1x4": ({("attn", "split"), ("moe", "experts"),
                                 SEQ}, set()),
    "falcon-mamba-7b@1x4": ({("ssm", "split"), ("head", "vocab")}, set()),
    "recurrentgemma-9b@1x4": ({("rglru", "split"), ("attn", "kv_whole"),
                               ("mlp", "split"), SEQ}, set()),
    "mixtral-8x22b@1x4": ({("attn", "kv_whole"), ("moe", "experts"), SEQ},
                          set()),
    "mixtral_serve_rules@1x4": ({("moe", "expert_mlp"), SEQ},
                                {("moe", "experts")}),
    "qwen3_whole_cache@1x4": ({("attn_cache", "whole")}, {SEQ}),
    "qwen@2x2": ({("attn", "split"), ("mlp", "split"), SEQ}, set())}

JAX_SCRIPT = """
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.configs import get_config, get_smoke_config
from repro.launch.steps import make_prefill_step, make_serve_step, rules_for
from repro.models import model_specs
from repro.models.params import is_spec

with open(sys.argv[1], "rb") as f:
    args = pickle.load(f)
tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
out = {}
for case in args["cases"]:
    kw = dict(case.get("cfg", {}))
    if kw.pop("overrides", False):
        full = get_config(case["arch"])
        kw.update(sharding_overrides=full.sharding_overrides,
                  quant_experts_serve=full.quant_experts_serve)
    cfg = dataclasses.replace(get_smoke_config(case["arch"]),
                              compute_dtype="float32", **kw)
    mesh = jax.make_mesh(case["shape"], ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    inp = args["inputs"][case["name"]]
    params = jax.tree_util.tree_map(
        lambda s, x: jnp.asarray(x, s.dtype), model_specs(cfg, serve=True),
        args["params"][case["name"]], is_leaf=is_spec)
    with mesh:
        prefill = jax.jit(make_prefill_step(cfg, rules_for(cfg, mesh,
                                                           "prefill")))
        serve = jax.jit(make_serve_step(cfg, rules_for(cfg, mesh, "decode")))
        logits, cache = prefill(params, {"tokens": jnp.asarray(inp["tokens"])})
        rec = {"logits": [np.asarray(logits)], "first": tonp(cache)}
        cache = dict(cache, length=jnp.asarray(inp["lengths"]))
        for col in inp["decode"].T:
            logits, cache = serve(params, cache,
                                  {"tokens": jnp.asarray(col[:, None])})
            rec["logits"].append(np.asarray(logits))
        rec["last"] = tonp(cache)
    out[case["name"]] = rec
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _params(case) -> dict:
    """Whole serve weights, numpy: the port's seeded draw with every
    zero or unit leaf (biases, norm scales, ``D``) perturbed, and the
    experts quantized where the config serves int8 ones."""
    cfg = serve_cfg(case["arch"], case.get("cfg", {}))
    rng = np.random.default_rng(11)
    full = init_params(model_specs(cfg), torch.Generator().manual_seed(5),
                       "cpu")

    def perturb(t):
        x = t.numpy()
        if np.all(x == x.flat[0]):
            x = x + rng.normal(0.0, 0.1, x.shape).astype(x.dtype)
        return torch.from_numpy(x)

    full = tree_map(perturb, full)
    if cfg.moe is not None and cfg.quant_experts_serve:
        for seg in full["segments"]:
            for layer in seg.values():
                layer["mlp"] = quantize_expert_params(layer["mlp"])
    return tree_to_numpy(full)


def _inputs(case) -> dict:
    """Prompts, per-row lengths after the prefill and the decode tokens.
    A full cache holds S + 64 entries (21 a rank): rows end at 19, 20, 41
    and 62, so rows 0 and 1 write across the first range boundary and
    rows 2 and 3 across the next ones; a 16-entry window (4 a rank) at
    20, 23, 30 and 47 writes from slots 4, 7, 14 and 15, the last two
    wrapping from the last range into the first."""
    cfg = serve_cfg(case["arch"], case.get("cfg", {}))
    rng = np.random.default_rng(23)
    s = case.get("prompt", S)
    lengths = [19, 20, 41, 62] if cfg.attn_window is None else \
        [20, 23, 30, 47]
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                np.int32),
            "lengths": np.asarray(lengths, np.int32),
            "decode": rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(
                np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references in two subprocesses (each on its own cores),
    beside the port's two worlds: (1, 4) for the JAX cases and Qwen3's
    whole cache, (2, 2) for Qwen."""
    tmp = tmp_path_factory.mktemp("serve_tp")
    cases = JAX_CASES + VARIANTS
    params = {c["name"]: _params(c) for c in cases}
    inputs = {c["name"]: _inputs(c) for c in cases}
    procs = []
    for i, part in enumerate((JAX_CASES[:4], JAX_CASES[4:])):
        with open(tmp / f"args{i}.pkl", "wb") as f:
            pickle.dump({"cases": part, "params": params,
                         "inputs": inputs}, f)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", torch_threads.child_script(JAX_SCRIPT),
             str(tmp / f"args{i}.pkl"), str(tmp / f"ref{i}.pkl")],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env=torch_threads.subprocess_env(i, JAX_PLATFORMS="cpu")))
    ref = {}
    try:
        port = {}
        for shape in ((1, 4), (2, 2)):
            group = [c for c in cases if c["shape"] == shape]
            port[shape] = run_ranks(world, 4, backend="gloo", timeout=300,
                                    args=(group, params, inputs))
        for i, proc in enumerate(procs):
            _, err = proc.communicate(timeout=400)
            assert proc.returncode == 0, err[-3000:]
            with open(tmp / f"ref{i}.pkl", "rb") as f:
                ref.update(pickle.load(f))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return SimpleNamespace(ref=ref, port=port, params=params, inputs=inputs)


def _ranks(runs, case) -> list:
    return [r[case["name"]] for r in runs.port[case["shape"]]]


def _hold_logits(got: list, want: list, rows=slice(None)):
    """Each step's logits within TOL of the step's largest |logit|, and
    the greedy ids equal wherever the reference's top-2 margin exceeds
    that tolerance."""
    for step, (g, w) in enumerate(zip(got, want)):
        w = w[rows]
        tol = TOL * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= tol, (step, np.abs(g - w).max())
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > tol
        assert np.array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear]), step


def _hold_block(got, want, start):
    """A rank's block of a cache leaf against its slice of the whole leaf
    (``start`` where the block starts, a dim each)."""
    sl = tuple(slice(a, a + n) for a, n in zip(start, got.shape))
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want[sl]).max()) <= CACHE_TOL * scale


@pytest.mark.parametrize("case", JAX_CASES, ids=[c["name"]
                                                 for c in JAX_CASES])
def test_split_steps_match_the_live_jax_steps(runs, case):
    ranks = _ranks(runs, case)
    want = runs.ref[case["name"]]["logits"]
    for r in ranks:
        for g, g0 in zip(r["logits"], ranks[0]["logits"]):
            assert np.array_equal(g, g0)        # the same on every rank
    _hold_logits(ranks[0]["logits"], want)


@pytest.mark.parametrize("case", JAX_CASES, ids=[c["name"]
                                                 for c in JAX_CASES])
def test_rank_cache_blocks_are_slices_of_the_jax_cache(runs, case):
    ref = runs.ref[case["name"]]
    for r in _ranks(runs, case):
        for key in ("first", "last"):
            tree_map(_hold_block, r[key]["segments"], ref[key]["segments"],
                     r["starts"])
            assert np.array_equal(r[key]["length"], ref[key]["length"])


@pytest.mark.parametrize("case", sorted(MODES))
def test_each_layer_records_the_mode_it_ran(runs, case):
    must, must_not = MODES[case]
    spec = next(c for c in JAX_CASES + VARIANTS if c["name"] == case)
    for r in _ranks(runs, spec):
        modes = set(r["modes"])
        assert must <= modes, (must - modes, modes)
        assert not modes & must_not, modes


@pytest.mark.parametrize("case", JAX_CASES + VARIANTS,
                         ids=[c["name"] for c in JAX_CASES + VARIANTS])
def test_cache_blocks_split_as_the_serve_rules_say(runs, case):
    """K/V by sequence over the 4 ``"model"`` ranks where 4 divides the
    cache length (whole otherwise), the recurrent states by channel, the
    rows over ``"data"``."""
    cfg = serve_cfg(case["arch"], case.get("cfg", {}))
    d, t = case["shape"]
    s = case.get("prompt", S)
    c = min(cfg.attn_window, s) if cfg.attn_window else s + \
        cfg.decode_headroom
    for r in _ranks(runs, case):
        for seg in r["last"]["segments"]:
            for layer in seg.values():
                if "k" in layer:        # (layers, B, C, KV, D)
                    want = c // t if c % t == 0 else c
                    assert layer["k"].shape[1:3] == (B // d, want)
                    assert layer["v"].shape == layer["k"].shape
                else:                   # conv (n, B, K-1, W), h (n, B, W[, N])
                    width = cfg.d_inner if cfg.ssm else cfg.lru_width
                    assert layer["conv"].shape[-1] == width // t
                    assert layer["h"].shape[2] == width // t
                    assert layer["h"].shape[1] == B // d


@pytest.mark.parametrize("case", VARIANTS, ids=[c["name"] for c in VARIANTS])
def test_split_variants_match_one_device(runs, case):
    cfg = serve_cfg(case["arch"], case.get("cfg", {}))
    params = model_params_from_numpy(runs.params[case["name"]], cfg, "cpu",
                                     serve=True)
    inputs = runs.inputs[case["name"]]
    want, first, last = run_steps(cfg, params, inputs)
    d = case["shape"][0]
    for i, r in enumerate(_ranks(runs, case)):
        n = B // d
        rows = slice(i // case["shape"][1] * n, (i // case["shape"][1] + 1)
                     * n)
        _hold_logits(r["logits"], want, rows)
        for key, whole in (("first", first), ("last", last)):
            tree_map(_hold_block, r[key]["segments"], whole["segments"],
                     r["starts"])


@pytest.mark.parametrize("case", [c for c in JAX_CASES + VARIANTS
                                  if c.get("cut")],
                         ids=lambda c: c["name"])
def test_cache_from_numpy_cuts_the_rank_blocks(runs, case):
    for r in _ranks(runs, case):
        tree_map(_hold_block, r["first"]["segments"], r["cut"]["segments"],
                 tree_map(np.zeros_like, r["starts"]))
        assert r["cut"]["cache_len"] == r["first"]["cache_len"]


def _partial_case(seed, lengths, s=40):
    rng = np.random.default_rng(seed)
    b, h, kv, d = len(lengths), 8, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, kv, s, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, kv, s, d)).astype(np.float32))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize("ranges", [1, 2, 3, 4])
def test_partial_ranges_merge_to_the_whole_attention(ranges):
    """Rows of length 1 (every range but the first empty), 9, 21, 40 over
    a 40-entry cache cut into ``ranges`` equal ranges (the last shorter
    at 3)."""
    q, k, v, length = _partial_case(ranges, [1, 9, 21, 40])
    s = k.shape[2]
    n = -(-s // ranges)
    outs, lses = [], []
    for r in range(ranges):
        lo, hi = r * n, min((r + 1) * n, s)
        local = torch.clamp(length - lo, 0, hi - lo)
        o, lse = decode_attention_partial_ref(q, k[:, :, lo:hi],
                                              v[:, :, lo:hi], local)
        outs.append(o)
        lses.append(lse)
    out, lse = merge_partials(torch.stack(outs), torch.stack(lses))
    want = decode_attention_ref(q, k, v, length)
    assert float((out - want).abs().max()) <= 1e-6
    scores = torch.einsum("bkgd,bksd->bkgs", q.reshape(4, 2, 4, 16),
                          k) * 16 ** -0.5
    valid = torch.arange(s)[None, :] < length[:, None]
    whole = torch.logsumexp(torch.where(valid[:, None, None], scores,
                                        -torch.inf), dim=-1).reshape(4, 8)
    assert float((lse - whole).abs().max()) <= 1e-5
    if ranges > 1:      # row 0's later ranges are empty
        assert torch.all(torch.stack(lses)[1:, 0] == -torch.inf)


def test_an_all_empty_row_gives_no_nan():
    q, k, v, _ = _partial_case(5, [0, 0, 3, 0], s=8)
    outs, lses = zip(*(decode_attention_partial_ref(
        q, k[:, :, lo:lo + 4], v[:, :, lo:lo + 4],
        torch.tensor([0, 0, 3 - lo if lo == 0 else 0, 0], dtype=torch.int32))
        for lo in (0, 4)))
    assert torch.all(outs[0][0] == 0) and torch.all(lses[0][0] == -torch.inf)
    out, lse = merge_partials(torch.stack(outs), torch.stack(lses))
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    assert torch.all(out[[0, 1, 3]] == 0)
    assert torch.all(lse[[0, 1, 3]] == -torch.inf)
    assert torch.isfinite(lse[2]).all()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_for_maps_every_axis_as_the_reference(arch, kind):
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 4))
    got = rules_for(get_smoke_config(arch), mesh, kind)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    want = j_rules_for(j_smoke(arch), jmesh, kind)
    assert dict(got.mapping) == dict(want.mapping)
    assert got.mesh is mesh
