"""Tensor-parallel training in the port: the ``Trainer`` split over the
mesh's ``"model"`` dim against the live JAX ``Trainer``, float32 SMOKE
configs, on the CPU.

* Qwen1.5-0.5B, Moonshot-v1-16B-A3B, Falcon-Mamba-7B, RecurrentGemma-9B
  and Mixtral-8x22B at (data, model) = (1, 4) on 4 gloo ranks against the
  JAX ``Trainer`` on 4 host devices (two JAX subprocesses, Auto axes,
  the harness of ``test_torch_train_ranks.py``), 2 steps: each step's loss
  and gradient norm within 1e-5 relative and the same on every rank; the
  state after step 1 and the moments after step 2 held as there.
* Variants the reference's tests do not reach, against the port's
  one-device ``Trainer`` at the same tolerance: Mixtral with its full
  config's rules (each expert's MLP dim over ``"model"``), 6 heads that 4
  ranks cannot split (the attention runs whole), and (2, 2) with and
  without remat.
* Each layer records the mode it ran (split, kv_whole, whole, experts,
  expert_mlp, vocab) and the test asserts it; at most one unit (a layer,
  the embedding or the head) has a gathered copy alive at any time.
* A rank's gradient of a leaf read whole inside a split region (Mixtral's
  ``wk``, KV heads gathered whole) is partial: the ranks' differ and their
  sum is the one-device gradient; a leaf read outside one (the norms, the
  router) has the same gradient on every rank, the one-device gradient.
* On 2 gloo ranks: the four autograd collectives forward and backward
  against a one-process computation, the vocab-parallel cross-entropy
  against the whole one within 1e-6 (labels in both ranks' ranges), a
  checkpoint written at (1, 2) restored onto (2, 1), its next step within
  1e-5 relative, and every registry SMOKE config split at (1, 2) against
  the port's one-device trainer at 1e-5 (Qwen3's per-head norms, Yi's and
  Minitron's GQA, the embedding-input Qwen2-VL and MusicGen among them).
"""
import os
import pickle
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_train_ranks import (
    JAX_SCRIPT,
    STEPS,
    TOL,
    _batches,
    _hold_first_step,
    _hold_moments,
    _rel,
    _wait_for,
)
from torch_train_ranks import OPT, smoke_f32, state_from_numpy
from torch_train_tp import two_ranks, variant, world

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.layers import Ctx
from repro_torch.models.model import model_plan, model_specs
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding.rules import make_rules
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer, grads_of

FAMILIES = ("qwen1.5-0.5b", "moonshot-v1-16b-a3b", "falcon-mamba-7b",
            "recurrentgemma-9b", "mixtral-8x22b")
JAX_CASES = [{"name": f"{a}@1x4", "arch": a, "shape": (1, 4)}
             for a in FAMILIES]
VARIANTS = [
    {"name": "mixtral_expert_mlp@1x4", "arch": "mixtral-8x22b",
     "shape": (1, 4), "cfg": {"overrides": True}},
    {"name": "heads6@1x4", "arch": "qwen1.5-0.5b", "shape": (1, 4),
     "cfg": {"num_heads": 6, "num_kv_heads": 6}, "from_inits": False},
    {"name": "qwen@2x2", "arch": "qwen1.5-0.5b", "shape": (2, 2)},
    {"name": "qwen_no_remat@2x2", "arch": "qwen1.5-0.5b", "shape": (2, 2),
     "cfg": {"remat": False}},
    {"name": "recurrentgemma_no_remat@2x2", "arch": "recurrentgemma-9b",
     "shape": (2, 2), "cfg": {"remat": False}}]
# Mixtral's SMOKE: 8 heads, kv = 2 at 4 ranks
GRAD_CASE = ("mixtral-8x22b", (1, 4), [
    ("segments", 0, "pos0", "attn", "wk"),
    ("segments", 0, "pos0", "attn", "wq"),
    ("segments", 0, "pos0", "norm1", "scale"),
    ("segments", 0, "pos0", "mlp", "router")])
# (layer kind, mode) each case must record, and modes it must not
MODES = {
    "qwen1.5-0.5b@1x4": ({("attn", "split"), ("mlp", "split"),
                          ("embed", "vocab"), ("head", "vocab")}, set()),
    "moonshot-v1-16b-a3b@1x4": ({("attn", "split"), ("moe", "experts")},
                                set()),
    "falcon-mamba-7b@1x4": ({("ssm", "split"), ("head", "vocab")}, set()),
    "recurrentgemma-9b@1x4": ({("rglru", "split"), ("attn", "kv_whole"),
                               ("mlp", "split")}, {("attn", "split")}),
    "mixtral-8x22b@1x4": ({("attn", "kv_whole"), ("moe", "experts")},
                          {("attn", "split")}),
    "mixtral_expert_mlp@1x4": ({("moe", "expert_mlp")}, {("moe", "experts")}),
    "heads6@1x4": ({("attn", "whole"), ("mlp", "split")}, {("attn", "split")}),
    "qwen@2x2": ({("attn", "split"), ("mlp", "split")}, set())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references at (1, 4), in two subprocesses (the first also
    writing the initialisations), and the port's 4-rank world."""
    tmp = tmp_path_factory.mktemp("train_tp")
    batches = {a: _batches(a) for a in FAMILIES}
    procs = []
    for i, cases in enumerate((JAX_CASES[:2], JAX_CASES[2:])):
        args = {"cases": cases, "opt": OPT, "tmp": str(tmp / f"j{i}"),
                "inits": FAMILIES if i == 0 else (), "allreduce": None,
                "batches": batches}
        with open(tmp / f"args{i}.pkl", "wb") as f:
            pickle.dump(args, f)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT),
             str(tmp / f"args{i}.pkl"), str(tmp / "init.pkl"),
             str(tmp / f"ref{i}.pkl")],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, JAX_PLATFORMS="cpu")))
    ref = {}
    try:
        _wait_for(tmp / "init.pkl", procs[0])
        with open(tmp / "init.pkl", "rb") as f:
            inits = pickle.load(f)
        port = run_ranks(world, 4, backend="gloo", timeout=300,
                         args=(inits, batches, JAX_CASES + VARIANTS,
                               GRAD_CASE, str(tmp / "t")))
        for i, proc in enumerate(procs):
            _, err = proc.communicate(timeout=400)
            assert proc.returncode == 0, err[-3000:]
            with open(tmp / f"ref{i}.pkl", "rb") as f:
                ref.update(pickle.load(f)["cases"])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {"ref": ref, "port": port, "inits": inits, "batches": batches}


def _ranks(runs, case):
    return [r["cases"][case] for r in runs["port"]]


def _same_on_every_rank(ranks):
    for k in ("loss", "grad_norm"):
        got = [r[k] for r in ranks]
        assert all(g == got[0] for g in got), (k, got)


@pytest.mark.parametrize("case", [c["name"] for c in JAX_CASES])
def test_split_training_matches_the_live_jax_trainer(runs, case):
    want = runs["ref"][case]
    ranks = _ranks(runs, case)
    _same_on_every_rank(ranks)
    for k in ("loss", "grad_norm"):
        for step in range(STEPS):
            got = ranks[0][k][step]
            assert _rel(got, want[k][step]) <= TOL, (k, step, got,
                                                     want[k][step])
    _hold_first_step(ranks[0]["whole"][0], want["whole"][0])
    _hold_moments(ranks[0]["whole"][1], want["whole"][1])


def _one_device(case, runs, tmp):
    """The port's one-device trainer on ``case``'s config, its losses and
    gradient norms over the same batches."""
    cfg = variant(case["arch"], case.get("cfg", {}))
    tr = Trainer(cfg, TrainConfig(steps=STEPS, ckpt_dir=str(tmp),
                                  opt=AdamWConfig(**OPT)), device="cpu")
    state = state_from_numpy(tr, runs["inits"][case["arch"]]) \
        if case.get("from_inits", True) else \
        tr.init_state(torch.Generator().manual_seed(4))
    out = {"loss": [], "grad_norm": []}
    for b in runs["batches"][case["arch"]]:
        *state, m = tr._step(*state, tr._device_batch(b))
        for k in out:
            out[k].append(float(m[k]))
    return out


@pytest.mark.parametrize("case", VARIANTS, ids=[c["name"] for c in VARIANTS])
def test_split_variants_match_one_device(runs, case, tmp_path):
    ranks = _ranks(runs, case["name"])
    _same_on_every_rank(ranks)
    want = _one_device(case, runs, tmp_path)
    for k in ("loss", "grad_norm"):
        for step in range(STEPS):
            assert _rel(ranks[0][k][step], want[k][step]) <= TOL, (
                k, step, ranks[0][k][step], want[k][step])


@pytest.mark.parametrize("case", sorted(MODES))
def test_each_layer_records_the_mode_it_ran(runs, case):
    must, must_not = MODES[case]
    for r in _ranks(runs, case):
        modes = set(r["modes"])
        assert must <= modes, (must - modes, modes)
        assert not modes & must_not, modes


@pytest.mark.parametrize("case", [c["name"] for c in JAX_CASES + VARIANTS])
def test_at_most_one_layer_copy_is_alive(runs, case):
    for r in _ranks(runs, case):
        assert r["peak_units"] <= 1, r["peak_units"]
        if case.endswith("@2x2"):       # every layer gathered over "data"
            assert r["gathers"] > 0 and r["peak_units"] == 1


def test_partial_gradients_sum_and_whole_ones_agree(runs, tmp_path):
    arch, shape, paths = GRAD_CASE
    cfg = smoke_f32(arch)
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)
    plan = model_plan(cfg, make_rules(mesh, "train"))
    got = [r["view_grads"] for r in runs["port"]]
    tr = Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path)), device="cpu")
    params = state_from_numpy(tr, runs["inits"][arch])[0]
    _, _, want = grads_of(Ctx(cfg=cfg), params,
                          tr._device_batch(runs["batches"][arch][0]))

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    for path in paths:
        key = "/".join(map(str, path))
        lp, full = at(plan, path), at(want, path).numpy()
        parts = [g[key] for g in got]
        scale = max(float(np.abs(full).max()), 1e-6)
        if lp.partial:          # wk: each rank's is partial, their sum whole
            assert lp.whole
            assert not np.array_equal(parts[0], parts[-1]), key
            total = parts[0] + parts[1] + parts[2] + parts[3]
            assert np.abs(total - full).max() <= 1e-5 * scale, key
        elif lp.whole:          # the norms, the router: the same on each
            for p in parts:
                np.testing.assert_array_equal(p, parts[0])
            assert np.abs(parts[0] - full).max() <= 1e-5 * scale, key
        else:                   # wq: each rank's block of the gradient
            n = full.shape[-1] // len(parts)
            for r, p in enumerate(parts):
                assert np.abs(p - full[..., r * n:(r + 1) * n]).max() \
                    <= 1e-5 * scale, key
    kinds = {(at(plan, p).whole, at(plan, p).partial) for p in paths}
    assert kinds == {(True, True), (True, False), (False, False)}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("t", (1, 2, 4, 8))
def test_plan_covers_every_leaf(arch, t):
    """The plan of every registry config at full size: a LeafPlan a leaf
    of the spec tree; a partial gradient only on a leaf read whole; at one
    rank nothing splits."""
    cfg = get_config(arch)
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, t))
    plan = model_plan(cfg, make_rules(mesh, "train",
                                      cfg.sharding_overrides.get("train")))
    specs = model_specs(cfg)
    pairs = []
    tree_map(lambda s, lp: pairs.append((s, lp)), specs, plan)
    assert len(pairs) == len(tree_leaves(specs))
    for _, lp in pairs:
        assert lp.whole or not lp.partial
        if t == 1:
            assert lp.whole and not lp.partial


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_tp_pair")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    g = rng.standard_normal((2, 4, 6)).astype(np.float32)
    parts = rng.standard_normal((2, 4, 3)).astype(np.float32)
    v = 32
    ce = (rng.standard_normal((2, 16, 8)).astype(np.float32),
          (rng.standard_normal((8, v)) * 2).astype(np.float32),
          rng.integers(0, v, (2, 16)).astype(np.int64),
          (rng.uniform(size=(2, 16)) > 0.2).astype(np.float32))
    assert {int(lb) // (v // 2) for lb in ce[2].ravel()} == {0, 1}
    arch = "qwen1.5-0.5b"
    cfg = smoke_f32(arch)
    init = Trainer(cfg, TrainConfig(ckpt_dir=str(tmp / "i")), device="cpu")
    params = init.init_state(torch.Generator().manual_seed(6))[0]
    params_np = tree_map(lambda t: t.numpy(), params)
    registry = {a: _registry_batches(a) for a in ARCH_IDS}
    out = run_ranks(two_ranks, 2, backend="gloo", timeout=180,
                    args=((x, g, parts), ce, params_np, _batches(arch),
                          registry, str(tmp / "r")))
    return {"out": out, "x": x, "g": g, "parts": parts,
            "registry": registry}


def _registry_batches(arch):
    cfg = get_smoke_config(arch)
    it = iter(TokenPipeline(cfg.vocab_size, 32, 8, seed=3,
                            d_model=cfg.d_model,
                            embed_inputs=cfg.embed_inputs, mrope=cfg.mrope))
    return [next(it) for _ in range(STEPS)]


@pytest.mark.parametrize("name", ("copy", "reduce", "gather", "scatter"))
def test_autograd_collectives_match_one_process(pair, name):
    x, g, parts = pair["x"], pair["g"], pair["parts"]
    whole = np.concatenate(list(parts), axis=1)        # (4, 6)
    for r, res in enumerate(o["collectives"] for o in pair["out"]):
        y, grad = res[name]
        if name == "copy":      # identity; the ranks' gradients summed
            np.testing.assert_array_equal(y, x)
            np.testing.assert_array_equal(grad, g[0] + g[1])
        elif name == "reduce":  # the ranks' parts summed; identity back
            np.testing.assert_array_equal(y, parts[0] + parts[1])
            np.testing.assert_array_equal(grad, g[r][:, :3])
        elif name == "gather":  # concatenated; this rank's slice back
            np.testing.assert_array_equal(y, whole)
            np.testing.assert_array_equal(grad, g[r][:, 3 * r:3 * r + 3])
        else:                   # this rank's slice; the slices gathered
            np.testing.assert_array_equal(y, x[:, 3 * r:3 * r + 3])
            np.testing.assert_array_equal(
                grad, np.concatenate([g[0][:, :3], g[1][:, :3]], axis=1))


def test_vocab_parallel_ce_matches_the_whole_ce(pair):
    losses = []
    for o in pair["out"]:
        got, want = o["ce"]["got"], o["ce"]["want"]
        losses.append(got["loss"])
        assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
        for k in ("gx", "gw"):
            scale = float(np.abs(want[k]).max())
            assert float(np.abs(got[k] - want[k]).max()) <= 1e-6 * scale, k
    assert losses[0] == losses[1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_registry_config_splits_like_one_device(pair, arch, tmp_path):
    ranks = [o["registry"][arch] for o in pair["out"]]
    _same_on_every_rank(ranks)
    assert any(mode != "whole" for _, mode in ranks[0]["modes"])
    want = _one_device({"arch": arch, "from_inits": False},
                       {"batches": {arch: pair["registry"][arch]}}, tmp_path)
    for k in ("loss", "grad_norm"):
        for step in range(STEPS):
            assert _rel(ranks[0][k][step], want[k][step]) <= TOL, (
                k, step, ranks[0][k][step], want[k][step])


def test_checkpoint_from_1x2_restores_onto_2x1(pair):
    for o in pair["out"]:
        c = o["ckpt"]
        assert c["restored_step"] == 1
        assert _rel(c["restored_loss"], c["tp_losses"][1]) <= TOL
    assert pair["out"][0]["ckpt"] == pair["out"][1]["ckpt"]
