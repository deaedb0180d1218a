"""The split trainer's sequence-parallel residual and its gradient reduced
a layer at a time inside the backward, on the CPU: float32 SMOKE configs
on 4 gloo ranks, every case of both mesh shapes in one world, held against
the port itself (no JAX run: the residual split changes no numbers).

* Qwen1.5-0.5B, Moonshot-v1-16B-A3B, Falcon-Mamba-7B and RecurrentGemma-9B
  at (data, model) = (1, 4), and Qwen1.5-0.5B at (2, 2), 2 steps under the
  train rules (``act_seq_sp`` onto ``"model"``) against the same steps
  with ``act_seq_sp`` mapped to None: losses, the gradient blocks that
  AdamW gets and the blocks after the last step bit-equal.
* The residual that remat saves at every unit's edge has S/4 rows at
  (1, 4) (S rows without the split), and every unit records its residual
  mode; at S = 14, which 4 ranks do not divide, the residual stays whole
  and the units say so.
* The attention-only prefill under ``rules_for`` (which maps
  ``act_seq_sp`` onto ``"model"``) bit-equal to the same prefill with it
  mapped to None: logits and every cache block.
* Gradient accumulation and compression on the split trainer against the
  port's one-device ``Trainer`` from the same seeded init, 3 steps at lr
  1e-3: Qwen (2, 2) and Moonshot, Falcon-Mamba (1, 4) with ``grad_accum``
  2, RecurrentGemma (2, 2) ``grad_accum`` 2, Mixtral (1, 4) with
  compression, Qwen (1, 4) with both; losses and gradient norms within
  1e-6 relative, whole parameters within 1e-4.
* A step's gradient blocks go with the step: with Python's cyclic
  collector off, the tensors alive after steps 2, 3 and 4 of a world of
  one take the same bytes (a cycle between the reducer and its leaves
  once kept every step's blocks until the collector ran).
* The view-shaped gradient bytes that the reducer holds at once
  (``params.VIEW_GRADS``) are at most the largest unit's views' (plus, for
  a tied table, the head's view gradient, which waits for the
  embedding's), and less than all the views' that a reduce after the
  whole backward held.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import gc
import warnings

import numpy as np
import pytest
import torch
from torch_train_ranks import OPT, smoke_f32
from torch_train_sp import world

from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import make_host_mesh, run_ranks, \
    single_rank_group
from repro_torch.models.params import tree_leaves
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer

SEQ = 32
SP_CASES = [{"name": f"{a}@1x4", "arch": a, "shape": (1, 4)}
            for a in ("qwen1.5-0.5b", "moonshot-v1-16b-a3b",
                      "falcon-mamba-7b", "recurrentgemma-9b")] + [
    {"name": "qwen1.5-0.5b@2x2", "arch": "qwen1.5-0.5b", "shape": (2, 2)}]
WHOLE_SEQ = 14                  # 4 ranks do not divide it
WHOLE_CASE = {"arch": "qwen1.5-0.5b", "shape": (1, 4)}
PREFILLS = ("qwen1.5-0.5b", "mixtral-8x22b")
ACCUM_CASES = [
    {"name": "qwen_accum@2x2", "arch": "qwen1.5-0.5b", "shape": (2, 2),
     "tcfg": {"grad_accum": 2}},
    {"name": "moonshot_accum@1x4", "arch": "moonshot-v1-16b-a3b",
     "shape": (1, 4), "tcfg": {"grad_accum": 2}},
    {"name": "falcon_accum@1x4", "arch": "falcon-mamba-7b", "shape": (1, 4),
     "tcfg": {"grad_accum": 2}},
    {"name": "recurrentgemma_accum@2x2", "arch": "recurrentgemma-9b",
     "shape": (2, 2), "tcfg": {"grad_accum": 2}},
    {"name": "mixtral_compress@1x4", "arch": "mixtral-8x22b", "shape": (1, 4),
     "tcfg": {"grad_compression": True}},
    {"name": "qwen_accum_compress@1x4", "arch": "qwen1.5-0.5b",
     "shape": (1, 4), "tcfg": {"grad_accum": 2, "grad_compression": True}}]
ACCUM_STEPS = 3
REL_TOL, PARAM_TOL = 1e-6, 1e-4


def _batches(arch, steps, seq=SEQ):
    cfg = smoke_f32(arch)
    it = iter(TokenPipeline(cfg.vocab_size, seq, 8, seed=3))
    return [next(it) for _ in range(steps)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_sp")
    rng = np.random.default_rng(9)
    prefills = {a: (rng.integers(0, smoke_f32(a).vocab_size, (2, SEQ)),
                    (1, 4)) for a in PREFILLS}
    archs = {c["arch"] for c in ACCUM_CASES}
    accum_batches = {a: _batches(a, ACCUM_STEPS) for a in archs}
    out = run_ranks(world, 4, backend="gloo", timeout=300, args=(
        SP_CASES, {c["arch"]: _batches(c["arch"], 2) for c in SP_CASES},
        WHOLE_CASE, _batches(WHOLE_CASE["arch"], 1, WHOLE_SEQ), prefills,
        ACCUM_CASES, accum_batches, str(tmp / "r")))
    return {"out": out, "accum_batches": accum_batches}


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("case", SP_CASES, ids=[c["name"] for c in SP_CASES])
def test_sequence_split_residual_is_bit_equal(runs, case):
    for rank in runs["out"]:
        sp, none = (rank["sp"][case["name"]][k] for k in ("sp", "none"))
        assert sp["loss"] == none["loss"]
        assert sp["loss"] == runs["out"][0]["sp"][case["name"]]["sp"]["loss"]
        for got, want in zip(sp["grads"], none["grads"], strict=True):
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(g, w)
        for g, w in zip(sp["params"], none["params"], strict=True):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", [c for c in SP_CASES if c["shape"] == (1, 4)],
                         ids=lambda c: c["name"])
def test_remat_saves_the_rank_range_at_each_unit_edge(runs, case):
    cfg = smoke_f32(case["arch"])
    units = -(-cfg.num_layers // len(cfg.layer_pattern))
    for rank in runs["out"]:
        sp, none = (rank["sp"][case["name"]][k] for k in ("sp", "none"))
        # forward and recompute, 2 steps
        assert sp["residual"] == {"seq": 2 * 2 * units}, sp["residual"]
        assert none["residual"] == {"whole": 2 * 2 * units}
        assert sp["edges"] == [(8, SEQ // 4, cfg.d_model)] * (2 * units)
        assert none["edges"] == [(8, SEQ, cfg.d_model)] * (2 * units)


def test_a_sequence_four_ranks_do_not_divide_stays_whole(runs):
    cfg = smoke_f32(WHOLE_CASE["arch"])
    for rank in runs["out"]:
        r = rank["whole"]
        assert r["residual"] == {"whole": 2 * cfg.num_layers}
        assert r["edges"] == [(8, WHOLE_SEQ, cfg.d_model)] * cfg.num_layers
        assert np.isfinite(r["loss"]).all()


@pytest.mark.parametrize("arch", PREFILLS)
def test_prefill_sequence_split_is_bit_equal(runs, arch):
    for rank in runs["out"]:
        sp, none = rank["prefill"][arch]["sp"], rank["prefill"][arch]["none"]
        n = smoke_f32(arch).num_layers
        assert sp["residual"] == {"seq": n} and none["residual"] == {"whole": n}
        np.testing.assert_array_equal(sp["logits"], none["logits"])
        got, want = tree_leaves(sp["cache"]), tree_leaves(none["cache"])
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _one_device(case, batches, tmp):
    tr = Trainer(smoke_f32(case["arch"]), TrainConfig(
        steps=ACCUM_STEPS, ckpt_dir=str(tmp), opt=AdamWConfig(**OPT),
        **case["tcfg"]), device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(4))
    out = {"loss": [], "grad_norm": []}
    for b in batches:
        *state, m = tr._step(*state, tr._device_batch(b))
        for k in out:
            out[k].append(float(m[k]))
    out["params"] = [t.numpy() for t in tree_leaves(state[0])]
    return out


@pytest.mark.parametrize("case", ACCUM_CASES, ids=[c["name"] for c in ACCUM_CASES])
def test_accumulation_and_compression_hold_one_device(runs, case, tmp_path):
    want = _one_device(case, runs["accum_batches"][case["arch"]], tmp_path)
    ranks = [r["accum"][case["name"]] for r in runs["out"]]
    for k in ("loss", "grad_norm"):
        assert all(r[k] == ranks[0][k] for r in ranks), k
        for got, w in zip(ranks[0][k], want[k], strict=True):
            assert _rel(got, w) <= REL_TOL, (k, got, w)
    got = tree_leaves(ranks[0]["params"])
    for g, w in zip(got, want["params"], strict=True):
        assert float(np.abs(g - w).max()) <= PARAM_TOL


@pytest.mark.parametrize("case", SP_CASES, ids=[c["name"] for c in SP_CASES])
def test_view_gradients_held_are_about_one_unit(runs, case):
    for rank in runs["out"]:
        for r in rank["sp"][case["name"]].values():
            for peak, unit in zip(r["view_peak"], r["largest_unit"]):
                assert 0 < peak <= unit + r["tied_view"], (peak, unit)
                assert peak < r["all_views"], (peak, r["all_views"])


def _live_cpu_bytes() -> int:
    seen, total = set(), 0
    with warnings.catch_warnings():     # deprecated objects among them
        warnings.simplefilter("ignore")
        objs = [o for o in gc.get_objects() if isinstance(o, torch.Tensor)]
    for obj in objs:
        if obj.device.type == "cpu":
            storage = obj.untyped_storage()
            if storage.data_ptr() not in seen:
                seen.add(storage.data_ptr())
                total += storage.nbytes()
    return total


def test_a_step_leaves_no_gradient_blocks_behind(tmp_path):
    arch = "qwen1.5-0.5b"
    live = []
    gc.collect()
    gc.disable()
    try:
        with single_rank_group("gloo"):
            tr = Trainer(smoke_f32(arch), TrainConfig(
                steps=4, ckpt_dir=str(tmp_path), opt=AdamWConfig(**OPT)),
                mesh=make_host_mesh((1, 1)), device="cpu")
            state = tr.init_state(torch.Generator().manual_seed(4))
            for b in _batches(arch, 4):
                *state, _ = tr._step(*state, tr._device_batch(b))
                live.append(_live_cpu_bytes())
    finally:
        gc.enable()
    assert live[1] == live[2] == live[3], live
