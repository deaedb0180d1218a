"""The port's optimizer, gradient compression, token pipeline and
checkpoints against the live JAX package and the reference's own tests.

* AdamW ``update`` on identical gradients, moments and parameters (a
  clipped step and an unclipped one, inside the warm-up and on the cosine):
  parameters, μ and ν within 1e-6 relative (float32 on both sides; ``pow``
  and ``cos`` may round their last bit otherwise); the in-place update
  equal to the functional one bit for bit.
* ``lr_at`` at the reference test's points, within 1e-6 relative of the
  reference's values, and that test's own assertions.
* ``compress`` / ``decompress`` / ``ef_compress_grads`` exactly: the int8
  codes, scales, wire gradients and error buffers bit for bit over 50
  steps (both round half to even).
* ``TokenPipeline`` batches equal to the reference's for token, M-RoPE and
  embedding-input configs.
* Checkpoints: a roundtrip exact in every dtype (bfloat16 and int32
  included), retention and the latest step, a failed save leaving the
  previous checkpoint whole, restore onto a named device and into the
  target's dtypes.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import json
import os

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
import jax.numpy as jnp
from repro.data.tokens import TokenPipeline as JTokens
from repro.train.compression import compress as j_compress
from repro.train.compression import ef_compress_grads as j_ef
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import AdamWState as JAdamWState
from repro.train.optimizer import lr_at as j_lr_at
from repro.train.optimizer import update as j_update
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import CheckpointManager, restore, save
from repro_torch.convert import opt_state_from_numpy, opt_state_to_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train.compression import (
    compress,
    decompress,
    ef_compress_grads,
)
from repro_torch.train.optimizer import AdamWConfig, init, lr_at
from repro_torch.train.optimizer import update

OPT_RTOL = 1e-6


def _tree(rng, scale=1.0):
    n = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    return {"embed": {"tok": n(12, 8)}, "segments": [
        {"pos0": {"w": n(2, 8, 6), "b": n(2, 6)}}], "final_norm": n(8)}


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("step,grad_scale", [(3, 0.01), (3, 5.0),
                                             (40, 0.01), (40, 5.0)])
def test_update_matches_the_reference(step, grad_scale):
    rng = np.random.default_rng(step)
    params, grads = _tree(rng), _tree(rng, grad_scale)
    mu, nu = _tree(rng, 0.01), tree_map(np.abs, _tree(rng, 0.001))
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    jstate = JAdamWState(step=jnp.asarray(step, jnp.int32),
                         mu=jax.tree_util.tree_map(jnp.asarray, mu),
                         nu=jax.tree_util.tree_map(jnp.asarray, nu))
    jp, js, jm = j_update(JAdamWConfig(**cfg),
                          jax.tree_util.tree_map(jnp.asarray, grads), jstate,
                          jax.tree_util.tree_map(jnp.asarray, params))
    state = opt_state_from_numpy(jstate, "cpu")
    p, s, m = update(AdamWConfig(**cfg), _torch(grads), state,
                     _torch(params))
    assert int(s.step) == step + 1
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=OPT_RTOL)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=OPT_RTOL)
    got = opt_state_to_numpy(s)
    assert got["step"] == step + 1
    for a, b in ((tree_map(lambda t: t.numpy(), p), jp), (got["mu"], js.mu),
                 (got["nu"], js.nu)):
        tree_map(lambda x, y: np.testing.assert_allclose(
            x, np.asarray(y), rtol=OPT_RTOL, atol=1e-9), a, b)
    # in place: the same numbers, written into the given tensors
    state2 = opt_state_from_numpy(jstate, "cpu")
    params2 = _torch(params)
    p2, s2, _ = update(AdamWConfig(**cfg), _torch(grads), state2, params2,
                       inplace=True)
    for x, y in zip(tree_leaves(p2) + tree_leaves(s2.mu),
                    tree_leaves(p) + tree_leaves(s.mu)):
        assert torch.equal(x, y)
    assert tree_leaves(p2)[0] is tree_leaves(params2)[0]
    assert tree_leaves(s2.nu)[0] is tree_leaves(state2.nu)[0]


def test_init_is_float32_zeros_at_step_zero():
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      _torch(_tree(np.random.default_rng(0))))
    state = init(params)
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    for m, v, p in zip(tree_leaves(state.mu), tree_leaves(state.nu),
                       tree_leaves(params)):
        assert m.dtype == v.dtype == torch.float32 and m.shape == p.shape
        assert not m.any() and not v.any() and m is not v


def test_lr_schedule_matches_the_reference():
    ocfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    points = (0, 5, 10, 50, 100)
    lrs = [float(lr_at(AdamWConfig(**ocfg), s)) for s in points]
    want = [float(j_lr_at(JAdamWConfig(**ocfg), jnp.asarray(s)))
            for s in points]
    np.testing.assert_allclose(lrs, want, rtol=OPT_RTOL)
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3, rel=0.2)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=0.05)


def test_compression_is_the_references_bit_for_bit():
    rng = np.random.default_rng(0)
    g = (0.1 * rng.normal(size=(256, 64))).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 1.5, 2.5]        # halves of the int8 grid
    q, s = compress(torch.from_numpy(g))
    jq, js = j_compress(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    err = (decompress(q, s) - torch.from_numpy(g)).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-7

    err_t = err_j = None
    true_sum = wire_sum = 0.0
    for _ in range(50):
        grads = {"w": (0.01 * rng.normal(size=32)).astype(np.float32),
                 "b": [(rng.normal(size=(3, 4))).astype(np.float32)]}
        wire, err_t = ef_compress_grads(_torch(grads), err_t)
        jwire, err_j = j_ef(jax.tree_util.tree_map(jnp.asarray, grads), err_j)
        for a, b in ((wire, jwire), (err_t, err_j)):
            tree_map(lambda x, y: np.testing.assert_array_equal(
                x.numpy(), np.asarray(y)), a, b)
        true_sum = true_sum + grads["w"]
        wire_sum = wire_sum + wire["w"].numpy()
    # error feedback: the residual stays one quantization step, not O(T)
    assert float(np.abs(true_sum - wire_sum).max()) < 5e-4


@pytest.mark.parametrize("embed_inputs,mrope", [(True, False), (True, True),
                                                (False, False)])
def test_token_pipeline_batches_equal_the_references(embed_inputs, mrope):
    kw = dict(seed=7, d_model=16, embed_inputs=embed_inputs, mrope=mrope)
    ours, ref = TokenPipeline(50, 33, 3, **kw), JTokens(50, 33, 3, **kw)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
def _ckpt_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(16, 8, generator=g),
            "nested": {"c": torch.ones(3, dtype=torch.bfloat16) / 3,
                       "b": torch.arange(10, dtype=torch.int32)},
            "list": [torch.randn(2, 2, generator=g).to(torch.bfloat16),
                     torch.tensor(7, dtype=torch.int32)]}


def test_roundtrip_exact(tmp_path):
    tree = _ckpt_tree()
    save(str(tmp_path / "x"), tree, extra={"step": 7})
    out, extra = restore(str(tmp_path / "x"), tree)
    assert extra["step"] == 7
    assert list(out) == list(tree) and list(out["nested"]) == ["c", "b"]
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference's leaf order: dict keys sorted, lists in order
    manifest = json.loads((tmp_path / "x" / "manifest.json").read_text())
    assert [m["path"] for m in manifest["leaves"]] == [
        "/a", "/list/0", "/list/1", "/nested/b", "/nested/c"]
    assert manifest["leaves"][1]["dtype"] == "bfloat16"


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore_latest(_ckpt_tree()) == (None, None)
    for step in (10, 20, 30):
        mgr.save(step, _ckpt_tree(step))
    assert mgr.latest_step() == 30
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == ["step_20", "step_30"]
    out, extra = mgr.restore_latest(_ckpt_tree())
    assert extra["step"] == 30
    assert torch.equal(out["a"], _ckpt_tree(30)["a"])


def test_failed_save_does_not_clobber(tmp_path, monkeypatch):
    path = str(tmp_path / "z")
    save(path, _ckpt_tree(3), extra={"v": 1})

    class Boom(Exception):
        pass

    def bad_bytes(t):
        raise Boom()

    # fail inside the temporary directory's write
    monkeypatch.setattr(manager, "_leaf_bytes", bad_bytes)
    with pytest.raises(Boom):
        save(path, _ckpt_tree(4), extra={"v": 2})
    out, extra = restore(path, _ckpt_tree())
    assert extra["v"] == 1
    assert torch.equal(out["a"], _ckpt_tree(3)["a"])
    assert [d for d in os.listdir(tmp_path) if d.startswith(".ckpt_tmp_")] \
        == []


def test_restore_onto_a_named_device_and_dtype(tmp_path):
    tree = _ckpt_tree(5)
    save(str(tmp_path / "y"), tree)
    # the target gives structure and dtypes only: leaves on the meta device
    target = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                            device="meta"), tree)
    out, _ = restore(str(tmp_path / "y"), target, device="cpu")
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        assert b.device.type == "cpu" and b.dtype == torch.float32
        assert torch.equal(a.float(), b)
    with pytest.raises(ValueError, match="leaves"):
        restore(str(tmp_path / "y"), {"a": tree["a"]})
