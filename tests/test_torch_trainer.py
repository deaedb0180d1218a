"""The port's ``Trainer``, step builders and training launcher against the
live JAX package, on the SMOKE Qwen1.5-0.5B config.

* One ``Trainer._step`` against the reference trainer's ``_step_fn`` from
  the same converted init and the same batch, float32 compute (as the
  reference's accumulation test, which notes that bf16 amplifies order
  differences through Adam's sign-like first step): the loss and the
  gradient norm within 1e-5 relative, every updated parameter within 1e-6
  absolute and the moments within 1e-5 of max(1e-3, the leaf's largest
  |entry|) (sums in another order).
* ``grad_accum`` 4 equals 1 within 5e-5 (the reference's own test).
* ``make_train_step`` gives ``Trainer._step``'s numbers bit for bit (the
  same operations, out of place); the prefill and serve step builders are
  ``prefill`` and ``decode_step``; ``applicable_shapes`` is the
  reference's for every registry config; the step builders refuse
  sharding rules (A.16d), the ``Trainer`` a mesh that is not a
  ``DeviceMesh``.
* ``python -m repro_torch.launch.train --smoke --device cpu --steps 4``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.launch.steps import applicable_shapes as j_applicable_shapes
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import (
    model_params_from_numpy,
    opt_state_to_numpy,
    tree_to_numpy,
)
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import steps
from repro_torch.launch import train as train_launcher
from repro_torch.models.layers import Ctx
from repro_torch.models.model import model_specs, prefill
from repro_torch.models.params import init_params, tree_leaves, tree_map
from repro_torch.runtime.cluster import FailureInjector
from repro_torch.train.optimizer import AdamWConfig, init
from repro_torch.train.trainer import NodeFailure, TrainConfig, Trainer

ARCH = "qwen1.5-0.5b"
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=2)


def _f32(arch=ARCH):
    return (dataclasses.replace(j_smoke(arch), compute_dtype="float32"),
            dataclasses.replace(get_smoke_config(arch),
                                compute_dtype="float32"))


def _batch(cfg, seq=32, batch=8, seed=3):
    return next(TokenPipeline(cfg.vocab_size, seq, batch, seed=seed))


def _reference_init(jcfg, tmp_path, **kw):
    jtr = JTrainer(jcfg, JTrainConfig(steps=1, ckpt_dir=str(tmp_path / "j"),
                                      opt=JAdamWConfig(**OPT), **kw))
    params, opt_state, err = jtr.init_state(jax.random.PRNGKey(9))
    return jtr, jax.tree_util.tree_map(np.asarray, params), (params,
                                                             opt_state, err)


def _port_trainer(cfg, tmp_path, **kw):
    return Trainer(cfg, TrainConfig(steps=1, ckpt_dir=str(tmp_path / "t"),
                                    opt=AdamWConfig(**OPT), **kw),
                   device="cpu")


def _state(cfg, jp):
    """Float32 masters (the compute dtype here) from the reference's init."""
    params = model_params_from_numpy(jp, cfg, "cpu")
    return params, init(params), None


def test_one_step_matches_the_reference_trainer(tmp_path):
    jcfg, cfg = _f32()
    batch = _batch(cfg)
    jtr, jp, jstate = _reference_init(jcfg, tmp_path)
    jparams, jopt, _, jm = jtr._step_fn(
        *jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tr = _port_trainer(cfg, tmp_path)
    params, opt, _, m = tr._step(*_state(cfg, jp), tr._device_batch(batch))

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    tree_map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                     rtol=0, atol=1e-6),
             tree_to_numpy(params), jparams)
    got = opt_state_to_numpy(opt)
    assert got["step"] == int(jopt.step) == 1

    def moment(a, b):
        b = np.asarray(b)
        scale = max(1e-3, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) <= 1e-5 * scale

    tree_map(moment, got["mu"], jopt.mu)
    tree_map(moment, got["nu"], jopt.nu)


def test_grad_accumulation_matches_full_batch(tmp_path):
    jcfg, cfg = _f32()
    _, jp, _ = _reference_init(jcfg, tmp_path)
    batch = _batch(cfg)
    outs = {}
    for accum in (1, 4):
        tr = _port_trainer(cfg, tmp_path, grad_accum=accum)
        outs[accum], *_ = tr._step(*_state(cfg, jp), tr._device_batch(batch))
    worst = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(outs[1]), tree_leaves(outs[4])))
    assert worst < 5e-5, worst


def test_train_step_builder_matches_the_trainer(tmp_path):
    jcfg, cfg = _f32()
    _, jp, _ = _reference_init(jcfg, tmp_path)
    batch = _batch(cfg, batch=2)
    tr = _port_trainer(cfg, tmp_path)
    want, want_opt, _, wm = tr._step(*_state(cfg, jp),
                                     tr._device_batch(batch))
    params, opt, _ = _state(cfg, jp)
    step = steps.make_train_step(cfg, None, AdamWConfig(**OPT))
    got, got_opt, gm = step(params, opt, tr._device_batch(batch))
    for a, b in zip(tree_leaves(got) + tree_leaves(got_opt.nu),
                    tree_leaves(want) + tree_leaves(want_opt.nu)):
        assert torch.equal(a, b)
    assert float(gm["loss"]) == float(wm["loss"])
    # out of place: the inputs keep their values
    assert torch.equal(tree_leaves(params)[0],
                       tree_leaves(_state(cfg, jp)[0])[0])


def test_serve_step_builders_are_prefill_and_decode(tmp_path):
    _, cfg = _f32()
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    tokens = torch.from_numpy(_batch(cfg, seq=8, batch=2)["tokens"]).long()
    logits, cache = steps.make_prefill_step(cfg, None)(
        params, {"tokens": tokens})
    want, _ = prefill(Ctx(cfg=cfg), params, {"tokens": tokens})
    assert torch.equal(logits, want)
    nxt, cache = steps.make_serve_step(cfg, None)(
        params, cache, {"tokens": logits.argmax(-1)[:, None]})
    assert nxt.shape == logits.shape and int(cache["length"]) == 9
    for arch in ARCH_IDS:
        assert steps.applicable_shapes(get_config(arch)) == \
            j_applicable_shapes(j_get_config(arch))
    for make in (steps.make_prefill_step, steps.make_serve_step):
        with pytest.raises(NotImplementedError, match="A.16d"):
            make(cfg, object())
    with pytest.raises(NotImplementedError, match="A.16d"):
        steps.make_train_step(cfg, object(), AdamWConfig())
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path / "m")),
                mesh=object(), device="cpu")


def test_failure_injector_fires_each_scheduled_step_once():
    inj = FailureInjector(schedule={3: "node 1 lost"})
    inj(2)
    with pytest.raises(NodeFailure, match="step 3: node 1 lost"):
        inj(3)
    inj(3)
    assert inj.fired == {3}


def test_launcher_trains_the_smoke_model_on_the_cpu(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    assert train_launcher.main([
        "--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
        "--seq", "32", "--ckpt-every", "2", "--ckpt-dir", str(ckpt)]) == 0
    out = capsys.readouterr().out
    assert "done: 4 steps, arch=qwen1.5-0.5b-smoke, device=cpu" in out
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_2", "step_4"]
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 1 and np.isfinite(losses).all()
