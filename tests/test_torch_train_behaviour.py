"""The reference trainer's behaviours (``tests/test_trainer.py``) on the
port's ``Trainer``, on the CPU: the SMOKE Qwen1.5-0.5B config in its own
bf16 compute, ``TokenPipeline`` batches of 4 × 64, AdamW at lr 2e-3.

* The loss falls over 40 steps (the mean of the last two logged losses
  under the first two).
* A ``FailureInjector`` failure at step 17 leaves the checkpoint of step 10
  as the latest; a fresh trainer resumes from it and reaches step 40, and
  its first logged step is past 10.
* Training with int8 error-feedback gradient compression also lowers the
  loss over 30 steps.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.runtime.cluster import FailureInjector
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import NodeFailure, TrainConfig, Trainer


def _setup(tmp_path, steps=40, **kw):
    cfg = get_smoke_config("qwen1.5-0.5b")
    tcfg = TrainConfig(steps=steps, ckpt_every=10, ckpt_dir=str(tmp_path),
                       log_every=5, opt=AdamWConfig(
                           lr=2e-3, warmup_steps=5, total_steps=steps), **kw)
    return cfg, tcfg, iter(TokenPipeline(cfg.vocab_size, 64, 4, seed=0))


def _falls(hist):
    first = np.mean([h["loss"] for h in hist[:2]])
    last = np.mean([h["loss"] for h in hist[-2:]])
    return last < first, (first, last)


def test_loss_decreases(tmp_path):
    cfg, tcfg, data = _setup(tmp_path)
    _, hist = Trainer(cfg, tcfg, device="cpu").run(data)
    assert [h["step"] for h in hist] == list(range(5, 41, 5))
    ok, losses = _falls(hist)
    assert ok, losses


def test_failure_resume_continuity(tmp_path):
    cfg, tcfg, data = _setup(tmp_path, steps=30)
    tr = Trainer(cfg, tcfg, device="cpu",
                 failure_injector=FailureInjector(schedule={17: "node 1"}))
    with pytest.raises(NodeFailure):
        tr.run(data)
    assert tr.step == 17 and tr.ckpt.latest_step() == 10
    # a fresh trainer resumes from step 10 and reaches 40
    tr2 = Trainer(cfg, tcfg, device="cpu")
    _, hist = tr2.run(data)
    assert tr2.step == 40
    assert hist[0]["step"] > 10
    assert tr2.ckpt.latest_step() == 40


def test_grad_compression_trains(tmp_path):
    cfg, tcfg, data = _setup(tmp_path, steps=30, grad_compression=True)
    _, hist = Trainer(cfg, tcfg, device="cpu").run(data)
    ok, losses = _falls(hist)
    assert ok, losses
