"""Training across ranks on the card, at SMOKE size (the kernels: the
flash attention's forward and backward).

* A world of one on NCCL at mesh (1, 1), in this process, is bit-equal to
  the one-device ``Trainer`` over 3 steps: losses, every master and
  moment, in bf16 with gradient accumulation and compression.
* Two gloo ranks sharing the card at mesh (2, 1) (``run_ranks``, the rank
  function in ``torch_train_ranks.py``) give the same losses on both
  ranks, within 1e-3 relative of the one-device run in bf16 (the rows of
  a step split over the ranks: the bf16 weight gradients round per rank).
* Where two cards exist, two NCCL ranks at mesh (2, 1) save a sharded
  checkpoint three times over one step and restore it bit for bit, its
  manifest listing both ranks (the save's barriers block each host).

Needs an NVIDIA GPU and nvcc; skipped where CUDA is absent.  Run on the
card with ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_train_ranks_cuda.py``.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import pytest
import torch
from torch_train_ranks import OPT, checkpoint_roundtrip, cuda_rank_losses

from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import make_host_mesh, run_ranks, \
    single_rank_group
from repro_torch.models.params import tree_leaves
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer

pytestmark = pytest.mark.cuda

CFG = get_smoke_config("qwen1.5-0.5b")          # bf16 compute
KW = {"grad_accum": 2, "grad_compression": True}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batches(n=3):
    it = iter(TokenPipeline(CFG.vocab_size, 64, 8, seed=3))
    return [next(it) for _ in range(n)]


def _run(tr, dev):
    state = tr.init_state(torch.Generator(dev).manual_seed(0))
    losses = []
    for b in _batches():
        *state, m = tr._step(*state, tr._device_batch(b))
        losses.append(float(m["loss"]))
    return state, losses


def _tcfg(tmp_path, name, **kw):
    return TrainConfig(steps=3, ckpt_dir=str(tmp_path / name),
                       opt=AdamWConfig(**OPT), **kw)


def test_nccl_world_of_one_is_bit_equal_to_one_device(dev, tmp_path):
    want_state, want = _run(Trainer(CFG, _tcfg(tmp_path, "one", **KW),
                                    device=dev), dev)
    with single_rank_group("nccl"):
        tr = Trainer(CFG, _tcfg(tmp_path, "w1", **KW),
                     mesh=make_host_mesh((1, 1)), device=dev)
        state, got = _run(tr, dev)
    assert got == want
    leaves = lambda s: tree_leaves(s[0]) + tree_leaves(s[1].mu) + \
        tree_leaves(s[1].nu) + tree_leaves(s[2])
    for a, b in zip(leaves(state), leaves(want_state)):
        assert torch.equal(a, b)


def test_two_gloo_ranks_on_the_card_match_one_device(dev, tmp_path):
    _, want = _run(Trainer(CFG, _tcfg(tmp_path, "one"), device=dev), dev)
    ranks = run_ranks(cuda_rank_losses, 2, backend="gloo", timeout=300,
                      threads=None, args=(_batches(), str(tmp_path / "r")))
    assert ranks[0] == ranks[1]
    for got, w in zip(ranks[0], want):
        assert abs(got - w) <= 1e-3 * abs(w), (ranks[0], want)


def test_sharded_checkpoint_roundtrip_on_two_nccl_ranks(dev, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (NCCL takes one rank a card)")
    got = run_ranks(checkpoint_roundtrip, 2, backend="nccl", timeout=300,
                    threads=None, args=("cuda", str(tmp_path / "ckpt")))
    for r in got:
        assert r == {"same": True, "step": 1,
                     "ranks": ["rank_0", "rank_1"]}
