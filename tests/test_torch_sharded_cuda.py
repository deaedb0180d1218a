"""The sharded serving round on the card: one rank on NCCL in this process.

The round graph of the sharded kind is captured as a CUDA graph with its
NCCL collectives inside and replayed a round; its outputs and final carry
equal the same rounds run uncaptured (``capture=False``) bit for bit, in
both tail modes, and equal the dense run's (the one-rank contract).  A
replay adds the capture's kernel launches and collectives to the counts
once a round.  Over gloo a session refuses ``capture=True``.

Needs an NVIDIA GPU and nvcc; skipped where CUDA is absent.  Run on the
card with ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_sharded_cuda.py``.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import dataclasses

import pytest
import torch

from repro_torch.core.cost_model import SystemConfig
from repro_torch.core.gating import GateConfig
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.mesh import host_mesh, single_rank_group
from repro_torch.serving.tree import tree_leaves
from repro_torch.serving.policy import make_policy
from repro_torch.serving.session import ServeSession
from repro_torch.serving.simulator import SimConfig, Simulator
from repro_torch.sharding.audit import collective_footprint, round_footprint

pytestmark = pytest.mark.cuda

SYS = SystemConfig()
M, R = 4096, 6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _policy(dev):
    return make_policy("r2evid", SYS, device=dev,
                       gate_cfg=GateConfig(d_feature=35),
                       generator=torch.Generator().manual_seed(0))


def _stream(dev):
    stream = Simulator(SYS, SimConfig(n_tasks=M, seed=0), device=dev
                       ).sample_stream(R, feature_seed=1)
    return dataclasses.replace(
        stream, bw_scale=torch.full((R,), 0.5, device=dev))


@pytest.mark.parametrize("hierarchical", [False, True])
def test_nccl_round_captured_equals_uncaptured_and_dense(dev, hierarchical):
    stream = _stream(dev)
    kw = dict(n_edge=16, n_cloud=8, device=dev)
    dense = ServeSession(_policy(dev), M, **kw).run(stream)
    with single_rank_group("nccl"):
        mesh = host_mesh()
        graphed = ServeSession(_policy(dev), M, mesh=mesh,
                               hierarchical=hierarchical, **kw)
        eager = ServeSession(_policy(dev), M, mesh=mesh, capture=False,
                             hierarchical=hierarchical, **kw)
        reset_launch_counts()
        got = graphed.run(stream)
        torch.cuda.synchronize()
        launches = launch_counts()
        (graph,) = graphed.graphs.values()
        assert graph.graph is not None and graph.replays == R - 1
        want = eager.run(stream)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], dense[k]), k
    for a, b in zip(tree_leaves(graphed.state), tree_leaves(eager.state),
                    strict=True):
        assert torch.equal(a, b)
    for name in ("gate_cell", "ccg_solve", "c6_repair", "lpt_queue"):
        assert launches.get(name) == R, (name, launches)


def test_replay_adds_the_captured_collectives(dev):
    stream = _stream(dev)
    with single_rank_group("nccl"):
        sess = ServeSession(_policy(dev), M, n_edge=16, n_cloud=8,
                            device=dev, mesh=host_mesh(), hierarchical=True)
        foot = round_footprint(collective_footprint(sess.run, stream), R)
        torch.cuda.synchronize()
        (graph,) = sess.graphs.values()
    per_round = len(graph.collectives)
    assert per_round == 2                # the (2,) gather and the 2-int psum
    assert foot["collectives_per_round"] == per_round
    assert foot["max_elements"] <= 4


def test_gloo_mesh_refuses_capture(dev):
    stream = _stream(dev)
    with single_rank_group("gloo"):
        sess = ServeSession(_policy(dev), M, device=dev, capture=True,
                            mesh=host_mesh())
        with pytest.raises(ValueError, match="capture=True needs an NCCL"):
            sess.run(stream)
        out = ServeSession(_policy(dev), M, device=dev,
                           mesh=host_mesh()).run(stream, n_rounds=2)
    assert out["route"].shape == (2, M)
