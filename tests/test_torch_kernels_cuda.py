"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA Hopper GPU and nvcc; skipped where CUDA is absent.  On a
machine with the card and without JAX (whose import ``tests/conftest.py``
needs), run ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_kernels_cuda.py``.
``gate_cell`` is held to 1e-5 absolute (its dot products sum in another
order than torch's GEMM); ``ccg_solve``, ``c6_tail`` and ``lpt_queue`` run
the plain versions' float32 operations in the same order with
``-fmad=false``, so they must match exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cost_model import SystemConfig, fps_norm, res_norm
from repro_torch.core.gating import GateConfig, init_gate_params
from repro_torch.core.robust import RobustProblem
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.c6_tail.ops import c6_tail
from repro_torch.kernels.ccg_solve.ops import ccg_solve
from repro_torch.kernels.lpt_queue.ops import lpt_queue
from repro_torch.kernels.temporal_gate.ops import gate_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(seed):
    return np.random.default_rng(seed)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("m", [4096, 4093, 5])
def test_gate_cell_kernel(dev, m):
    rng = _gen(m)
    p = init_gate_params(GateConfig(d_feature=35),
                         torch.Generator().manual_seed(m), dev)
    p = {k: v + 0.1 * torch.randn(v.shape, device=dev)
         if k.startswith("b_") else v for k, v in p.items()}
    dx = _t(rng.normal(size=(m, 35)).astype(np.float32), dev)
    h = _t(rng.uniform(-1, 1, (m, 32)).astype(np.float32), dev)
    vol = _t(rng.uniform(0, 2, m).astype(np.float32), dev)
    reset_launch_counts()
    got = gate_cell(dx, h, vol, p, force="kernel")
    want = gate_cell(dx, h, vol, p, force="ref")
    assert launch_counts() == {"gate_cell": 1}
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m", [4096, 4093, 37])
def test_ccg_solve_kernel(dev, m):
    prob = RobustProblem.build(SystemConfig(), dev)
    lat = prob.lat
    rng = _gen(m)
    z = rng.uniform(0, 1, m).astype(np.float32)
    aq = rng.uniform(0.5, 0.8, m).astype(np.float32)
    aq[:3] = [0.99, 0.97, 1.2]
    wy = rng.integers(-1, 50, m).astype(np.int32)
    args = (_t(z, dev), _t(aq, dev), lat.rn_flat, lat.pn_flat, lat.tier_flat,
            lat.b2_flat, prob.u_all, lat.c1_flat, _t(wy, dev))
    kw = dict(margin=0.02, num_versions=5)
    got = ccg_solve(*args, force="kernel", **kw)
    want = ccg_solve(*args, force="ref", **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m", [4096, 4093, 300])
def test_c6_tail_kernel(dev, m):
    sys_ = SystemConfig()
    prob = RobustProblem.build(sys_, dev)
    rng = _gen(m)
    ints = [_t(rng.integers(0, n, m).astype(np.int32), dev)
            for n in (5, 5, 5, 2)]
    panel = torch.movedim(prob.lat.bw, -1, 0)[ints[3].long()].reshape(m, -1)
    z = _t(rng.uniform(0, 1, m).astype(np.float32), dev)
    thr = _t(rng.uniform(0.5, 0.8, m).astype(np.float32), dev)
    args = (panel, *ints, z, thr, res_norm(sys_, dev), fps_norm(sys_, dev))
    got = c6_tail(*args, n_fps=5, force="kernel")
    want = c6_tail(*args, n_fps=5, force="ref")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(1, 4096), (3, 257)])
def test_lpt_queue_kernel(dev, shape):
    rng = _gen(shape[1])
    t = rng.uniform(0.01, 1.0, shape).astype(np.float32)
    t.reshape(-1)[:8] = 0.25
    route = rng.integers(0, 2, shape).astype(np.int32)
    got = lpt_queue(_t(t, dev), _t(route, dev), 4, 1, force="kernel")
    want = lpt_queue(_t(t, dev), _t(route, dev), 4, 1, force="ref")
    assert torch.equal(got, want)
