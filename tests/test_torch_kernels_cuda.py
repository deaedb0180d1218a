"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA Hopper GPU and nvcc; skipped where CUDA is absent.  On a
machine with the card and without JAX (whose import ``tests/conftest.py``
needs), run ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_kernels_cuda.py``.
``gate_cell`` is held to 1e-5 absolute (its dot products sum in another
order than torch's GEMM) and must give the bits of its order of work
emulated on the card (``torch_kernel_orders``); ``gate_cell_bwd`` to 1e-5
of max(1, each weight gradient's largest sum over the streams of |a
stream's term|) (its weight gradients sum the B streams in tiles of 32,
then the tiles: 4.5e-7 of the largest entry in float32 on the CPU at
B = 4096; a gradient that cancels, as alpha, is held to its terms' size)
and dh to 1e-5 of max(1, its largest |entry|), and two of its launches
give the same bits; ``c6_repair`` must give
the bits of its emulated order (one block up to 16,384 tasks, one thread
block cluster up to 262,144) and equal the plain version's r and p
outside the boundary exemption of ``test_torch_c6_repair.py`` (the draw and
the prefix gains sum in another order than torch's); two cluster launches,
and a captured one, give the same bits; ``ccg_solve``,
``c6_tail``, ``lpt_queue``,
``ccg_encode`` and ``ccg_master`` run the plain versions' float32 operations
in the same order with ``-fmad=false`` (or only exact ones: min, max,
compares), so they must match exactly; ``ccg_solve`` and ``ccg_encode``
on both of their paths (tables built once a block for K <= 5 where they
fit, else per-task recomputation).  ``decode_attention`` and
``flash_attention`` sum in another order than the plain versions and round
each probability to the value type before P·V (as the TPU kernels do): they
are held to |kernel − plain| <= 2e-5 + 2e-5·|plain| in float32 and
2e-2 + 2e-2·|plain| in bfloat16 (two bf16 ulps near 1), the tolerances of
the reference's own kernel tests.  ``mamba_scan`` and ``rglru_scan`` repeat
the plain versions' float32 state updates in order with ``-fmad=false``;
the selective scan takes exp(dt·A) in base 2 on the special function unit
and sums y in another order than torch's einsum, so both are held to
1e-5 + 1e-5·|plain| (their outputs are float32 whatever the input dtype).
With runtime positions (``positions=``), ``flash_attention`` masks by
them (same tolerances), and positions 0..S-1 give the index launch's bits.
``flash_attention_bwd`` (dq, dk, dv) is held to ``attention_vjp_ref`` within
1e-5 (float32) and 2e-2 (bfloat16: its Δ = rowsum(dO∘O) reads the rounded
output, and the tensor-core kernels round P and dS to bf16 before their
products) of each gradient's largest |entry|, and two of its launches give
the same bits.  The forward's training launch (``return_lse``) gives the
serving launch's bits and each row's LSE within 1e-5 of the plain one.
``mamba_scan_bwd`` and ``rglru_scan_bwd`` are held to their plain VJPs
within 1e-5 of each gradient's largest |entry| (they sum over channels,
steps and rows in another order, and the selective scan's dA is taken on
the SFU), a bf16 gradient also within one bf16 rounding of each entry;
``rglru_scan_bwd``'s dx, dr, di and dh0 repeat the plain float32
operations in order and must match bit for bit; two launches of each give
the same bits; the selective scan's training launch gives the serving
launch's bits, and its backward recomputes the forward's final state bit
for bit.  The recurrent SMOKE models train on the kernel path.  Kernels
without a backward refuse inputs that need a gradient.
The bf16 flash kernel copies 16-byte row chunks: misaligned rows raise.
The decode kernel splits each cache over a cluster of blocks and combines
the splits in a fixed order (two calls are bit-equal); bf16 rows on 16-byte
boundaries at D = 64/128/256 take its tensor-core instantiation, other
rows its CUDA-core ones.  ``lpt_queue`` walks sorted loads for times >= 0
and a live cloud tier, else a tree argmin: both are exact, in one block's
shared memory up to 54,656 tasks and in chunks past it.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch_kernel_orders import (
    c6_repair_cluster_emulated,
    c6_repair_emulated,
    compare_runs,
    gate_cell_tiled,
)

from repro_torch.core.cost_model import SystemConfig, fps_norm, res_norm
from repro_torch.core.gating import GateConfig, init_gate_params
from repro_torch.core.lattice import BIG
from repro_torch.core.robust import RobustProblem
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels.c6_tail.ops import (
    CLUSTER_CAP,
    REPAIR_CAP,
    c6_repair,
    c6_tail,
    repair_path,
)
from repro_torch.kernels.c6_tail.ref import c6_repair_ref
from repro_torch.kernels.ccg_encode.ops import ccg_encode
from repro_torch.kernels.ccg_master.ops import ccg_master
from repro_torch.kernels.ccg_solve.ops import ccg_solve
from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    decode_attention_partial,
)
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_partial_ref
from repro_torch.kernels.flash_attention.ops import (
    LOG2E,
    flash_attention,
    flash_attention_autograd,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_lse_ref,
    attention_vjp_ref,
)
from repro_torch.kernels.lpt_queue.ops import BLOCK_TASKS, MAX_TASKS, lpt_queue
from repro_torch.kernels.mamba_scan.ops import (
    selective_scan,
    selective_scan_bwd,
)
from repro_torch.kernels.rglru.ops import rglru_scan, rglru_scan_bwd
from repro_torch.kernels.temporal_gate.ops import (
    gate_cell,
    gate_cell_autograd,
    gate_cell_vjp,
)
from repro_torch.kernels.temporal_gate.ref import gate_cell_vjp_ref
from repro_torch.configs import get_smoke_config
from repro_torch.models.layers import Ctx, mrope_positions
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.model import model_specs, prefill
from repro_torch.models.params import init_params, tree_leaves
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer, grads_of
from repro_torch.sharding.tensor_parallel import merge_partials

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


def _gate_case(dev, b, d, seed):
    rng = _gen(seed)
    p = init_gate_params(GateConfig(d_feature=d),
                         torch.Generator().manual_seed(seed), dev)
    p = {k: v + 0.1 * torch.randn(v.shape, device=dev)
         if k.startswith("b_") else v for k, v in p.items()}
    return (_t(rng.normal(size=(b, d)).astype(np.float32), dev),
            _t(rng.uniform(-1, 1, (b, 32)).astype(np.float32), dev),
            _t(rng.uniform(0, 2, b).astype(np.float32), dev), p)


@pytest.mark.parametrize("d", [1, 35, 64])
@pytest.mark.parametrize("b", [8, 37, 4096, 4099, 9001])
def test_gate_cell_kernel_persistent(dev, b, d):
    """The persistent kernel at ragged B (9001: several tiles a block, the
    next one staged while the current one computes) and d from 1 to 64:
    bit-equal to its order of work emulated on the card, within 1e-5 of
    the plain version, one launch a call."""
    args = _gate_case(dev, b, d, seed=b + d)
    reset_launch_counts()
    got = gate_cell(*args, force="kernel")
    assert launch_counts() == {"gate_cell": 1}
    want = gate_cell(*args, force="ref")
    emulated = gate_cell_tiled(*args)
    for g, w, e in zip(got, want, emulated):
        assert torch.equal(g, e)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


# gate_cell_bwd: |kernel - plain| <= GRAD_TOL · max(1, the largest sum over
# the streams of |a stream's term|) for a weight gradient, max(1, the
# largest |entry|) for dh
GRAD_TOL = 1e-5


def _grad_case(dev, b, d, seed):
    """A gate cell's operands and nonzero incoming gradients."""
    dx, h, vol, p = _gate_case(dev, b, d, seed)
    rng = _gen(seed + 1)
    return (dx, h, vol, p, _t(rng.normal(size=(b, 32)).astype(np.float32),
                              dev),
            _t(rng.normal(size=b).astype(np.float32), dev),
            _t(rng.normal(size=b).astype(np.float32), dev))


def _term_sums(dx, h, vol, p, dh_new=None, dtau=None, dg_mean=None):
    """Each weight gradient's Σ over the streams of |that stream's term|:
    the plain VJP of every stream alone (a weight gradient sums them), so a
    gradient that cancels to a small sum is held to its terms' size."""
    def one(x, hh, v, *grads):
        grads = [g[None] for g in grads]
        kw = dict(zip([k for k, g in (("dh_new", dh_new), ("dtau", dtau),
                                      ("dg_mean", dg_mean)) if g is not None],
                      grads))
        return gate_cell_vjp_ref(x[None], hh[None], v[None], p, **kw,
                                 need_dh=False)[0]
    given = [g for g in (dh_new, dtau, dg_mean) if g is not None]
    per = torch.func.vmap(one)(dx, h, vol, *given)
    return {k: v.abs().sum(0) for k, v in per.items()}


def _assert_grads(got, want, tol=GRAD_TOL, terms=None):
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        ref = w if terms is None else terms[k]
        scale = max(1.0, float(ref.abs().max()))
        err = float((g - w).abs().max())
        assert err <= tol * scale, (k, err, scale)


@pytest.mark.parametrize("d", [1, 35, 64])
@pytest.mark.parametrize("b", [1, 37, 4096, 4099])
def test_gate_cell_bwd_kernel(dev, b, d):
    """The backward kernel against the plain VJP: every parameter's
    gradient within 1e-5 of max(1, its largest Σ over the streams of
    |a stream's term|) (the kernel sums the B streams in tiles of 32, then
    the tiles, and torch in its own order, so a gradient that cancels to a
    small sum, as alpha, keeps its terms' rounding: 1.3e-5 off at
    |alpha| = 0.45, B = 4096, d = 1), dh within 1e-5 of max(1, its largest
    |entry|), one launch a call, and two launches bit-equal."""
    dx, h, vol, p, dh_new, dtau, dg = _grad_case(dev, b, d, seed=b + d)
    reset_launch_counts()
    got, dh = gate_cell_vjp(dx, h, vol, p, dh_new, dtau, dg, force="kernel")
    assert launch_counts() == {"gate_cell_bwd": 1}
    want, dh_want = gate_cell_vjp(dx, h, vol, p, dh_new, dtau, dg,
                                  force="ref")
    _assert_grads(got, want,
                  terms=_term_sums(dx, h, vol, p, dh_new, dtau, dg))
    _assert_grads({"dh": dh}, {"dh": dh_want})
    again, dh_again = gate_cell_vjp(dx, h, vol, p, dh_new, dtau, dg,
                                    force="kernel")
    assert torch.equal(dh, dh_again)
    for k in want:
        assert torch.equal(got[k], again[k]), k


@pytest.mark.parametrize("given", ["dtau", "dh_new", "dg_mean", "none"])
def test_gate_cell_bwd_kernel_absent_gradients(dev, given):
    """Each incoming gradient alone (the others None: zero), and none at
    all (every gradient exactly zero); without ``need_dh`` no dh."""
    dx, h, vol, p, dh_new, dtau, dg = _grad_case(dev, 300, 35, seed=3)
    kw = {"dh_new": dh_new, "dtau": dtau, "dg_mean": dg}
    kw = {k: v for k, v in kw.items() if k == given}
    got, dh = gate_cell_vjp(dx, h, vol, p, **kw, force="kernel")
    want, dh_want = gate_cell_vjp(dx, h, vol, p, **kw, force="ref")
    if given == "none":
        assert all(not bool(g.any()) for g in got.values())
        assert not bool(dh.any())
    else:
        _assert_grads(got, want, terms=_term_sums(dx, h, vol, p, **kw))
        _assert_grads({"dh": dh}, {"dh": dh_want})
    only, none = gate_cell_vjp(dx, h, vol, p, **kw, need_dh=False,
                               force="kernel")
    assert none is None
    for k in got:
        assert torch.equal(only[k], got[k]), k


def test_gate_cell_autograd_runs_the_backward_kernel(dev):
    """``GateCellFn`` on the card: the forward kernel forward, the
    backward kernel backward (no plain version), gradients of h and the
    parameters within 1e-5 of autograd through the plain cell; a wrong
    shape raises instead of falling back."""
    dx, h, vol, p, dh_new, dtau, dg = _grad_case(dev, 513, 35, seed=5)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    h1 = h.clone().requires_grad_(True)
    reset_launch_counts()
    out = gate_cell_autograd(dx, h1, vol, leaves)
    loss = sum((o * w).sum() for o, w in zip(out, (dh_new, dtau, dg)))
    loss.backward()
    assert launch_counts() == {"gate_cell": 1, "gate_cell_bwd": 1}
    plain = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    h2 = h.clone().requires_grad_(True)
    out = gate_cell(dx, h2, vol, plain, force="ref")
    sum((o * w).sum() for o, w in zip(out, (dh_new, dtau, dg))).backward()
    _assert_grads({k: v.grad for k, v in leaves.items()},
                  {k: v.grad for k, v in plain.items()},
                  terms=_term_sums(dx, h, vol, p, dh_new, dtau, dg))
    _assert_grads({"h": h1.grad}, {"h": h2.grad})
    with pytest.raises(ValueError):
        gate_cell_vjp(dx[:, :1].expand(513, 65).contiguous(), h, vol, p,
                      force="kernel")


def test_gate_cell_kernel_unaligned_operands(dev):
    """h and U_h that start 4 bytes off a 16-byte boundary take the
    element-wise copies: the same bits as aligned copies."""
    dx, h, vol, p = _gate_case(dev, 300, 35, seed=1)
    h_off = torch.empty(300 * 32 + 1, device=dev)[1:].view(300, 32)
    h_off.copy_(h)
    uh_off = torch.empty(32 * 32 + 1, device=dev)[1:].view(32, 32)
    uh_off.copy_(p["u_h"])
    assert h_off.data_ptr() % 16 and uh_off.data_ptr() % 16
    got = gate_cell(dx, h_off, vol, dict(p, u_h=uh_off), force="kernel")
    want = gate_cell(dx, h, vol, p, force="kernel")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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


def _ccg_synthetic(dev, m, k, p, f):
    """A solve at K versions, P poles and F options off the paper's
    lattice: option coordinates on the lattice's grid, positive costs and
    pole deviations from a seeded numpy generator."""
    rng = _gen(m + 10 * k + p + f)
    rn = np.tile(np.linspace(0.2, 1.0, 5), -(-f // 5))[:f]
    pn = np.repeat(np.linspace(0.2, 1.0, 5), -(-f // 5))[:f]
    tier = (np.arange(f) >= f // 2).astype(np.float32)
    b2 = rng.uniform(0.05, 2.0, (f, k)).astype(np.float32)
    u = (rng.uniform(0.0, 0.5, (p, k))
         * (rng.uniform(size=(p, k)) < 0.4)).astype(np.float32)
    c1 = rng.uniform(0.0, 1.0, f).astype(np.float32)
    z = rng.uniform(0, 1, m).astype(np.float32)
    aq = rng.uniform(0.4, 0.8, m).astype(np.float32)
    aq[:3] = [0.99, 0.97, 1.2][:m]
    wy = rng.integers(-1, f, m).astype(np.int32)
    return (_t(z, dev), _t(aq, dev),
            *(_t(a.astype(np.float32), dev) for a in (rn, pn, tier)),
            _t(b2, dev), _t(u, dev), _t(c1, dev), _t(wy, dev))


@pytest.mark.parametrize("m", [4096, 4093, 37])
@pytest.mark.parametrize("k,p,f", [
    (3, 16, 50),     # the table instantiation at another K
    (8, 16, 50),     # K > 5: the generic instantiation
    (5, 32, 64),     # tables of 262 KB do not fit: the generic one
])
def test_ccg_solve_kernel_instantiations(dev, m, k, p, f):
    """Both instantiations, chosen by shape, equal the plain version
    exactly; one launch a call."""
    args = _ccg_synthetic(dev, m, k, p, f)
    kw = dict(margin=0.02, num_versions=k)
    want = ccg_solve(*args, force="ref", **kw)
    reset_launch_counts()
    got = ccg_solve(*args, force="kernel", **kw)
    assert launch_counts() == {"ccg_solve": 1}
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the fallback lanes and some solved ones
    assert got[5][:3].all() and not got[5].all()


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


def _repair_case(dev, m, demoting, seed):
    """Feasible-looking decisions on the real bandwidth panel: over budget
    with demotions left (half the draw), or within it (twice the draw)."""
    lat = RobustProblem.build(SystemConfig(), dev).lat
    rng = _gen(seed)
    d = {k: _t(rng.integers(lo, n, m), dev) for k, lo, n in
         (("route", 0, 2), ("r", 2, 5), ("p", 2, 5), ("v", 2, 5))}
    panel = torch.movedim(lat.bw, -1, 0)[d["route"]].reshape(m, -1)
    draw = float(lat.solution_bandwidth(d).sum())
    z = _t(rng.uniform(0.05, 0.7, m).astype(np.float32), dev)
    thr = _t(rng.uniform(0.5, 0.75, m).astype(np.float32) + 0.02, dev)
    args = (panel, d["r"], d["p"], d["v"], d["route"], z, thr,
            res_norm(SystemConfig(), dev), fps_norm(SystemConfig(), dev))
    return args, float(np.float32((0.5 if demoting else 2.0) * draw))


def _repair_launches(m, rounds):
    """One c6_repair launch up to the cluster's cap, else a c6_tail a
    round."""
    return ({"c6_tail": rounds} if repair_path(m) == "per_round"
            else {"c6_repair": 1})


def _repair_emulated(m, *args, **kw):
    """The emulated order of the kernel that runs M tasks (None on the
    per-round path, which runs torch's own selection)."""
    path = repair_path(m)
    if path == "per_round":
        return None
    emulate = (c6_repair_emulated if path == "block"
               else c6_repair_cluster_emulated)
    return emulate(*args, **kw)


@pytest.mark.parametrize("rounds", [1, 8])
@pytest.mark.parametrize("budget_kind", ["float", "tensor"])
@pytest.mark.parametrize("demoting", [True, False])
@pytest.mark.parametrize("m", [60, 256, 4095, 4096, REPAIR_CAP + 1, 53248,
                               CLUSTER_CAP, CLUSTER_CAP + 1])
def test_c6_repair_kernel(dev, m, demoting, budget_kind, rounds):
    """One launch of the one-block kernel up to its cap and of the cluster
    kernel up to the cluster's, its bits those of its order of work
    emulated on the card and two launches bit-equal; above that the
    per-round path (a c6_tail launch a round); all against the plain
    version: r and p equal outside the boundary exemption, the history
    within 1e-6."""
    args, budget = _repair_case(dev, m, demoting, seed=m + rounds)
    b = budget if budget_kind == "float" else torch.tensor(budget,
                                                           device=dev)
    reset_launch_counts()
    got = c6_repair(*args, b, n_fps=5, rounds=rounds, force="kernel")
    assert launch_counts() == _repair_launches(m, rounds)
    assert got[2].shape == (rounds,) and got[0].dtype == torch.int64
    emulated = _repair_emulated(m, *args, b, n_fps=5, rounds=rounds)
    if emulated is not None:
        again = c6_repair(*args, b, n_fps=5, rounds=rounds, force="kernel")
        for g, e, a in zip(got, emulated, again):
            assert torch.equal(g, e) and torch.equal(g, a)
    run_k = lambda k: c6_repair(*args, b, n_fps=5, rounds=k, force="kernel")
    run_r = lambda k: c6_repair_ref(*args, b, n_fps=5, rounds=k)
    demoted = compare_runs(run_k, run_r, rounds, args, budget)
    changed = bool((got[0] != args[1]).any() or (got[1] != args[2]).any())
    assert changed == demoting
    if demoting and rounds == 8:
        assert demoted >= 2


@pytest.mark.parametrize("m", [4096, 53248])
def test_c6_repair_kernel_reads_the_budget_on_the_card(dev, m):
    """A budget tensor written by an earlier kernel on the stream is read
    where it lies: the same result as the value passed as a float."""
    args, budget = _repair_case(dev, m, True, seed=3)
    b = torch.zeros((), device=dev)
    b.add_(budget)
    got = c6_repair(*args, b, n_fps=5, rounds=8, force="kernel")
    want = c6_repair(*args, budget, n_fps=5, rounds=8, force="kernel")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m", [4096, 53248])
def test_c6_repair_kernel_captured(dev, m):
    """The repair captured in a CUDA graph and replayed (its budget a
    tensor written before each replay) gives the bits of its uncaptured
    launch: no float atomics, no read back to the host."""
    args, budget = _repair_case(dev, m, True, seed=5)
    b = torch.tensor(budget, device=dev)
    want = c6_repair(*args, b, n_fps=5, rounds=8, force="kernel")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = c6_repair(*args, b, n_fps=5, rounds=8, force="kernel")
    for _ in range(2):
        b.fill_(budget)
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_c6_repair_cluster_fits_the_card(dev):
    """The cluster kernel's largest cluster (16 full blocks, non-portable)
    and the portable 8 are schedulable: at least one active cluster each."""
    lib = _build.library()
    for blocks in (8, CLUSTER_CAP // REPAIR_CAP):
        assert lib.c6_repair_max_clusters(blocks) >= 1


@pytest.mark.parametrize("shape", [(1, 4096), (3, 257)])
def test_lpt_queue_kernel(dev, shape):
    rng = _gen(shape[1])
    t = rng.uniform(0.01, 1.0, shape).astype(np.float32)
    t.reshape(-1)[:8] = 0.25
    route = rng.integers(0, 2, shape).astype(np.int32)
    got = lpt_queue(_t(t, dev), _t(route, dev), 4, 1, force="kernel")
    want = lpt_queue(_t(t, dev), _t(route, dev), 4, 1, force="ref")
    assert torch.equal(got, want)


def _lpt_case(seed, shape, routes, ties):
    """Times on a coarse grid (``ties``: loads tie often) or uniform, and
    mixed, all-edge or all-cloud routes."""
    rng = _gen(seed)
    if ties:
        t = (rng.integers(1, 5, shape) * 0.125).astype(np.float32)
    else:
        t = rng.uniform(0.01, 1.0, shape).astype(np.float32)
    route = {"mixed": rng.integers(0, 2, shape),
             "all_edge": np.zeros(shape), "all_cloud": np.ones(shape)}[routes]
    return t, route.astype(np.int32)


@pytest.mark.parametrize("routes", ["mixed", "all_edge", "all_cloud"])
@pytest.mark.parametrize("n_edge,n_cloud", [(1, 1), (2, 2), (4, 1), (7, 1),
                                            (3, 5), (16, 8), (8, 4), (1, 16),
                                            (16, 16)])
def test_lpt_queue_kernel_server_splits(dev, n_edge, n_cloud, routes):
    """The specialised 4 + 1 walk, the generic one on every other split of
    up to 8 servers and the wide one up to 16 a tier (the sharded
    session's whole pools), on tie-heavy times: equal to the plain version
    bit for bit, one launch."""
    t, route = _lpt_case(n_edge * 8 + n_cloud, (2, 4096), routes, ties=True)
    reset_launch_counts()
    got = lpt_queue(_t(t, dev), _t(route, dev), n_edge, n_cloud,
                    force="kernel")
    assert launch_counts() == {"lpt_queue": 1}
    want = lpt_queue(_t(t, dev), _t(route, dev), n_edge, n_cloud,
                     force="ref")
    assert torch.equal(got, want)


@pytest.mark.parametrize("with_avail", [False, True])
@pytest.mark.parametrize("m", [4096, 4093, "block", "block+1", 65536,
                               262144])
def test_lpt_queue_kernel_task_counts(dev, m, with_avail):
    """M a multiple of the walk's 32-task batches, ragged, the one-block
    kernel's largest, one past it and two sizes of the chunked walk, with
    all servers up and one edge server down: one launch, equal to the
    plain version bit for bit; the wrapper refuses M past its limit."""
    m = {"block": BLOCK_TASKS, "block+1": BLOCK_TASKS + 1}.get(m, m)
    t, route = _lpt_case(m, (m,), "mixed", ties=False)
    avail = None
    if with_avail:
        avail = torch.ones(5, device=dev)
        avail[2] = 0.0
    reset_launch_counts()
    got = lpt_queue(_t(t, dev), _t(route, dev), 4, 1, avail=avail,
                    force="kernel")
    assert launch_counts() == {"lpt_queue": 1}
    want = lpt_queue(_t(t, dev), _t(route, dev), 4, 1, avail=avail,
                     force="ref")
    assert torch.equal(got, want)
    # stride-0 views: the wrapper refuses the shape before any allocation
    over = [torch.zeros(1, dtype=dt, device=dev).expand(MAX_TASKS + 1)
            for dt in (torch.float32, torch.int32)]
    with pytest.raises(ValueError, match=f"M <= {MAX_TASKS}"):
        lpt_queue(*over, 4, 1, force="kernel")


@pytest.mark.parametrize("routes", ["all_edge", "all_cloud", "mixed"])
@pytest.mark.parametrize("n_edge,n_cloud", [(4, 1), (16, 8)])
def test_lpt_queue_kernel_past_one_block_routes(dev, n_edge, n_cloud,
                                                routes):
    """The chunked walk at 65,536 tasks on tie-heavy times, every route
    mix, the port's pools and the sharded phase's wide ones: exact."""
    t, route = _lpt_case(n_edge + routes.count("_"), (65536,), routes,
                         ties=True)
    got = lpt_queue(_t(t, dev), _t(route, dev), n_edge, n_cloud,
                    force="kernel")
    want = lpt_queue(_t(t, dev), _t(route, dev), n_edge, n_cloud,
                     force="ref")
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [4093, 65536])
@pytest.mark.parametrize("n_edge,n_cloud", [(4, 1), (3, 5), (16, 8)])
def test_lpt_queue_kernel_tree_walk(dev, n_edge, n_cloud, m):
    """Times below zero (and a -0.0) send the kernel down its tree walk,
    whose picks must equal the plain version's too, in one block and in
    chunks."""
    t, route = _lpt_case(n_cloud, (2, m), "mixed", ties=True)
    t[:, ::7] *= -1.0
    t[1, 5] = -0.0
    got = lpt_queue(_t(t, dev), _t(route, dev), n_edge, n_cloud,
                    force="kernel")
    want = lpt_queue(_t(t, dev), _t(route, dev), n_edge, n_cloud,
                     force="ref")
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_edge,n_cloud,dead", [
    (4, 1, (1,)),          # one edge server down
    (4, 1, (4,)),          # the cloud tier down: its tasks land on server 0
    (2, 2, (0, 1, 3)),     # the edge tier down, one cloud server left
    (16, 8, (0, 5, 17)),   # the wide pools, two edge and a cloud down
])
def test_lpt_queue_kernel_availability(dev, n_edge, n_cloud, dead):
    """Dead servers start at +inf load, as the reference's ``avail``."""
    t, route = _lpt_case(sum(dead), (3, 4093), "mixed", ties=True)
    avail = np.ones((3, n_edge + n_cloud), np.float32)
    avail[1:, list(dead)] = 0.0
    args = (_t(t, dev), _t(route, dev), n_edge, n_cloud)
    got = lpt_queue(*args, avail=_t(avail, dev), force="kernel")
    want = lpt_queue(*args, avail=_t(avail, dev), force="ref")
    assert torch.equal(got, want)


@pytest.mark.parametrize("dead", [None, 1])
@pytest.mark.parametrize("m", [4096, 4093, 37])
def test_ccg_encode_kernel(dev, m, dead):
    prob = RobustProblem.build(SystemConfig(), dev)
    lat = prob.lat
    rng = _gen(m)
    z = rng.uniform(0, 1, m).astype(np.float32)
    aq = rng.uniform(0.5, 0.8, m).astype(np.float32)
    aq[:3] = [0.99, 0.97, 1.2]
    z[3:5] = 0.0
    y_ok = None
    if dead is not None:
        y_ok = (lat.tier_flat != dead).to(torch.float32)
    args = (_t(z, dev), _t(aq, dev), lat.rn_flat, lat.pn_flat, lat.tier_flat,
            prob.b2_scaled, prob.rec_table)
    kw = dict(margin=0.02, num_versions=5, y_ok=y_ok)
    reset_launch_counts()
    got = ccg_encode(*args, force="kernel", **kw)
    assert launch_counts() == {"ccg_encode": 1}
    want = ccg_encode(*args, force="ref", **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("shape", [(4096, 16, 50), (4093, 16, 50),
                                   (37, 40, 70)])
def test_ccg_master_kernel(dev, shape):
    m, p, f = shape
    rng = _gen(m + p)
    rec = (rng.integers(0, 6, (m, p, f)) * 0.125).astype(np.float32)
    scen = (rng.uniform(size=(m, p)) < 0.3).astype(np.float32)
    scen[::5] = 0.0
    fs_ok = rng.uniform(size=(m, f)) < 0.7
    fs_ok[2::6] = False
    c1 = (rng.integers(0, 4, f) * 0.25).astype(np.float32)
    args = (_t(rec, dev), _t(scen, dev), _t(fs_ok, dev), _t(c1, dev))
    got = ccg_master(*args, force="kernel")
    want = ccg_master(*args, force="ref")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _encode_synthetic(dev, m, k, p, f, dead):
    """An encode at K versions, P poles and F options off the paper's
    lattice: option coordinates on the lattice's grid, pole-scaled costs on
    a coarse grid (equal costs across versions, so the subset minima tie),
    the (P, F, 2^K) subset table built from them as RobustProblem builds
    it; rows that nothing fits, z = 0 rows (accuracy ties across options
    of one resolution) and, with ``dead``, the cloud tier's options
    unavailable."""
    rng = _gen(m + 10 * k + p + f)
    rn = np.tile(np.linspace(0.2, 1.0, 5), -(-f // 5))[:f]
    pn = np.repeat(np.linspace(0.2, 1.0, 5), -(-f // 5))[:f]
    tier = (np.arange(f) >= f // 2).astype(np.float32)
    b2s = _t((rng.integers(1, 12, (p, f, k)) * 0.125).astype(np.float32),
             dev)
    masks = ((torch.arange(2 ** k, device=dev)[:, None]
              >> torch.arange(k, device=dev)[None]) & 1).bool()
    rec_table = torch.where(masks[None, None], b2s[:, :, None, :],
                            BIG).amin(dim=-1)
    z = rng.uniform(0, 1, m).astype(np.float32)
    aq = rng.uniform(0.4, 0.8, m).astype(np.float32)
    aq[:3] = [0.99, 0.97, 1.2][:m]
    z[3:6] = 0.0
    y_ok = _t((tier < 0.5).astype(np.float32), dev) if dead else None
    return ((_t(z, dev), _t(aq, dev),
             *(_t(a.astype(np.float32), dev) for a in (rn, pn, tier)),
             b2s, rec_table), y_ok)


@pytest.mark.parametrize("m", [1, 37, 4093, 4096, 9001])
@pytest.mark.parametrize("k,p,f", [
    (1, 2, 50), (2, 4, 50), (3, 4, 50), (4, 11, 50), (5, 16, 50),
    (5, 16, 33),     # the table path: K = 1..5
    (5, 1, 50),      # Γ = 0: a task's P·F block is no whole 16-byte vectors
    (6, 16, 50),     # K > 5: the generic path
    (5, 16, 70),     # F > 64: the generic path
    (5, 32, 64),     # tables of 262 KB do not fit: the generic path
])
def test_ccg_encode_kernel_paths(dev, m, k, p, f):
    """Both paths, chosen by shape, equal the plain version exactly, with
    and without a dead tier; one launch a call."""
    for dead in (False, True):
        args, y_ok = _encode_synthetic(dev, m, k, p, f, dead)
        kw = dict(margin=0.02, num_versions=k, y_ok=y_ok)
        want = ccg_encode(*args, force="ref", **kw)
        reset_launch_counts()
        got = ccg_encode(*args, force="kernel", **kw)
        assert launch_counts() == {"ccg_encode": 1}
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        # rows that nothing fits, and solvable ones
        assert (got[0][:min(m, 3)] == 0).all()
        if m > 6:
            assert (got[0] > 0).any()


@pytest.mark.parametrize("poles", [0, 1, 8, "all"])
@pytest.mark.parametrize("f", [1, 50, 70, 130])
@pytest.mark.parametrize("p", [1, 16, 33, 64])
def test_ccg_master_kernel_pole_sets(dev, p, f, poles):
    """0, 1, 8 or every pole generated per task (at most P), every fifth
    task with none; ties on a coarse grid, BIG recourse entries and
    all-infeasible rows: exactly the plain version, one launch a call."""
    m = 257
    rng = _gen(p * 1000 + f * 10 + (p if poles == "all" else poles))
    rec = (rng.integers(0, 6, (m, p, f)) * 0.125).astype(np.float32)
    rec[rng.uniform(size=(m, p, f)) < 0.05] = BIG
    n_set = p if poles == "all" else min(poles, p)
    scen = np.zeros((m, p), np.float32)
    for i in range(m):
        scen[i, rng.permutation(p)[:n_set]] = 1.0
    scen[::5] = 0.0
    fs_ok = rng.uniform(size=(m, f)) < 0.7
    fs_ok[2::6] = False
    fs_ok[3::6] = True
    c1 = (rng.integers(0, 4, f) * 0.25).astype(np.float32)
    args = (_t(rec, dev), _t(scen, dev), _t(fs_ok, dev), _t(c1, dev))
    want = ccg_master(*args, force="ref")
    reset_launch_counts()
    got = ccg_master(*args, force="kernel")
    assert launch_counts() == {"ccg_master": 1}
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert (got[0][2::6] == 0).all() and (got[1][2::6] == BIG).all()


@pytest.mark.parametrize("m", [1, 2, 33])
def test_ccg_master_kernel_few_tasks(dev, m):
    """Fewer tasks than a block holds (a warp's or a group's lanes past
    M): exactly the plain version."""
    rng = _gen(m)
    rec = (rng.integers(0, 6, (m, 16, 50)) * 0.125).astype(np.float32)
    scen = (rng.uniform(size=(m, 16)) < 0.3).astype(np.float32)
    fs_ok = rng.uniform(size=(m, 50)) < 0.7
    c1 = (rng.integers(0, 4, 50) * 0.25).astype(np.float32)
    args = (_t(rec, dev), _t(scen, dev), _t(fs_ok, dev), _t(c1, dev))
    got = ccg_master(*args, force="kernel")
    want = ccg_master(*args, force="ref")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


_ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _normal(rng, shape, dtype, dev):
    return _t(rng.normal(size=shape).astype(np.float32), dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d", [
    (16, 16, 16, 144, 64),     # the edge tier's slab (Qwen1.5-0.5B)
    (16, 32, 8, 144, 128),     # the cloud tier's slab (Qwen3-8B)
    (3, 8, 1, 200, 32),        # MQA, G = 8, a ragged last tile
    (2, 6, 3, 65, 256),        # G = 2, the widest head
    (16, 16, 1, 80, 256),      # RecurrentGemma's slab: MQA, G = 16
    (3, 16, 1, 37, 256),       # G = 16, a ragged last tile
])
def test_decode_attention_kernel(dev, dtype, b, h, kv, s, d):
    """The cache is a (B, S, KV, D) slab read through a permuted view, at
    per-row lengths from 1 to S."""
    rng = _gen(b * s + d)
    q = _normal(rng, (b, h, d), dtype, dev)
    k_slab = _normal(rng, (b, s, kv, d), dtype, dev)
    v_slab = _normal(rng, (b, s, kv, d), dtype, dev)
    length = rng.integers(1, s + 1, b)
    length[0], length[-1] = 1, s
    length = _t(length.astype(np.int32), dev)
    k_c, v_c = k_slab.permute(0, 2, 1, 3), v_slab.permute(0, 2, 1, 3)
    reset_launch_counts()
    got = decode_attention(q, k_c, v_c, length, force="kernel")
    assert launch_counts() == {"decode_attention": 1}
    want = decode_attention(q, k_c, v_c, length, force="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_ATTN_TOL[dtype])


def _decode_case(seed, b, h, kv, s, d, dtype, dev, lengths):
    rng = _gen(seed)
    q = _normal(rng, (b, h, d), dtype, dev)
    k_c = _normal(rng, (b, s, kv, d), dtype, dev).permute(0, 2, 1, 3)
    v_c = _normal(rng, (b, s, kv, d), dtype, dev).permute(0, 2, 1, 3)
    return q, k_c, v_c, _t(np.asarray(lengths, np.int32), dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", ["ones", "full"])
@pytest.mark.parametrize("b,h,kv,s,d", [
    (16, 32, 8, 144, 128),     # the cloud tier's slab
    (16, 16, 1, 80, 256),      # RecurrentGemma's slab
    (2, 16, 1, 2048, 256),     # RecurrentGemma's window: 8 tiles a split
])
def test_decode_attention_kernel_lengths(dev, dtype, lengths, b, h, kv, s, d):
    """Every row at length 1 (one split holds the entry, the rest are
    empty) or at length S (every split full)."""
    q, k_c, v_c, length = _decode_case(s + d, b, h, kv, s, d, dtype, dev,
                                       [1 if lengths == "ones" else s] * b)
    reset_launch_counts()
    got = decode_attention(q, k_c, v_c, length, force="kernel")
    assert launch_counts() == {"decode_attention": 1}
    want = decode_attention(q, k_c, v_c, length, force="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_long_cache_and_empty_row(dev, dtype):
    """B 2 over RecurrentGemma's 2048-entry window at ragged lengths, and a
    row of length 0, which gives zeros (the plain version's softmax over
    masked entries would average V); two calls are bit-equal, since the
    splits are combined in a fixed order."""
    b, h, kv, s, d = 3, 16, 1, 2048, 256
    q, k_c, v_c, length = _decode_case(7, b, h, kv, s, d, dtype, dev,
                                       [1537, 0, 2048])
    got = decode_attention(q, k_c, v_c, length, force="kernel")
    again = decode_attention(q, k_c, v_c, length, force="kernel")
    want = decode_attention(q, k_c, v_c, length, force="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    torch.testing.assert_close(got[::2].float(), want[::2].float(),
                               **_ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_generic_pieces(dev, dtype):
    """Rows that do not start on 16-byte boundaries (a slab two elements
    into its buffer) take the kernel's 4-byte instantiation, not the plain
    version."""
    rng = _gen(3)
    b, h, kv, s, d = 4, 8, 2, 50, 64
    buf = _normal(rng, (2, b * s * kv * d + 2), dtype, dev)
    k_c, v_c = (x[2:].view(b, s, kv, d).permute(0, 2, 1, 3) for x in buf)
    q = _normal(rng, (b, h, d), dtype, dev)
    length = _t(np.array([50, 1, 17, 33], np.int32), dev)
    reset_launch_counts()
    got = decode_attention(q, k_c, v_c, length, force="kernel")
    assert launch_counts() == {"decode_attention": 1}
    want = decode_attention(q, k_c, v_c, length, force="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d", [
    (8, 32, 8, 3008, 128),     # a rank's range of the split Qwen3-8B cache
    (4, 8, 2, 37, 16),         # Qwen1.5-0.5B's SMOKE head dim, ragged
    (3, 16, 1, 80, 256),       # RecurrentGemma: MQA, G = 16
])
def test_decode_attention_partial_kernel(dev, dtype, b, h, kv, s, d):
    """The partial launch over one range of each row's cache, lengths 0
    (an empty range: out 0, lse -inf, no NaN), 1 and up to S: one launch,
    out and the finite lse within the plain version's (float32: the
    attention tolerance; bf16: out within 2^-8 of the softmax-weighted
    mean of |v|, since the kernel rounds each probability to bf16 before
    P·V, and lse within 1e-3), -inf exactly where it has it; two calls
    bit-equal; and the ranges merged by ``merge_partials`` give the
    serving launch's result on the whole cache."""
    lengths = ([0, 1, s, s // 2] * b)[:b]
    q, k_c, v_c, length = _decode_case(s + h, b, h, kv, s, d, dtype, dev,
                                       lengths)
    reset_launch_counts()
    out, lse = decode_attention_partial(q, k_c, v_c, length, force="kernel")
    assert launch_counts() == {"decode_attention_partial": 1}
    again = decode_attention_partial(q, k_c, v_c, length, force="kernel")
    want_out, want_lse = decode_attention_partial(q, k_c, v_c, length,
                                                  force="ref")
    torch.cuda.synchronize()
    assert out.dtype == lse.dtype == torch.float32
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    empty = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), empty) and bool(
        (lse[empty] == -torch.inf).all())
    if dtype == torch.bfloat16:
        w, _ = decode_attention_partial_ref(q, k_c, v_c.abs(), length)
        assert bool(((out - want_out).abs() <= 2.0 ** -8 * w + 1e-6).all())
        torch.testing.assert_close(lse[~empty], want_lse[~empty], atol=1e-3,
                                   rtol=0)
    else:
        torch.testing.assert_close(out, want_out, **_ATTN_TOL[dtype])
        torch.testing.assert_close(lse[~empty], want_lse[~empty],
                                   **_ATTN_TOL[dtype])
    # two ranges of the cache merged against the serving launch
    cut = s // 2
    parts = [decode_attention_partial(
        q, k_c[:, :, lo:hi], v_c[:, :, lo:hi],
        torch.clamp(length - lo, 0, hi - lo).to(torch.int32), force="kernel")
        for lo, hi in ((0, cut), (cut, s))]
    merged, _ = merge_partials(torch.stack([o for o, _ in parts]),
                               torch.stack([x for _, x in parts]))
    whole = decode_attention(q, k_c, v_c, length, force="kernel")
    live = length > 0
    torch.testing.assert_close(merged[live].to(dtype).float(),
                               whole[live].float(), **_ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,sq,sk,d,window,causal", [
    (8, 16, 16, 80, 80, 64, None, True),     # edge prefill, longest prompt
    (8, 32, 8, 80, 80, 128, None, True),     # cloud prefill
    (1, 32, 8, 16, 16, 128, None, True),     # shortest prompt
    (2, 8, 2, 37, 37, 128, None, True),      # ragged lengths
    (2, 8, 2, 100, 100, 64, 16, True),       # sliding window
    (1, 4, 4, 5, 70, 64, None, False),       # non-causal, Sq < Sk
    (2, 12, 4, 70, 45, 32, 30, False),       # non-causal window, Sq > Sk
    (8, 16, 1, 80, 80, 256, 2048, True),     # RecurrentGemma prefill
    (2, 16, 1, 37, 37, 256, 16, True),       # D = 256, window, ragged
    # query rows not a multiple of a warp's 16 or a key tile's 64
    (2, 8, 2, 1, 1, 128, None, True),
    (2, 8, 2, 17, 17, 64, None, True),
    (1, 8, 8, 63, 63, 64, None, True),
    (2, 32, 8, 65, 65, 128, None, True),
    # G query heads per KV head × head dims, across two key tiles
    *[(2, 2 * g, 2, 65, 65, d, None, True)
      for g in (1, 4, 16) for d in (64, 128, 256)],
    # the SMOKE tier models' head dims (the serve launcher's pools)
    (2, 4, 4, 48, 48, 16, None, True),       # qwen1.5-0.5b SMOKE
    (2, 8, 2, 48, 48, 8, None, True),        # qwen3-8b SMOKE
    (2, 8, 2, 40, 40, 16, 16, True),         # D = 16, window, two tiles
])
def test_flash_attention_kernel(dev, dtype, b, h, kv, sq, sk, d, window,
                                causal):
    """q, k and v are (B, S, heads, D) projections read through permuted
    views, as the model passes them."""
    rng = _gen(b * sq + sk + d)
    q = _normal(rng, (b, sq, h, d), dtype, dev).transpose(1, 2)
    k = _normal(rng, (b, sk, kv, d), dtype, dev).transpose(1, 2)
    v = _normal(rng, (b, sk, kv, d), dtype, dev).transpose(1, 2)
    kw = dict(window=window, causal=causal)
    reset_launch_counts()
    got = flash_attention(q, k, v, force="kernel", **kw)
    assert launch_counts() == {"flash_attention": 1}
    want = flash_attention(q, k, v, force="ref", **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_ATTN_TOL[dtype])


def _positions(layout, b, s, dev, seed=0):
    """(B, S) runtime positions: Qwen2-VL's temporal stream (16 text
    tokens, a 2 × 4 × 4 patch grid, text after it; S = 80), a random
    permutation of 0..S-1 per row, or each position repeated three times."""
    if layout == "qwen2vl":
        return mrope_positions(16, (2, 4, 4), s - 48, b, dev)[:, 0]
    if layout == "shuffled":
        rng = _gen(seed)
        return _t(np.stack([rng.permutation(s) for _ in range(b)]).astype(
            np.int32), dev)
    return (torch.arange(s, device=dev) // 3).to(torch.int32).expand(
        b, s).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,window,layout", [
    (8, 12, 2, 80, 128, None, "qwen2vl"),    # Qwen2-VL-2B prefill
    (2, 12, 2, 80, 128, 16, "qwen2vl"),      # with a window
    (2, 8, 2, 70, 64, 24, "shuffled"),       # non-monotone, window
    (2, 24, 24, 80, 64, None, "repeats"),    # MusicGen's heads
    (2, 4, 4, 37, 16, None, "shuffled"),     # the CUDA-core bf16 kernel
    (1, 16, 1, 65, 256, 20, "repeats"),      # D = 256, window
])
def test_flash_attention_kernel_positions(dev, dtype, b, h, kv, s, d,
                                          window, layout):
    """Runtime positions mask the kernel as the plain version: query i sees
    key j iff pos[i] >= pos[j] (and pos[i] - pos[j] < window)."""
    rng = _gen(b * s + d)
    q = _normal(rng, (b, s, h, d), dtype, dev).transpose(1, 2)
    k = _normal(rng, (b, s, kv, d), dtype, dev).transpose(1, 2)
    v = _normal(rng, (b, s, kv, d), dtype, dev).transpose(1, 2)
    pos = _positions(layout, b, s, dev, seed=s)
    reset_launch_counts()
    got = flash_attention(q, k, v, window=window, positions=pos,
                          force="kernel")
    assert launch_counts() == {"flash_attention": 1}
    want = flash_attention(q, k, v, window=window, positions=pos,
                           force="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,s,d,window", [
    (12, 2, 80, 128, None), (8, 2, 100, 64, 16), (4, 4, 48, 16, None),
    (16, 1, 80, 256, 2048)])
def test_flash_attention_arange_positions_give_the_index_launch(
        dev, dtype, h, kv, s, d, window):
    """Positions 0..S-1 visit every key tile, but the tiles the index launch
    skips are fully masked (probability 0, correction 1): the two give the
    same bits."""
    rng = _gen(s + d)
    q = _normal(rng, (2, s, h, d), dtype, dev).transpose(1, 2)
    k = _normal(rng, (2, s, kv, d), dtype, dev).transpose(1, 2)
    v = _normal(rng, (2, s, kv, d), dtype, dev).transpose(1, 2)
    pos = torch.arange(s, device=dev, dtype=torch.int32).expand(2, s)
    by_index = flash_attention(q, k, v, window=window, force="kernel")
    by_pos = flash_attention(q, k, v, window=window, positions=pos,
                             force="kernel")
    assert torch.equal(by_index, by_pos)


def test_flash_attention_positions_reject_cross_attention(dev):
    q = torch.zeros((1, 4, 16, 64), device=dev)
    k = torch.zeros((1, 4, 20, 64), device=dev)
    pos = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    reset_launch_counts()
    with pytest.raises(ValueError, match="self-attention"):
        flash_attention(q, k, k, positions=pos, force="kernel")
    with pytest.raises(ValueError, match="self-attention"):
        flash_attention(q, q, q, positions=pos, causal=False)
    assert launch_counts() == {}


def test_qwen2_vl_prefill_with_positions_launches_flash(dev):
    """A Qwen2-VL SMOKE prefill (bf16) with explicit M-RoPE positions runs
    ``flash_attention`` once a layer with its positions, never the plain
    path, and its logits match the plain path's within the bf16 model
    tolerance of ``test_torch_model.py`` (0.1)."""
    cfg = get_smoke_config("qwen2-vl-2b")
    params = init_params(model_specs(cfg), torch.Generator(dev).manual_seed(0),
                         dev, torch.bfloat16)
    rng = _gen(80)
    batch = {"embeddings": _normal(rng, (2, 80, cfg.d_model), torch.bfloat16,
                                   dev),
             "positions": mrope_positions(16, (2, 4, 4), 32, 2, dev)}
    reset_launch_counts()
    got, _ = prefill(Ctx(cfg=cfg), params, batch)
    assert launch_counts() == {"flash_attention": cfg.num_layers}
    want, _ = prefill(Ctx(cfg=cfg, force="ref"), params, batch)
    assert launch_counts() == {"flash_attention": cfg.num_layers}
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0.1)


@pytest.mark.parametrize("layout", ["offset_pointer", "odd_row_stride"])
def test_flash_attention_rejects_misaligned_rows(dev, layout):
    """The bf16 kernel stages rows with 16-byte copies: a q whose rows do
    not start on a 16-byte boundary raises, launches nothing and does not
    fall back to the plain version."""
    rng = _gen(5)
    b, s, h, kv, d = 2, 17, 8, 2, 64
    if layout == "offset_pointer":      # a view one element into its buffer
        buf = _normal(rng, (b, s, h * d + 1), torch.bfloat16, dev)
        q = buf[..., 1:].unflatten(-1, (h, d)).transpose(1, 2)
    else:                               # rows 64 + 4 elements apart
        q = _normal(rng, (b, s, h, d + 4), torch.bfloat16,
                    dev)[..., :d].transpose(1, 2)
    k = _normal(rng, (b, s, kv, d), torch.bfloat16, dev).transpose(1, 2)
    v = _normal(rng, (b, s, kv, d), torch.bfloat16, dev).transpose(1, 2)
    reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, v, force="kernel")
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, v)
    o = torch.zeros((b, h, s, d), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(q, k, v, o, o, force="kernel")
    assert launch_counts() == {}


def test_stream_ptr_is_the_current_stream(dev):
    """The wrappers launch on PyTorch's current stream of the device."""
    assert _build.stream_ptr(dev) == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert _build.stream_ptr(dev) == side.cuda_stream
        assert _build.stream_ptr(torch.device("cuda", side.device.index)) \
            == side.cuda_stream


_SCAN_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,di,n", [
    (16, 1, 8192, 16),     # Falcon-Mamba-7B decode step
    (8, 80, 8192, 16),     # Falcon-Mamba-7B prefill, longest prompt
    (3, 37, 200, 16),      # ragged S and Di
    (2, 1, 130, 4),        # the SMOKE state size, ragged Di
    # state sizes below a quad's 16 or not a multiple of a lane's 4
    (3, 37, 136, 1),
    (3, 37, 136, 3),
    (3, 37, 136, 4),
    (3, 37, 136, 5),
    # channels not a multiple of a warp's 8 (nor of a block's 64)
    (2, 5, 203, 16),
    (16, 1, 61, 16),
])
def test_mamba_scan_kernel(dev, dtype, with_h0, b, s, di, n):
    """x, B and C in the model's dtype, B and C column slices of one
    projection (read by strides), dt float32; the state written into
    ``h_out``, also when it is ``h0`` itself (the decode step)."""
    rng = _gen(b * s + di + n)
    x = _normal(rng, (b, s, di), dtype, dev)
    dt = torch.nn.functional.softplus(
        0.5 * _normal(rng, (b, s, di), torch.float32, dev))
    proj = _normal(rng, (b, s, 3 + 2 * n), dtype, dev)
    B, C = proj[..., 3:3 + n], proj[..., 3 + n:]
    A = -torch.exp(0.2 * _normal(rng, (di, n), torch.float32, dev))
    D = _normal(rng, (di,), torch.float32, dev)
    h0 = _normal(rng, (b, di, n), torch.float32, dev) if with_h0 else None
    want_y, want_h = selective_scan(x, dt, B, C, A, D, h0, force="ref")
    reset_launch_counts()
    got_y, got_h = selective_scan(x, dt, B, C, A, D, h0, force="kernel")
    assert launch_counts() == {"mamba_scan": 1}
    torch.cuda.synchronize()
    torch.testing.assert_close(got_y, want_y, **_SCAN_TOL)
    torch.testing.assert_close(got_h, want_h, **_SCAN_TOL)
    if h0 is not None:
        state = h0.clone()
        y, h = selective_scan(x, dt, B, C, A, D, state, h_out=state,
                              force="kernel")
        torch.cuda.synchronize()
        assert h is state
        torch.testing.assert_close(state, want_h, **_SCAN_TOL)
        torch.testing.assert_close(y, want_y, **_SCAN_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w", [
    (16, 1, 4096),         # RecurrentGemma-9B decode step
    (8, 80, 4096),         # RecurrentGemma-9B prefill, longest prompt
    (3, 37, 200),          # ragged S and W
])
def test_rglru_scan_kernel(dev, dtype, with_h0, b, s, w):
    """x in the model's dtype, the gates float32; the state written into
    ``h_out``, also when it is ``h0`` itself (the decode step)."""
    rng = _gen(b * s + w)
    x = _normal(rng, (b, s, w), dtype, dev)
    r = torch.sigmoid(_normal(rng, (b, s, w), torch.float32, dev))
    i = torch.sigmoid(_normal(rng, (b, s, w), torch.float32, dev))
    la = -8.0 * torch.nn.functional.softplus(
        _normal(rng, (w,), torch.float32, dev))
    h0 = _normal(rng, (b, w), torch.float32, dev) if with_h0 else None
    want_y, want_h = rglru_scan(x, r, i, la, h0, force="ref")
    reset_launch_counts()
    got_y, got_h = rglru_scan(x, r, i, la, h0, force="kernel")
    assert launch_counts() == {"rglru_scan": 1}
    torch.cuda.synchronize()
    torch.testing.assert_close(got_y, want_y, **_SCAN_TOL)
    torch.testing.assert_close(got_h, want_h, **_SCAN_TOL)
    if h0 is not None:
        state = h0.clone()
        y, h = rglru_scan(x, r, i, la, state, h_out=state, force="kernel")
        torch.cuda.synchronize()
        assert h is state
        torch.testing.assert_close(state, want_h, **_SCAN_TOL)
        torch.testing.assert_close(y, want_y, **_SCAN_TOL)


def _rglru_args(rng, b, s, w, dtype, with_h0, dev):
    x = _normal(rng, (b, s, w), dtype, dev)
    r = torch.sigmoid(_normal(rng, (b, s, w), torch.float32, dev))
    i = torch.sigmoid(_normal(rng, (b, s, w), torch.float32, dev))
    la = -8.0 * torch.nn.functional.softplus(
        _normal(rng, (w,), torch.float32, dev))
    h0 = _normal(rng, (b, w), torch.float32, dev) if with_h0 else None
    return x, r, i, la, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w", [
    (16, 1, 4096),         # the decode step: the direct kernel
    (2, 4, 200),           # the direct kernel's longest call
    (2, 5, 4096),          # the staged kernel's shortest: one partial tile
    (3, 37, 200),          # two tiles, a partial channel block
    (8, 80, 4096),         # the 8 × 80 prefill: three tiles
    (2, 129, 4096),        # five tiles, the last of one step
    (3, 37, 203),          # W not a multiple of 8: the generic staging
    (2, 129, 61),
])
def test_rglru_scan_kernel_bit_equal(dev, dtype, with_h0, b, s, w):
    """Both kernels (direct for S <= 4, staged above) equal the plain
    version bit for bit, y and h, also with ``h_out`` aliasing ``h0``."""
    x, r, i, la, h0 = _rglru_args(_gen(7 * b + s + w), b, s, w, dtype,
                                  with_h0, dev)
    want_y, want_h = rglru_scan(x, r, i, la, h0, force="ref")
    reset_launch_counts()
    got_y, got_h = rglru_scan(x, r, i, la, h0, force="kernel")
    assert launch_counts() == {"rglru_scan": 1}
    torch.cuda.synchronize()
    assert torch.equal(got_y, want_y) and torch.equal(got_h, want_h)
    if h0 is not None:
        state = h0.clone()
        y, h = rglru_scan(x, r, i, la, state, h_out=state, force="kernel")
        torch.cuda.synchronize()
        assert h is state
        assert torch.equal(y, want_y) and torch.equal(state, want_h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_kernel_unaligned_operands(dev, dtype):
    """Contiguous operands that do not start on a 16-byte boundary (views
    one element into their storage) take the generic staging, bit-equal."""
    b, s, w = 2, 40, 256
    x, r, i, la, h0 = _rglru_args(_gen(5), b, s, w, dtype, True, dev)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    xs, rs, is_ = shifted(x), shifted(r), shifted(i)
    assert xs.data_ptr() % 16 and rs.data_ptr() % 16
    want_y, want_h = rglru_scan(x, r, i, la, h0, force="ref")
    got_y, got_h = rglru_scan(xs, rs, is_, la, h0, force="kernel")
    torch.cuda.synchronize()
    assert torch.equal(got_y, want_y) and torch.equal(got_h, want_h)


def _bwd_close(got, want, what):
    """A scan's backward kernel against its plain VJP: each gradient within
    1e-5 of its largest |entry| (the kernels sum over the channels, the
    steps and the rows in another order than torch, and the selective scan
    takes exp(dt·A) on the SFU, relative error ~2^-22, in g's recurrence
    too); a bf16 gradient also within one bf16 rounding of each entry (the
    two round float32 values that may differ in their last bits)."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    g, w = got.double(), want.double()
    tol = 1e-5 * float(w.abs().max())
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * w.abs()
    diff = (g - w).abs()
    assert bool((diff <= tol).all()), f"{what}: max |diff| {float(diff.max())}"


def _mamba_bwd_args(rng, b, s, di, n, dtype, with_states, dev):
    x = _normal(rng, (b, s, di), dtype, dev)
    dt = torch.nn.functional.softplus(
        0.5 * _normal(rng, (b, s, di), torch.float32, dev))
    proj = _normal(rng, (b, s, 3 + 2 * n), dtype, dev)
    A = -torch.exp(0.2 * _normal(rng, (di, n), torch.float32, dev))
    D = _normal(rng, (di,), torch.float32, dev)
    h0 = _normal(rng, (b, di, n), torch.float32, dev) if with_states else None
    dy = _normal(rng, (b, s, di), torch.float32, dev)
    dh = _normal(rng, (b, di, n), torch.float32, dev) if with_states else None
    return (x, dt, proj[..., 3:3 + n], proj[..., 3 + n:], A, D, h0), dy, dh


_MAMBA_BWD_CASES = [
    # Falcon-Mamba-7B's training shape, as the model calls it
    (8, 512, 8192, 16, torch.bfloat16, False),
    *((*shape, dtype, states)
      for shape in ((3, 37, 200, 16),     # ragged S and Di
                    (2, 1, 130, 4),       # one step, the SMOKE state size
                    (2, 65, 203, 16),     # three tiles, the last of one step
                    (3, 37, 136, 5),      # N not a multiple of a lane's 4
                    (2, 33, 61, 16))      # channels below a block's 64
      for dtype in (torch.float32, torch.bfloat16)
      for states in (False, True)),
]


@pytest.mark.parametrize("b,s,di,n,dtype,with_states", _MAMBA_BWD_CASES)
def test_mamba_scan_bwd_kernel(dev, b, s, di, n, dtype, with_states):
    """The training launch gives the serving launch's y and h bits and the
    states entering each 32-step tile; the backward kernel recomputes the
    forward's final state bit for bit from them, equals the plain VJP
    within ``_bwd_close``, and two launches give the same bits."""
    args, dy, dh = _mamba_bwd_args(_gen(b + s + di + n), b, s, di, n, dtype,
                                   with_states, dev)
    reset_launch_counts()
    y, h, tiles = selective_scan(*args, force="kernel", return_tiles=True)
    serve_y, serve_h = selective_scan(*args, force="kernel")
    torch.cuda.synchronize()
    assert torch.equal(y, serve_y) and torch.equal(h, serve_h)
    assert torch.equal(tiles[:, 0], torch.zeros_like(h) if args[-1] is None
                       else args[-1])
    h_last = torch.full_like(h, float("nan"))
    got = selective_scan_bwd(*args, dy, dh, h_tiles=tiles, h_last=h_last,
                             force="kernel")
    again = selective_scan_bwd(*args, dy, dh, h_tiles=tiles, force="kernel")
    assert launch_counts() == {"mamba_scan": 2, "mamba_scan_bwd": 2}
    want = selective_scan_bwd(*args, dy, dh, h_tiles=tiles, force="ref")
    torch.cuda.synchronize()
    assert torch.equal(h_last, h)
    names = ("dx", "ddt", "dB", "dC", "dA", "dD", "dh0")
    for name, g, a, w in zip(names, got, again, want):
        assert torch.equal(g, a), name
        _bwd_close(g, w, name)


def test_mamba_scan_bwd_kernel_copies_dy_and_needs_the_states(dev):
    """A stride-0 ``dy`` (from ``y.sum()``) is copied; the kernel path
    refuses to run without the training launch's ``h_tiles`` (it makes no
    forward launch of its own)."""
    args, _, _ = _mamba_bwd_args(_gen(5), 2, 40, 130, 16, torch.bfloat16,
                                 False, dev)
    dy = torch.ones((), device=dev).expand(2, 40, 130)
    _, _, tiles = selective_scan(*args, force="kernel", return_tiles=True)
    reset_launch_counts()
    with pytest.raises(ValueError, match="h_tiles"):
        selective_scan_bwd(*args, dy, h_tiles=None, force="kernel")
    got = selective_scan_bwd(*args, dy, h_tiles=tiles, force="kernel")
    assert launch_counts() == {"mamba_scan_bwd": 1}
    want = selective_scan_bwd(*args, dy, h_tiles=tiles, force="ref")
    for g, w in zip(got, want):
        _bwd_close(g, w, "stride-0 dy")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_states", [False, True])
@pytest.mark.parametrize("b,s,w", [
    (8, 512, 4096),        # RecurrentGemma-9B's training shape
    (3, 37, 200),          # two tiles, a partial channel block
    (2, 1, 45),            # one step
    (2, 129, 203),         # five tiles, the last of one step
])
def test_rglru_scan_bwd_kernel(dev, dtype, with_states, b, s, w):
    """dx, dr, di and dh0 equal the plain VJP bit for bit (the same float32
    operations in the same order, IEEE expf, sqrtf and division); dla,
    summed over the steps and then the rows in another order, within
    ``_bwd_close``; lanes where the clamp holds (r = 0) included; two
    launches give the same bits."""
    rng = _gen(3 * b + s + w)
    x, r, i, la, h0 = _rglru_args(rng, b, s, w, dtype, with_states, dev)
    r[..., ::7] = 0.0
    dy = _normal(rng, (b, s, w), torch.float32, dev)
    dh = _normal(rng, (b, w), torch.float32, dev) if with_states else None
    y, _ = rglru_scan(x, r, i, la, h0, force="kernel")
    reset_launch_counts()
    got = rglru_scan_bwd(x, r, i, la, h0, y, dy, dh, force="kernel")
    again = rglru_scan_bwd(x, r, i, la, h0, y, dy, dh, force="kernel")
    assert launch_counts() == {"rglru_scan_bwd": 2}
    want = rglru_scan_bwd(x, r, i, la, h0, y, dy, dh, force="ref")
    torch.cuda.synchronize()
    for name, g, a, wt in zip(("dx", "dr", "di", "dla", "dh0"), got, again,
                              want):
        assert torch.equal(g, a), name
        if name == "dla":
            _bwd_close(g, wt, name)
        else:
            assert torch.equal(g, wt), name


# ------------------------------------------------- the scenario path's masks

def _tier_mask(tier_flat, tier_ok):
    """(F,) y_ok from a (2,) tier availability, as ``tier_y_ok``."""
    ok = torch.tensor(tier_ok, dtype=torch.float32, device=tier_flat.device)
    return torch.where(tier_flat > 0.5, ok[1], ok[0]).contiguous()


@pytest.mark.parametrize("tier_ok", [(0, 1), (1, 0), (0, 0)],
                         ids=["edge_out", "cloud_out", "both_out"])
@pytest.mark.parametrize("k", [5, 6])
@pytest.mark.parametrize("m", [1, 37, 4096, 9001])
def test_ccg_solve_kernel_tier_out(dev, m, k, tier_ok):
    """``y_ok`` with a tier out (or both) on both instantiations (K = 5:
    tables; K = 6: generic) equals the plain version exactly: no lane on a
    dead tier while the other lives, every lane infeasible on its fallback
    index when both are out."""
    args = _ccg_synthetic(dev, m, k, 16, 50)
    y_ok = _tier_mask(args[4], tier_ok)
    kw = dict(margin=0.02, num_versions=k, y_ok=y_ok)
    want = ccg_solve(*args, force="ref", **kw)
    reset_launch_counts()
    got = ccg_solve(*args, force="kernel", **kw)
    assert launch_counts() == {"ccg_solve": 1}
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    on_dead = y_ok[got[0].long()] <= 0
    if any(tier_ok):
        assert not bool(on_dead.any())
    else:
        assert bool(got[5].all())


@pytest.mark.parametrize("m", [37, 4096])
def test_ccg_solve_kernel_all_up_mask_is_no_mask(dev, m):
    """A ``y_ok`` of ones gives the bits of no mask (the same launch)."""
    prob = RobustProblem.build(SystemConfig(), dev)
    lat = prob.lat
    rng = _gen(m + 1)
    args = (_t(rng.uniform(0, 1, m).astype(np.float32), dev),
            _t(rng.uniform(0.5, 0.8, m).astype(np.float32), dev),
            lat.rn_flat, lat.pn_flat, lat.tier_flat, lat.b2_flat, prob.u_all,
            lat.c1_flat, _t(rng.integers(-1, 50, m).astype(np.int32), dev))
    kw = dict(margin=0.02, num_versions=5, force="kernel")
    got = ccg_solve(*args, y_ok=_tier_mask(lat.tier_flat, (1, 1)), **kw)
    want = ccg_solve(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _alive(kind, m, seed):
    mask = {"all": np.ones(m, bool), "none": np.zeros(m, bool),
            "half": _gen(seed).random(m) < 0.5}[kind]
    return mask


@pytest.mark.parametrize("alive", ["all", "none", "half"])
@pytest.mark.parametrize("demoting", [True, False])
@pytest.mark.parametrize("m", [60, 256, 4096, REPAIR_CAP + 1, 53248,
                               CLUSTER_CAP + 1])
def test_c6_repair_kernel_alive_mask(dev, m, demoting, alive):
    """The alive mask on the one-block and the cluster kernels (their bits
    those of their orders emulated with the mask) and above the cluster's
    cap on the per-round path, held to the plain version with the same
    mask: r and p equal outside the boundary exemption, the history within
    1e-6; dead lanes never move."""
    args, budget = _repair_case(dev, m, demoting, seed=m + 7)
    mask = torch.from_numpy(_alive(alive, m, m)).to(dev)
    if alive == "half":         # the budget against the alive lanes' draw
        budget = float(np.float32(0.5 * budget))
    reset_launch_counts()
    got = c6_repair(*args, budget, n_fps=5, rounds=8, force="kernel",
                    task_mask=mask)
    assert launch_counts() == _repair_launches(m, 8)
    emulated = _repair_emulated(m, *args, budget, n_fps=5, rounds=8,
                                task_mask=mask)
    if emulated is not None:
        for g, e in zip(got, emulated):
            assert torch.equal(g, e)
    run_k = lambda k: c6_repair(*args, budget, n_fps=5, rounds=k,
                                force="kernel", task_mask=mask)
    run_r = lambda k: c6_repair_ref(*args, budget, n_fps=5, rounds=k,
                                    task_mask=mask)
    demoted = compare_runs(run_k, run_r, 8, args, budget, (), mask)
    assert torch.equal(got[0][~mask], args[1][~mask])
    assert torch.equal(got[1][~mask], args[2][~mask])
    if alive == "none":
        assert demoted == 0 and float(got[2].abs().max()) == 0.0
    elif demoting:
        assert demoted >= 1


@pytest.mark.parametrize("demoting", [True, False])
@pytest.mark.parametrize("m", [60, 4096, REPAIR_CAP + 1, CLUSTER_CAP + 1])
def test_c6_repair_kernel_all_alive_is_no_mask(dev, m, demoting):
    """An all-true mask gives the bits of no mask, on both paths."""
    args, budget = _repair_case(dev, m, demoting, seed=m + 9)
    mask = torch.ones((m,), dtype=torch.bool, device=dev)
    got = c6_repair(*args, budget, n_fps=5, rounds=8, force="kernel",
                    task_mask=mask)
    want = c6_repair(*args, budget, n_fps=5, rounds=8, force="kernel")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_c6_repair_kernel_refuses_a_mask_of_another_dtype(dev):
    args, budget = _repair_case(dev, 60, True, seed=1)
    with pytest.raises(TypeError, match="task_mask"):
        c6_repair(*args, budget, n_fps=5, rounds=8, force="kernel",
                  task_mask=torch.ones(60, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dead", [(), (1,), (0, 1, 2)])
def test_lpt_queue_kernel_dead_lanes_and_servers(dev, dead):
    """A churned round at M = 4096: dead lanes at t_comp = 0 (they sort
    after every alive lane), dead edge servers at +inf, mixed routes:
    exact."""
    t, route = _lpt_case(len(dead), (2, 4096), "mixed", ties=True)
    lanes = _gen(5).random((2, 4096)) < 0.5
    t[~lanes] = 0.0
    avail = np.ones((2, 5), np.float32)
    avail[:, list(dead)] = 0.0
    args = (_t(t, dev), _t(route, dev), 4, 1)
    got = lpt_queue(*args, avail=_t(avail, dev), force="kernel")
    want = lpt_queue(*args, avail=_t(avail, dev), force="ref")
    assert torch.equal(got, want)


_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,sq,sk,d,window,causal,layout", [
    (8, 16, 16, 128, 128, 64, None, True, None),   # Qwen1.5-0.5B's heads
    (2, 32, 8, 70, 70, 128, None, True, None),     # Qwen3-8B's GQA
    (2, 16, 1, 100, 100, 256, 16, True, None),     # D = 256, window
    (1, 4, 2, 5, 70, 64, None, False, None),       # non-causal, Sq < Sk
    (2, 12, 4, 70, 45, 32, 30, False, None),       # non-causal window
    (2, 4, 4, 48, 48, 16, None, True, None),       # SMOKE head dims
    (2, 8, 2, 40, 40, 8, 16, True, None),
    (2, 12, 2, 80, 80, 128, None, True, "qwen2vl"),  # runtime positions
    (2, 8, 2, 70, 70, 64, 24, True, "shuffled"),
    # the tensor-core kernels (bf16, D 32-128): ragged lengths, GQA with
    # G = 4, a window, both position layouts, Sq < Sk non-causal
    (2, 16, 4, 100, 100, 64, None, True, None),
    (2, 32, 8, 100, 100, 128, 40, True, None),
    (2, 16, 4, 70, 70, 32, 24, True, "qwen2vl"),
    (2, 16, 4, 100, 100, 128, None, True, "shuffled"),
    (1, 8, 8, 40, 100, 128, None, False, None),
    (1, 16, 1, 65, 65, 256, 20, True, "shuffled"),   # D 256: split dK/dV
])
def test_flash_attention_bwd_kernel(dev, dtype, b, h, kv, sq, sk, d, window,
                                    causal, layout):
    rng = _gen(b * sq + sk + d)
    q = _normal(rng, (b, sq, h, d), dtype, dev).transpose(1, 2)
    k = _normal(rng, (b, sk, kv, d), dtype, dev).transpose(1, 2)
    v = _normal(rng, (b, sk, kv, d), dtype, dev).transpose(1, 2)
    do = _normal(rng, (b, sq, h, d), dtype, dev).transpose(1, 2)
    kw = dict(window=window, causal=causal)
    if layout is not None:
        kw["positions"] = _positions(layout, b, sq, dev, seed=sq)
    o = flash_attention(q, k, v, force="kernel", **kw)
    reset_launch_counts()
    got = flash_attention_bwd(q, k, v, o, do, force="kernel", **kw)
    again = flash_attention_bwd(q, k, v, o, do, force="kernel", **kw)
    assert launch_counts() == {"flash_attention_bwd": 2}
    want = attention_vjp_ref(q, k, v, do, **kw)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape and torch.equal(g, a)
        err = float((g.double() - w.double()).abs().max())
        assert err <= _BWD_TOL[dtype] * max(1.0, float(w.abs().max())), err


@pytest.mark.parametrize("b,h,kv,sq,sk,d,window,causal,layout", [
    (8, 16, 16, 128, 128, 64, None, True, None),
    (2, 32, 8, 70, 70, 128, 24, True, None),
    (2, 16, 4, 100, 100, 32, None, True, "qwen2vl"),
    (2, 8, 2, 70, 70, 64, 24, True, "shuffled"),
    (1, 4, 2, 5, 70, 64, None, False, None),
])
def test_flash_attention_training_launch(dev, b, h, kv, sq, sk, d, window,
                                         causal, layout):
    """The training launch (``return_lse``) gives the serving launch's
    output bit for bit and each row's LSE, in log2 units, within 1e-5 of
    the plain one's (times log2 e); in float32 it stores none (its
    backward recomputes the statistics)."""
    rng = _gen(b * sq + sk + d + 1)
    q = _normal(rng, (b, sq, h, d), torch.bfloat16, dev).transpose(1, 2)
    k = _normal(rng, (b, sk, kv, d), torch.bfloat16, dev).transpose(1, 2)
    v = _normal(rng, (b, sk, kv, d), torch.bfloat16, dev).transpose(1, 2)
    kw = dict(window=window, causal=causal)
    if layout is not None:
        kw["positions"] = _positions(layout, b, sq, dev, seed=sq)
    reset_launch_counts()
    serve = flash_attention(q, k, v, force="kernel", **kw)
    o, lse = flash_attention(q, k, v, force="kernel", return_lse=True, **kw)
    assert launch_counts() == {"flash_attention": 2}
    assert torch.equal(o, serve)
    want = attention_lse_ref(q, k, **kw).double()
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    err = (lse.double() / LOG2E - want).abs()
    assert bool((err <= 1e-5 * want.abs().clamp_min(1.0)).all()), \
        float(err.max())
    f32 = [x.float() for x in (q, k, v)]
    o32, lse32 = flash_attention(*f32, force="kernel", return_lse=True, **kw)
    assert lse32 is None
    assert torch.equal(o32, flash_attention(*f32, force="kernel", **kw))


@pytest.mark.parametrize("grad", ["sum", "transposed"])
def test_flash_attention_autograd_takes_any_gradient_layout(dev, grad):
    """FlashAttentionFn's backward gets the output's gradient in the layout
    autograd gives it: stride 0 from ``out.sum()`` (copied contiguous) or a
    transposed view (read by its strides); both run the kernels."""
    rng = _gen(7)
    q, k, v = (_normal(rng, (2, 64, 8, 64), torch.bfloat16, dev)
               .transpose(1, 2).requires_grad_(True) for _ in range(3))
    reset_launch_counts()
    out = flash_attention_autograd(q, k, v)
    if grad == "sum":
        out.sum().backward()
        do = torch.ones_like(out)
    else:
        do = _normal(rng, (2, 64, 8, 64), torch.bfloat16, dev).transpose(1, 2)
        out.backward(do)
    assert launch_counts() == {"flash_attention": 1,
                               "flash_attention_bwd": 1}
    want = attention_vjp_ref(q.detach(), k.detach(), v.detach(), do)
    for x, w in zip((q, k, v), want):
        err = float((x.grad.double() - w.double()).abs().max())
        assert err <= _BWD_TOL[torch.bfloat16] * max(1.0, float(w.abs().max()))


def test_flash_attention_autograd_runs_the_backward_kernel(dev):
    rng = _gen(3)
    q, k, v = (_normal(rng, (2, 64, 8, 64), torch.bfloat16, dev)
               .transpose(1, 2).requires_grad_(True) for _ in range(3))
    reset_launch_counts()
    out = flash_attention_autograd(q, k, v, window=24)
    out.float().square().sum().backward()
    assert launch_counts() == {"flash_attention": 1,
                               "flash_attention_bwd": 1}
    want = attention_vjp_ref(q.detach(), k.detach(), v.detach(),
                             2 * out.detach(), window=24)
    for x, w in zip((q, k, v), want):
        err = float((x.grad.double() - w.double()).abs().max())
        assert err <= 2e-2 * max(1.0, float(w.abs().max()))


def test_kernels_without_a_backward_refuse_autograd(dev):
    """A wrapper whose kernel has no backward raises on an input that
    needs a gradient (its output would carry none) and launches nothing;
    under no_grad it runs and counts as before."""
    g = torch.Generator(dev).manual_seed(0)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    calls = {
        "decode_attention": lambda x: decode_attention(
            x(2, 8, 64), n(2, 2, 20, 64), n(2, 2, 20, 64),
            torch.full((2,), 5, device=dev)),
        "flash_attention": lambda x: flash_attention(
            x(1, 4, 16, 64), n(1, 2, 16, 64), n(1, 2, 16, 64)),
        "mamba_scan": lambda x: selective_scan(
            x(2, 3, 16), n(2, 3, 16).abs(), n(2, 3, 4), n(2, 3, 4),
            -n(16, 4).abs(), n(16)),
        "rglru_scan": lambda x: rglru_scan(
            x(2, 3, 16), torch.sigmoid(n(2, 3, 16)),
            torch.sigmoid(n(2, 3, 16)), -n(16).abs()),
        "lpt_queue": lambda x: lpt_queue(
            x(64).abs(), torch.zeros(64, dtype=torch.int32, device=dev),
            4, 1),
    }
    for name, call in calls.items():
        needs_grad = lambda *s: n(*s).requires_grad_(True)
        reset_launch_counts()
        with pytest.raises(NotImplementedError, match="no backward"):
            call(needs_grad)
        assert launch_counts() == {}, name
        with torch.no_grad():
            call(needs_grad)
        call(n)
        assert launch_counts() == {name: 2}, name


# a recurrent SMOKE model in float32: each gradient leaf, kernels against
# plain, within 1e-4 of the leaf's largest |entry| (the scans' and the
# attention's kernels sum in other orders and the selective scan takes
# exp(dt·A) on the SFU; the differences grow through the layers)
TRAIN_GRAD_TOL = 1e-4


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_recurrent_models_train_on_the_kernel_path(dev, arch, tmp_path):
    """The SMOKE Falcon-Mamba and RecurrentGemma models train on the card
    through the scans' autograd functions: the loss and every gradient leaf
    (float32 compute) against ``force="ref"`` (the plain scans and plain
    VJPs), then one ``Trainer`` step (bf16 compute, remat) that launches
    each recurrent layer's scan twice (the forward and its recomputation)
    and its backward kernel once, and each attention layer's kernels as
    the dense models' step does."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    params = init_params(model_specs(cfg),
                         torch.Generator(dev).manual_seed(0), dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
        TokenPipeline(cfg.vocab_size, 64, 4)).items()}
    out = {force: grads_of(Ctx(cfg=cfg, mode="train", force=force), params,
                           batch) for force in ("auto", "ref")}
    (loss, _, grads), (want_loss, _, want_grads) = out["auto"], out["ref"]
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    for g, w in zip(tree_leaves(grads), tree_leaves(want_grads)):
        assert bool(torch.isfinite(g).all())
        err = float((g - w).abs().max())
        assert err <= TRAIN_GRAD_TOL * float(w.abs().max()), (arch, err)

    cfg = get_smoke_config(arch)
    tr = Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path),
                                  opt=AdamWConfig(warmup_steps=1)),
                 device=dev)
    state = tr.init_state()
    batch = tr._device_batch(next(TokenPipeline(cfg.vocab_size, 64, 4)))
    reset_launch_counts()
    *_, metrics = tr._step(*state, batch)
    kinds = collections.Counter(cfg.layer_kinds())
    scan = "mamba_scan" if arch == "falcon-mamba-7b" else "rglru_scan"
    recurrent = kinds["ssm"] + kinds["rglru"]
    want = {scan: 2 * recurrent, f"{scan}_bwd": recurrent}
    if kinds["attn"]:
        want.update(flash_attention=2 * kinds["attn"],
                    flash_attention_bwd=kinds["attn"])
    assert launch_counts() == want
    assert torch.isfinite(metrics["loss"])


def test_train_step_launches_the_attention_kernels(dev, tmp_path):
    """One ``Trainer`` step of the SMOKE Qwen model on the card: the
    forward kernel twice a layer (the forward and its recomputation under
    remat) and the backward kernel once a layer."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    tr = Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path),
                                  opt=AdamWConfig(warmup_steps=1)),
                 device=dev)
    state = tr.init_state()
    batch = tr._device_batch(next(TokenPipeline(cfg.vocab_size, 64, 4)))
    reset_launch_counts()
    *_, metrics = tr._step(*state, batch)
    assert launch_counts() == {"flash_attention": 2 * cfg.num_layers,
                               "flash_attention_bwd": cfg.num_layers}
    assert torch.isfinite(metrics["loss"])
