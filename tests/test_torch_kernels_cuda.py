"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA Hopper GPU and nvcc; skipped where CUDA is absent.  On a
machine with the card and without JAX (whose import ``tests/conftest.py``
needs), run ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_kernels_cuda.py``.
``gate_cell`` is held to 1e-5 absolute (its dot products sum in another
order than torch's GEMM); ``ccg_solve``, ``c6_tail``, ``lpt_queue``,
``ccg_encode`` and ``ccg_master`` run the plain versions' float32 operations
in the same order with ``-fmad=false`` (or only exact ones: min, max,
compares), so they must match exactly.  ``decode_attention`` and
``flash_attention`` sum in another order than the plain versions and round
each probability to the value type before P·V (as the TPU kernels do): they
are held to |kernel − plain| <= 2e-5 + 2e-5·|plain| in float32 and
2e-2 + 2e-2·|plain| in bfloat16 (two bf16 ulps near 1), the tolerances of
the reference's own kernel tests.  ``mamba_scan`` and ``rglru_scan`` repeat
the plain versions' float32 state updates in order with ``-fmad=false``;
the selective scan takes exp(dt·A) in base 2 on the special function unit
and sums y in another order than torch's einsum, so both are held to
1e-5 + 1e-5·|plain| (their outputs are float32 whatever the input dtype).
The bf16 flash kernel copies 16-byte row chunks: misaligned rows raise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cost_model import SystemConfig, fps_norm, res_norm
from repro_torch.core.gating import GateConfig, init_gate_params
from repro_torch.core.robust import RobustProblem
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels.c6_tail.ops import c6_tail
from repro_torch.kernels.ccg_encode.ops import ccg_encode
from repro_torch.kernels.ccg_master.ops import ccg_master
from repro_torch.kernels.ccg_solve.ops import ccg_solve
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.lpt_queue.ops import lpt_queue
from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.kernels.rglru.ops import rglru_scan
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
