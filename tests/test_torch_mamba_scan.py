"""The port's plain selective scan (``repro_torch.kernels.mamba_scan``) on
the CPU against the JAX package on identical numpy inputs: the reference
model's scan (``repro.models.ssm.selective_scan_ref``, the function the
model runs), the kernel's oracle (``repro.kernels.mamba_scan.ref``) and the
Pallas kernel in interpret mode (on tile multiples, as
``tests/test_kernels.py`` runs it), with the state carried across two
halves of the sequence; and the shared causal convolution against the
reference model's.  Tolerance: 1e-5 absolute + 1e-5 relative (float32; the
y sum over the state runs in another order).
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax.numpy as jnp
from repro.kernels.mamba_scan.kernel import selective_scan as j_pallas
from repro.kernels.mamba_scan.ref import selective_scan_ref as j_kernel_ref
from repro.models.ssm import _causal_conv as j_causal_conv
from repro.models.ssm import selective_scan_ref as j_model_scan
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
from repro_torch.models.layers import causal_conv

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(b, s, di, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(0.5 * rng.normal(size=(b, s, di)))).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    A = -np.exp(0.2 * rng.normal(size=(di, n))).astype(np.float32)
    D = rng.normal(size=di).astype(np.float32)
    h0 = rng.normal(size=(b, di, n)).astype(np.float32)
    return x, dt, B, C, A, D, h0


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,di,n", [(2, 32, 64, 8), (3, 37, 50, 16),
                                      (1, 1, 24, 4)])
def test_plain_scan_matches_reference_model_and_oracle(b, s, di, n, with_h0):
    """Ragged shapes included: the plain scan takes any S and Di."""
    x, dt, B, C, A, D, h0 = _inputs(b, s, di, n, seed=s + di)
    h0 = h0 if with_h0 else None
    args = [x, dt, B, C, A, D, h0]
    y, h = selective_scan_ref(*[None if a is None else torch.from_numpy(a)
                                for a in args])
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    for ref in (j_model_scan, j_kernel_ref):
        jy, jh = ref(*jargs)
        _close(y, jy)
        _close(h, jh)


def test_plain_scan_matches_pallas_interpret_with_carried_state():
    b, s, di, n, bt, bd = 2, 32, 64, 8, 16, 32
    x, dt, B, C, A, D, _ = _inputs(b, s, di, n, seed=1)
    half = s // 2
    tx = [torch.from_numpy(a) for a in (x, dt, B, C)]
    tA, tD = torch.from_numpy(A), torch.from_numpy(D)
    y1, h1 = selective_scan_ref(*[t[:, :half] for t in tx], tA, tD)
    y2, h2 = selective_scan_ref(*[t[:, half:] for t in tx], tA, tD, h1)
    jx = [jnp.asarray(a) for a in (x, dt, B, C)]
    jy, jh = j_pallas(*jx, jnp.asarray(A), jnp.asarray(D), block_t=bt,
                      block_d=bd, interpret=True)
    _close(torch.cat([y1, y2], dim=1), jy)
    _close(h2, jh)


def test_bf16_inputs_read_exactly():
    """x, B and C in bf16 (the model's compute dtype) give the scan of their
    float32 values."""
    x, dt, B, C, A, D, h0 = _inputs(2, 9, 40, 16, seed=2)
    xb, Bb, Cb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, B, C))
    rest = [torch.from_numpy(a) for a in (A, D, h0)]
    y, h = selective_scan_ref(xb, torch.from_numpy(dt), Bb, Cb, *rest)
    f32 = lambda t: jnp.asarray(t.float().numpy())
    jy, jh = j_model_scan(f32(xb), jnp.asarray(dt), f32(Bb), f32(Cb),
                          *[jnp.asarray(a) for a in (A, D, h0)])
    _close(y, jy)
    _close(h, jh)


def test_wrapper_on_cpu_writes_h_out_in_place_uncounted():
    """The wrapper runs the plain version for CPU tensors (no launch
    counted), reads B and C as column slices of one projection, and writes
    the final state into ``h_out``, which may be ``h0`` itself."""
    x, dt, B, C, A, D, h0 = _inputs(2, 5, 32, 8, seed=3)
    proj = torch.from_numpy(np.concatenate([B, C], axis=-1))
    Bv, Cv = proj[..., :8], proj[..., 8:]
    args = (torch.from_numpy(x), torch.from_numpy(dt), Bv, Cv,
            torch.from_numpy(A), torch.from_numpy(D))
    want_y, want_h = selective_scan_ref(*args, torch.from_numpy(h0))
    state = torch.from_numpy(h0.copy())
    reset_launch_counts()
    y, h = selective_scan(*args, state, h_out=state)
    assert h is state and launch_counts() == {}
    assert torch.equal(y, want_y) and torch.equal(state, want_h)
    y, h = selective_scan(*args, force="ref")
    assert h.shape == (2, 32, 8) and h.dtype == torch.float32


@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(s, with_state):
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    bias = rng.normal(size=12).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state else None
    out, new = causal_conv(*(torch.from_numpy(a) for a in (x, w, bias)),
                           None if st is None else torch.from_numpy(st))
    jout, jnew = j_causal_conv(*(jnp.asarray(a) for a in (x, w, bias)),
                               None if st is None else jnp.asarray(st))
    _close(out, jout)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
