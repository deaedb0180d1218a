"""The port's plain RG-LRU scan (``repro_torch.kernels.rglru``) on the CPU
against the JAX package on identical numpy inputs: the reference model's
scan (``repro.models.rglru.rglru_scan_ref``, the function the model runs),
the kernel's oracle (``repro.kernels.rglru.ref``) and the Pallas kernel in
interpret mode (on tile multiples, as ``tests/test_kernels.py`` runs it),
with the state carried across two halves of the sequence.  Tolerance:
1e-5 absolute + 1e-5 relative (float32; exp and sqrt of two libraries).
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax.numpy as jnp
from repro.kernels.rglru.kernel import rglru_scan as j_pallas
from repro.kernels.rglru.ref import rglru_scan_ref as j_kernel_ref
from repro.models.rglru import rglru_scan_ref as j_model_scan
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rglru.ref import rglru_scan_ref

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(b, s, w, seed=0):
    rng = np.random.default_rng(seed)
    sig = lambda a: (1.0 / (1.0 + np.exp(-a))).astype(np.float32)
    x = rng.normal(size=(b, s, w)).astype(np.float32)
    r = sig(rng.normal(size=(b, s, w)))
    i = sig(rng.normal(size=(b, s, w)))
    la = (-8.0 * np.log1p(np.exp(rng.normal(size=w)))).astype(np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32)
    return x, r, i, la, h0


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w", [(2, 32, 64), (3, 37, 50), (1, 1, 24)])
def test_plain_scan_matches_reference_model_and_oracle(b, s, w, with_h0):
    """Ragged shapes included: the plain scan takes any S and W."""
    x, r, i, la, h0 = _inputs(b, s, w, seed=s + w)
    h0 = h0 if with_h0 else None
    args = [x, r, i, la, h0]
    y, h = rglru_scan_ref(*[None if a is None else torch.from_numpy(a)
                            for a in args])
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    for ref in (j_model_scan, j_kernel_ref):
        jy, jh = ref(*jargs)
        _close(y, jy)
        _close(h, jh)


def test_plain_scan_matches_pallas_interpret_with_carried_state():
    b, s, w, bt, bw = 2, 32, 64, 16, 32
    x, r, i, la, _ = _inputs(b, s, w, seed=1)
    half = s // 2
    tx = [torch.from_numpy(a) for a in (x, r, i)]
    tla = torch.from_numpy(la)
    y1, h1 = rglru_scan_ref(*[t[:, :half] for t in tx], tla)
    y2, h2 = rglru_scan_ref(*[t[:, half:] for t in tx], tla, h1)
    jy, jh = j_pallas(*[jnp.asarray(a) for a in (x, r, i, la)], block_t=bt,
                      block_w=bw, interpret=True)
    _close(torch.cat([y1, y2], dim=1), jy)
    _close(h2, jh)


def test_bf16_x_read_exactly():
    """x in bf16 (the model's recurrent branch) gives the scan of its
    float32 values."""
    x, r, i, la, h0 = _inputs(2, 9, 40, seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y, h = rglru_scan_ref(xb, *[torch.from_numpy(a) for a in (r, i, la, h0)])
    jy, jh = j_model_scan(jnp.asarray(xb.float().numpy()),
                          *[jnp.asarray(a) for a in (r, i, la, h0)])
    _close(y, jy)
    _close(h, jh)


def test_wrapper_on_cpu_writes_h_out_in_place_uncounted():
    """The wrapper runs the plain version for CPU tensors (no launch
    counted) and writes the final state into ``h_out``, which may be
    ``h0`` itself."""
    x, r, i, la, h0 = _inputs(2, 5, 32, seed=3)
    args = [torch.from_numpy(a) for a in (x, r, i, la)]
    want_y, want_h = rglru_scan_ref(*args, torch.from_numpy(h0))
    state = torch.from_numpy(h0.copy())
    reset_launch_counts()
    y, h = rglru_scan(*args, state, h_out=state)
    assert h is state and launch_counts() == {}
    assert torch.equal(y, want_y) and torch.equal(state, want_h)
    y, h = rglru_scan(*args, force="ref")
    assert h.shape == (2, 32) and h.dtype == torch.float32
