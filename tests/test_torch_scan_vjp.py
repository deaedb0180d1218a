"""The scans' plain VJPs and autograd functions against the live JAX package.

* ``selective_scan_vjp_ref`` and ``rglru_scan_vjp_ref`` against ``jax.vjp``
  of the reference's own scans (``repro/models/ssm.py`` and
  ``repro/models/rglru.py`` at ``chunk=1``, and ``repro/kernels/*/ref.py``)
  on the same numpy inputs: with and without h0, with and without a
  cotangent on the final state, at S = 1 and 37 and channel counts that are
  not a multiple of 32, x, B and C in bf16 as well as float32, and RG-LRU
  lanes where the clamp of sqrt(max(1 − a², 1e-12)) holds (r = 0, and
  la·r too small for exp to leave 1).  Float32 gradients within 1e-5
  absolute and relative (the scans' ``SCAN_TOL``: sums in another order,
  measured below 1e-6); bf16 gradients within one bf16 rounding (2^-7
  relative) of the reference's, which rounds the same float32 value that
  may differ in its last bits.
* ``SelectiveScanFn`` and ``RGLRUScanFn`` on the CPU (the plain scan and
  the plain VJP) against autograd through the plain scans, with a
  cotangent on y, on h or on both, and a stride-0 ``dy`` from ``y.sum()``.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
import jax.numpy as jnp
from repro.kernels.mamba_scan.ref import selective_scan_ref as j_mamba_kernel
from repro.kernels.rglru.ref import rglru_scan_ref as j_rglru_kernel
from repro.models.rglru import rglru_scan_ref as j_rglru_model
from repro.models.ssm import selective_scan_ref as j_mamba_model
from repro_torch.kernels.mamba_scan.ops import (
    selective_scan_autograd,
    selective_scan_bwd,
)
from repro_torch.kernels.mamba_scan.ref import (
    selective_scan_ref,
    selective_scan_vjp_ref,
)
from repro_torch.kernels.rglru.ops import rglru_scan_autograd, rglru_scan_bwd
from repro_torch.kernels.rglru.ref import rglru_scan_ref, rglru_scan_vjp_ref

TOL = 1e-5                 # float32: atol = rtol
BF16_RTOL = 2.0 ** -7      # one bf16 rounding of the same float32 value
STATES = [(False, False), (True, True), (False, True), (True, False)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(t):
    """The torch tensor's values for JAX, in its dtype."""
    if t is None:
        return None
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _close(got, want, what):
    got = got.float()
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    assert got.shape == want.shape, what
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL, msg=what)


def _close_typed(got, want, what, dtype):
    """``got`` in ``dtype`` against the reference's gradient in its dtype."""
    assert got.dtype == dtype, what
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    rtol = BF16_RTOL if dtype == torch.bfloat16 else TOL
    torch.testing.assert_close(got.float(), want, atol=TOL, rtol=rtol,
                               msg=what)


def _jax_vjp(fn, args, with_h0, cot):
    """jax.vjp of ``fn(*args, h0)`` with cotangents ``cot`` (dy, dh)."""
    if with_h0:
        _, vjp = jax.vjp(fn, *args)
    else:
        _, vjp = jax.vjp(lambda *a: fn(*a, None), *args[:-1])
    return vjp(cot)


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------
def _mamba_inputs(b, s, di, n, dtype, with_h0, with_dh, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = _t(r(b, s, di), dtype)
    dt = torch.nn.functional.softplus(_t(0.5 * r(b, s, di)))
    bm, cm = _t(r(b, s, n), dtype), _t(r(b, s, n), dtype)
    A = -torch.exp(_t(0.2 * r(di, n)))
    D = _t(r(di))
    h0 = _t(r(b, di, n)) if with_h0 else None
    dy = _t(r(b, s, di))
    dh = _t(r(b, di, n)) if with_dh else None
    return (x, dt, bm, cm, A, D, h0), dy, dh


@pytest.mark.parametrize("with_h0,with_dh", STATES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,di,n", [(2, 1, 45, 16), (2, 37, 45, 16),
                                      (3, 37, 40, 4)])
def test_selective_scan_vjp_matches_jax(b, s, di, n, dtype, with_h0,
                                        with_dh):
    args, dy, dh = _mamba_inputs(b, s, di, n, dtype, with_h0, with_dh)
    got = selective_scan_vjp_ref(*args, dy, dh)
    names = ("dx", "ddt", "dB", "dC", "dA", "dD", "dh0")
    typed = {"dx": dtype, "dB": dtype, "dC": dtype}
    cot = (_j(dy), jnp.zeros((b, di, n), jnp.float32) if dh is None
           else _j(dh))
    for label, fn in (("models/ssm.py", lambda *a: j_mamba_model(
            *a, chunk=1)), ("kernels/mamba_scan/ref.py", j_mamba_kernel)):
        want = _jax_vjp(fn, [_j(t) for t in args], with_h0, cot)
        for name, g, w in zip(names, got, want):
            what = f"{name} vs jax.vjp of {label}"
            if name in typed:
                _close_typed(g, w, what, typed[name])
            else:
                _close(g, w, what)
        if not with_h0:
            assert len(want) == 6


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------
def _rglru_inputs(b, s, w, dtype, with_h0, with_dh, clamped, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = _t(r(b, s, w), dtype)
    rgate = torch.sigmoid(_t(r(b, s, w)))
    if clamped:    # a = 1 exactly: r = 0, and la·r too small to leave 1
        rgate[:, :, ::3] = 0.0
        rgate[:, :, 1::5] = 1e-12
    igate = torch.sigmoid(_t(r(b, s, w)))
    la = -8.0 * torch.nn.functional.softplus(_t(r(w)))
    h0 = _t(r(b, w)) if with_h0 else None
    y, _ = rglru_scan_ref(x, rgate, igate, la, h0)
    dy = _t(r(b, s, w))
    dh = _t(r(b, w)) if with_dh else None
    return (x, rgate, igate, la, h0), y, dy, dh


@pytest.mark.parametrize("clamped", [False, True])
@pytest.mark.parametrize("with_h0,with_dh", STATES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w", [(2, 1, 45), (2, 37, 45), (3, 37, 40)])
def test_rglru_scan_vjp_matches_jax(b, s, w, dtype, with_h0, with_dh,
                                    clamped):
    args, y, dy, dh = _rglru_inputs(b, s, w, dtype, with_h0, with_dh,
                                    clamped)
    if clamped:
        a = torch.exp(args[3] * args[1])
        assert bool((1.0 - a * a <= 1e-12).any())
    got = rglru_scan_vjp_ref(*args, y, dy, dh)
    names = ("dx", "dr", "di", "dla", "dh0")
    cot = (_j(dy), jnp.zeros((b, w), jnp.float32) if dh is None else _j(dh))
    for label, fn in (("models/rglru.py", lambda *a: j_rglru_model(
            *a, chunk=1)), ("kernels/rglru/ref.py", j_rglru_kernel)):
        want = _jax_vjp(fn, [_j(t) for t in args], with_h0, cot)
        assert all(bool(jnp.isfinite(v.astype(jnp.float32)).all())
                   for v in want), label
        for name, g, wt in zip(names, got, want):
            what = f"{name} vs jax.vjp of {label}"
            if name == "dx":
                _close_typed(g, wt, what, dtype)
            else:
                _close(g, wt, what)


# ---------------------------------------------------------------------------
# the autograd functions on the CPU
# ---------------------------------------------------------------------------
def _grads(out, weights, leaves, stride0=False):
    """Gradients of Σ out·weights (a weight of None leaves the output out:
    its cotangent is absent; a leaf it leaves unused gets zeros);
    ``stride0``: y's cotangent from ``y.sum()``."""
    loss = sum((o.sum() if stride0 and i == 0 else (o * w).sum())
               for i, (o, w) in enumerate(zip(out, weights))
               if w is not None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, leaves)]


@pytest.mark.parametrize("used", ["y", "h", "both", "y_sum"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_fn_matches_autograd_of_the_plain_scan(with_h0, used):
    (x, dt, bm, cm, A, D, h0), dy, dh = _mamba_inputs(
        2, 37, 45, 16, torch.float32, True, True)
    h0 = h0 if with_h0 else None
    leaves = [t.clone().requires_grad_(True)
              for t in (x, dt, bm, cm, A, D, h0) if t is not None]
    weights = (None if used == "h" else dy, None if used == "y" else dh)
    ops = leaves + ([] if with_h0 else [None])
    got = _grads(selective_scan_autograd(*ops), weights, leaves,
                 used == "y_sum")
    want = _grads(selective_scan_ref(*ops), weights, leaves,
                  used == "y_sum")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("used", ["y", "h", "both", "y_sum"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_fn_matches_autograd_of_the_plain_scan(with_h0, used):
    (x, rgate, igate, la, h0), _, dy, dh = _rglru_inputs(
        2, 37, 45, torch.float32, True, True, clamped=False)
    h0 = h0 if with_h0 else None
    leaves = [t.clone().requires_grad_(True)
              for t in (x, rgate, igate, la, h0) if t is not None]
    weights = (None if used == "h" else dy, None if used == "y" else dh)
    ops = leaves + ([] if with_h0 else [None])
    got = _grads(rglru_scan_autograd(*ops), weights, leaves,
                 used == "y_sum")
    want = _grads(rglru_scan_ref(*ops), weights, leaves, used == "y_sum")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def test_backward_wrappers_take_the_plain_vjp_on_the_cpu_and_never_fall_back():
    """On CPU tensors the backward wrappers run the plain VJPs (and launch
    nothing); ``force="kernel"`` raises rather than fall back."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    args, dy, dh = _mamba_inputs(2, 5, 45, 16, torch.float32, True, True)
    reset_launch_counts()
    for g, w in zip(selective_scan_bwd(*args, dy, dh, h_tiles=None),
                    selective_scan_vjp_ref(*args, dy, dh)):
        assert torch.equal(g, w)
    rargs, y, rdy, rdh = _rglru_inputs(2, 5, 45, torch.float32, True, True,
                                       clamped=True)
    for g, w in zip(rglru_scan_bwd(*rargs, y, rdy, rdh),
                    rglru_scan_vjp_ref(*rargs, y, rdy, rdh)):
        assert torch.equal(g, w)
    assert launch_counts() == {}
    with pytest.raises(ValueError, match="force='kernel'"):
        selective_scan_bwd(*args, dy, dh, h_tiles=None, force="kernel")
    with pytest.raises(ValueError, match="force='kernel'"):
        rglru_scan_bwd(*rargs, y, rdy, rdh, force="kernel")
    leaves = [t.clone().requires_grad_(True) for t in rargs]
    with pytest.raises(ValueError, match="force='kernel'"):
        rglru_scan_autograd(*leaves, force="kernel")
