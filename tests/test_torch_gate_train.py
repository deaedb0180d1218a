"""The gate's training path in the port (plain versions, on the CPU)
against the live JAX package: the per-stream recurrence ``gate_step`` /
``gate_scan`` / ``gate_scan_batch``, the cell's VJP, ``gate_loss`` and its
gradient, the curriculum's ``_train_step`` and ``online_finetune``, and
the reference's two curriculum tests restated on the port.

Tolerances: the recurrence's τ, mean g and state 1e-5 absolute (the cell's
bar in ``test_torch_gate.py``); the VJP 1e-5 of each gradient's largest
|entry| (sums over the batch in another order; measured <= 5e-7 in
float32); the loss 1e-5 relative and its gradient 1e-5 of each gradient's
largest |entry|; parameters after k SGD steps 1e-6 absolute (each step
moves them by lr·gradient, so the gradients' differences shrink by lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import curriculum as jcur
from repro.core import gating as jgating
from repro.kernels.temporal_gate.ref import gate_cell_ref as j_gate_cell_ref
from repro.models.params import init_params
from repro_torch.convert import (
    gate_params_from_numpy,
    gate_state_from_numpy,
    gate_state_to_numpy,
)
from repro_torch.core import curriculum as tcur
from repro_torch.core import gating
from repro_torch.kernels.temporal_gate.ops import gate_cell_autograd
from repro_torch.kernels.temporal_gate.ref import (
    PARAM_NAMES,
    gate_cell_ref,
    gate_cell_vjp_ref,
)

D = 35
TOL = 1e-5


def _cfgs(d=D, m=32, t=8):
    return (jgating.GateConfig(d_feature=d, d_hidden=m, var_window=t),
            gating.GateConfig(d_feature=d, d_hidden=m, var_window=t))


def _params(jcfg, seed=0):
    """Reference parameters with nonzero biases and alpha (every term of
    Eq. 5-6 exercised), and the port's copy."""
    jp = init_params(jgating.gate_specs(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    jp = {k: jnp.asarray(np.asarray(v) + 0.1 * rng.normal(size=v.shape)
                         .astype(np.float32)
                         if k.startswith("b_") or k == "alpha" else v,
                         jnp.float32)
          for k, v in jp.items()}
    return jp, gate_params_from_numpy({k: np.asarray(v)
                                       for k, v in jp.items()}, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_to_scale(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _assert_state(tstate, jstate):
    got = gate_state_to_numpy(tstate)
    for k in ("h", "var_buf"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(jstate, k)),
                                   rtol=0, atol=TOL, err_msg=k)
    np.testing.assert_array_equal(got["var_idx"], np.asarray(jstate.var_idx))


# ---------------------------------------------------------------------------
# the per-stream recurrence
# ---------------------------------------------------------------------------
def test_gate_step_matches_reference():
    """One step from a state mid-ring (the slot wraps), one stream."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(1)
    state = {"h": rng.uniform(-1, 1, 32).astype(np.float32),
             "var_buf": rng.normal(size=(8, D)).astype(np.float32),
             "var_idx": np.asarray(13, np.int32)}
    dx = rng.normal(size=D).astype(np.float32)
    jst = jgating.GateState(**{k: jnp.asarray(v) for k, v in state.items()})
    jnew, (jtau, jg) = jgating.gate_step(jcfg, jp, jst, jnp.asarray(dx))
    tst = gate_state_from_numpy(state, "cpu")
    tnew, (ttau, tg) = gating.gate_step(tcfg, tp, tst, _t(dx))
    assert tuple(ttau.shape) == tuple(tg.shape) == ()
    np.testing.assert_allclose(float(ttau), float(jtau), atol=TOL)
    np.testing.assert_allclose(float(tg), float(jg), atol=TOL)
    _assert_state(tnew, jnew)
    # the old state is not written
    np.testing.assert_array_equal(tst.var_buf.numpy(), state["var_buf"])


@pytest.mark.parametrize("d,m,t", [(35, 32, 8), (8, 16, 4)])
def test_gate_scan_matches_reference_and_chunks(d, m, t):
    """``gate_scan`` over 20 steps against the reference's; scanning in two
    chunks with the carried state equals one scan (the reference's
    streaming-consistency test)."""
    jcfg, tcfg = _cfgs(d, m, t)
    jp, tp = _params(jcfg, seed=2)
    dxs = np.random.default_rng(3).normal(size=(20, d)).astype(np.float32)
    jt, jg, jfin = jgating.gate_scan(jcfg, jp, jnp.asarray(dxs))
    tt, tg, tfin = gating.gate_scan(tcfg, tp, _t(dxs))
    assert tuple(tt.shape) == tuple(tg.shape) == (20,)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL)
    _assert_state(tfin, jfin)
    t1, g1, mid = gating.gate_scan(tcfg, tp, _t(dxs[:10]))
    t2, g2, fin2 = gating.gate_scan(tcfg, tp, _t(dxs[10:]), mid)
    np.testing.assert_allclose(torch.cat([t1, t2]).numpy(), tt.numpy(),
                               atol=1e-6)
    for k in ("h", "var_buf", "var_idx"):
        assert torch.equal(getattr(fin2, k), getattr(tfin, k)), k


def test_gate_scan_batch_matches_reference():
    """B = 6 streams from given states (the reference vmaps ``gate_scan``;
    the port advances the batch together)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    rng = np.random.default_rng(5)
    dxs = rng.normal(size=(6, 11, D)).astype(np.float32)
    states = {"h": rng.uniform(-1, 1, (6, 32)).astype(np.float32),
              "var_buf": rng.normal(size=(6, 8, D)).astype(np.float32),
              "var_idx": np.arange(6, dtype=np.int32) * 3}
    jst = jgating.GateState(**{k: jnp.asarray(v) for k, v in states.items()})
    jt, jg, jfin = jgating.gate_scan_batch(jcfg, jp, jnp.asarray(dxs), jst)
    tt, tg, tfin = gating.gate_scan_batch(
        tcfg, tp, _t(dxs), gate_state_from_numpy(states, "cpu"))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL)
    _assert_state(tfin, jfin)
    # from fresh states
    jt, _, _ = jgating.gate_scan_batch(jcfg, jp, jnp.asarray(dxs))
    tt, _, _ = gating.gate_scan_batch(tcfg, tp, _t(dxs))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=TOL)


# ---------------------------------------------------------------------------
# the cell's VJP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,d,given", [(37, 35, "all"), (8, 35, "dtau"),
                                       (64, 6, "dh_new"), (5, 64, "dg_mean")])
def test_gate_cell_vjp_ref_matches_jax_vjp(b, d, given):
    """The written-out VJP against ``jax.vjp`` of the reference's plain
    cell and against ``torch.autograd`` of the port's plain cell, with all
    three incoming gradients or one (the others None)."""
    jcfg, _ = _cfgs(d)
    jp, tp = _params(jcfg, seed=b)
    rng = np.random.default_rng(b + d)
    dx = rng.normal(size=(b, d)).astype(np.float32)
    h = rng.uniform(-1, 1, (b, 32)).astype(np.float32)
    vol = rng.uniform(0, 2, b).astype(np.float32)
    cts = {"dh_new": rng.normal(size=(b, 32)).astype(np.float32),
           "dtau": rng.normal(size=b).astype(np.float32),
           "dg_mean": rng.normal(size=b).astype(np.float32)}
    if given != "all":
        cts = {k: v if k == given else np.zeros_like(v)
               for k, v in cts.items()}
    _, vjp = jax.vjp(lambda hh, p: j_gate_cell_ref(jnp.asarray(dx), hh,
                                                   jnp.asarray(vol), p),
                     jnp.asarray(h), jp)
    jdh, jgrads = vjp(tuple(jnp.asarray(cts[k])
                            for k in ("dh_new", "dtau", "dg_mean")))
    kw = {k: _t(v) for k, v in cts.items()
          if given == "all" or k == given}
    grads, dh = gate_cell_vjp_ref(_t(dx), _t(h), _t(vol), tp, **kw)
    for k in PARAM_NAMES:
        _close_to_scale(grads[k].numpy(), jgrads[k], what=k)
    _close_to_scale(dh.numpy(), jdh, what="dh")
    # torch.autograd of the port's plain cell
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    hh = _t(h).requires_grad_(True)
    out = gate_cell_ref(_t(dx), hh, _t(vol), leaves)
    sum((o * _t(cts[k])).sum() for o, k in
        zip(out, ("dh_new", "dtau", "dg_mean"))).backward()
    for k in PARAM_NAMES:
        _close_to_scale(grads[k].numpy(), leaves[k].grad.numpy(), what=k)
    _close_to_scale(dh.numpy(), hh.grad.numpy(), what="dh")
    only, none = gate_cell_vjp_ref(_t(dx), _t(h), _t(vol), tp, **kw,
                                   need_dh=False)
    assert none is None
    for k in PARAM_NAMES:
        assert torch.equal(only[k], grads[k]), k


def test_gate_cell_autograd_is_the_plain_cell_on_the_cpu():
    """``GateCellFn`` on CPU tensors: the plain cell's values bit for bit,
    and its backward the written-out VJP."""
    jcfg, _ = _cfgs()
    _, tp = _params(jcfg, seed=9)
    rng = np.random.default_rng(9)
    dx, h = _t(rng.normal(size=(10, D)).astype(np.float32)), \
        _t(rng.uniform(-1, 1, (10, 32)).astype(np.float32))
    vol = _t(rng.uniform(0, 2, 10).astype(np.float32))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    out = gate_cell_autograd(dx, h, vol, leaves)
    for a, b in zip(out, gate_cell_ref(dx, h, vol, tp)):
        assert torch.equal(a.detach(), b)
    out[1].sum().backward()
    want, _ = gate_cell_vjp_ref(dx, h, vol, tp, dtau=torch.ones(10))
    for k in PARAM_NAMES:
        assert torch.equal(leaves[k].grad, want[k]), k


# ---------------------------------------------------------------------------
# gate_loss and the curriculum
# ---------------------------------------------------------------------------
def _batch(rng, b=6, t=10, d=D):
    dxs = rng.normal(size=(b, t, d)).astype(np.float32)
    labels = (np.linalg.norm(dxs, axis=-1) > np.sqrt(d)).astype(np.float32)
    return dxs, labels


@pytest.mark.parametrize("prox", [False, True])
def test_gate_loss_and_gradient_match_reference(prox):
    """``gate_loss`` (BPTT through every step's ``GateCellFn``) and its
    gradient against ``jax.value_and_grad`` of the reference's, without
    and with the proximal term (an anchor away from the parameters)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=11)
    ja, ta = _params(jcfg, seed=12)
    dxs, labels = _batch(np.random.default_rng(13))
    kw = dict(lam1=0.05, lam2=0.01, mu=0.7 if prox else 0.0)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jgating.gate_loss(jcfg, p, jnp.asarray(dxs),
                                    jnp.asarray(labels),
                                    anchor=ja if prox else None, **kw),
        has_aux=True)(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, met = gating.gate_loss(tcfg, leaves, _t(dxs), _t(labels),
                                 anchor=ta if prox else None, **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    for k in ("bce", "l_lat", "l_comp"):
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=TOL)
    for k, g in zip(leaves, grads):
        _close_to_scale(g.numpy(), jgrads[k], what=k)


def test_train_steps_and_online_finetune_match_reference():
    """Three ``_train_step``s from the same parameters and data, then
    ``online_finetune`` (proximal, 0.3 of the rate) over five batches:
    losses 1e-5 relative, parameters 1e-6 absolute."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=21)
    rng = np.random.default_rng(22)
    data = [_batch(rng, b=8, t=12) for _ in range(8)]
    ccfg = dict(lr=5e-2, lam1=0.05, lam2=0.01)
    for dxs, labels in data[:3]:
        jp, jloss, _ = jcur._train_step(jcfg, jp, jnp.asarray(dxs),
                                        jnp.asarray(labels), **ccfg)
        tp, tloss, _ = tcur._train_step(tcfg, tp, _t(dxs), _t(labels),
                                        **ccfg)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    jcc = jcur.CurriculumConfig(online_steps=5, lr=5e-2, mu=0.5)
    tcc = tcur.CurriculumConfig(online_steps=5, lr=5e-2, mu=0.5)
    jtuned, jlosses = jcur.online_finetune(
        jcfg, jp, ((jnp.asarray(a), jnp.asarray(b)) for a, b in data[3:]),
        jcc)
    ttuned, tlosses = tcur.online_finetune(tcfg, tp, iter(data[3:]), tcc)
    assert len(tlosses) == 5
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(ttuned[k].numpy(), np.asarray(jtuned[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_offline_warmup_starts_from_the_generator_and_steps():
    """``offline_warmup``: parameters from ``init_gate_params(generator)``,
    then one ``_train_step`` a batch (the loop the reference runs)."""
    _, tcfg = _cfgs(8, 16, 4)
    rng = np.random.default_rng(31)
    data = [_batch(rng, b=4, t=6, d=8) for _ in range(3)]
    ccfg = tcur.CurriculumConfig(warmup_steps=3, lr=1e-2)
    params, losses = tcur.offline_warmup(
        tcfg, iter(data), ccfg, torch.Generator().manual_seed(5), "cpu")
    want = gating.init_gate_params(tcfg, torch.Generator().manual_seed(5),
                                   "cpu")
    for (dxs, labels), loss in zip(data, losses):
        want, w_loss, _ = tcur._train_step(tcfg, want, _t(dxs), _t(labels),
                                           ccfg.lr, ccfg.lam1, ccfg.lam2)
        assert loss == float(w_loss)
    for k in want:
        assert torch.equal(params[k], want[k]), k


# the reference's curriculum tests (tests/test_gating.py), on the port
GCFG_SMALL = gating.GateConfig(d_feature=8, d_hidden=16, var_window=4)


def test_offline_warmup_reduces_loss():
    rng = np.random.default_rng(0)

    def data():
        while True:
            dxs = rng.normal(0, 1, (8, 12, 8)).astype(np.float32)
            # oracle: cloud benefit correlates with feature magnitude
            labels = (np.linalg.norm(dxs, axis=-1) > 3.2).astype(np.float32)
            yield dxs, labels

    ccfg = tcur.CurriculumConfig(warmup_steps=60, lr=5e-2)
    _, losses = tcur.offline_warmup(GCFG_SMALL, data(), ccfg,
                                    torch.Generator().manual_seed(0), "cpu")
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), \
        "warm-up did not learn"


def test_online_proximal_stays_near_anchor():
    rng = np.random.default_rng(1)

    def data():
        while True:
            dxs = rng.normal(0, 1, (4, 8, 8)).astype(np.float32)
            yield dxs, np.ones((4, 8), np.float32)   # drifted objective

    params = gating.init_gate_params(GCFG_SMALL,
                                     torch.Generator().manual_seed(0), "cpu")
    drift = {}
    for mu in (10.0, 0.0):
        ccfg = tcur.CurriculumConfig(online_steps=40, lr=5e-2, mu=mu)
        tuned, _ = tcur.online_finetune(GCFG_SMALL, params, data(), ccfg)
        drift[mu] = max(float((tuned[k] - params[k]).abs().max())
                        for k in params)
    assert drift[10.0] < drift[0.0], "proximal term did not constrain drift"
