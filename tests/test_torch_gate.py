"""Port parity: the fused gating cell and the batched streaming gate
(repro_torch plain versions vs the JAX reference, on the CPU).

Tolerance 1e-5 absolute: the four GEMMs sum in torch's order, not XLA's,
and the sigmoid/tanh implementations differ in the last ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_kernel_orders import gate_cell_pr11, gate_cell_tiled

from repro.core import gating as jgate
from repro.kernels.temporal_gate.ops import gate_cell as j_gate_cell
from repro.models.params import init_params
from repro_torch.convert import gate_params_from_numpy, gate_params_to_numpy
from repro_torch.core import gating as tgate
from repro_torch.kernels.temporal_gate.ops import gate_cell

ATOL = 1e-5
D = 35


def _params(seed=0, cfg=None):
    cfg = cfg or jgate.GateConfig(d_feature=D)
    jp = init_params(jgate.gate_specs(cfg), jax.random.PRNGKey(seed))
    # non-zero biases and alpha so every term of Eq. 5-6 is exercised
    rng = np.random.default_rng(seed + 100)
    jp = {k: (v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
              if k.startswith("b_") or k == "alpha" else v)
          for k, v in jp.items()}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in jp.items()}
    return jp, gate_params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                      "cpu")


@pytest.mark.parametrize("jforce", ["ref", "pallas"])
@pytest.mark.parametrize("b", [37, 8])
def test_gate_cell_matches_reference(jforce, b):
    jp, tp = _params()
    rng = np.random.default_rng(b)
    dx = rng.normal(size=(b, D)).astype(np.float32)
    h = rng.uniform(-1, 1, (b, 32)).astype(np.float32)
    vol = rng.uniform(0, 2, b).astype(np.float32)
    want = j_gate_cell(jnp.asarray(dx), jnp.asarray(h), jnp.asarray(vol), jp,
                       block_b=16, force=jforce)
    got = gate_cell(torch.from_numpy(dx), torch.from_numpy(h),
                    torch.from_numpy(vol), tp)
    for name, g, w in zip(("h_new", "tau", "g_mean"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("b,d", [(8, 35), (37, 35), (70, 1), (33, 64),
                                 (40, 6)])
def test_gate_kernel_tiling_keeps_the_first_designs_order(b, d):
    """The persistent kernel's order (tiles of 32 streams, 2 a warp, the
    dx row in groups of four and the rest) gives the bits of the first
    design's order (one warp a stream, k ascending), and both are within
    1e-5 of the plain version and of the live JAX cell (Pallas in
    interpret mode); ragged B and d from 1 to 64."""
    cfg = jgate.GateConfig(d_feature=d)
    jp, tp = _params(3, cfg)
    rng = np.random.default_rng(b + d)
    dx = rng.normal(size=(b, d)).astype(np.float32)
    h = rng.uniform(-1, 1, (b, 32)).astype(np.float32)
    vol = rng.uniform(0, 2, b).astype(np.float32)
    args = (torch.from_numpy(dx), torch.from_numpy(h), torch.from_numpy(vol),
            tp)
    tiled = gate_cell_tiled(*args)
    first = gate_cell_pr11(*args)
    plain = gate_cell(*args, force="ref")
    want = j_gate_cell(jnp.asarray(dx), jnp.asarray(h), jnp.asarray(vol), jp,
                       block_b=16, force="pallas")
    for name, t, f, pl, w in zip(("h_new", "tau", "g_mean"), tiled, first,
                                 plain, want):
        assert t.shape == pl.shape, name
        assert torch.equal(t, f), name
        torch.testing.assert_close(t, pl, rtol=0, atol=ATOL)
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("resync", [0, 1])
def test_gate_step_batch_matches_reference(resync):
    """2·T+3 steps of the streaming gate cross the resync step (once per
    window at resync_period 0, every step at 1): state and τ within 1e-5."""
    jcfg = jgate.GateConfig(d_feature=D, resync_period=resync)
    tcfg = tgate.GateConfig(d_feature=D, resync_period=resync)
    jp, tp = _params(1, jcfg)
    m = 13
    n_steps = 2 * jcfg.var_window + 3
    dxs = np.random.default_rng(7).normal(size=(n_steps, m, D)).astype(
        np.float32)
    js = jgate.init_batch_state(jcfg, m)
    ts = tgate.init_batch_state(tcfg, m, "cpu")
    for i in range(n_steps):
        js, (jtau, jg) = jgate.gate_step_batch(jcfg, jp, js,
                                               jnp.asarray(dxs[i]),
                                               force="ref")
        ts, (ttau, tg) = tgate.gate_step_batch(tcfg, tp, ts,
                                               torch.from_numpy(dxs[i]))
        np.testing.assert_allclose(ttau.numpy(), np.asarray(jtau), rtol=0,
                                   atol=ATOL, err_msg=f"tau step {i}")
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                                   atol=ATOL, err_msg=f"g_mean step {i}")
    for f in ("h", "var_buf", "var_sum", "var_sumsq"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(ts.var_idx.numpy(), np.asarray(js.var_idx))
    # the ring buffer holds exactly the last T inputs (no arithmetic)
    np.testing.assert_array_equal(ts.var_buf.numpy(), np.asarray(js.var_buf))


def test_gate_specs_match_reference():
    cfg = jgate.GateConfig(d_feature=D)
    jspecs = jgate.gate_specs(cfg)
    tspecs = tgate.gate_specs(tgate.GateConfig(d_feature=D))
    assert list(tspecs) == list(jspecs)
    for k, (shape, init, std) in tspecs.items():
        assert shape == jspecs[k].shape, k
        assert init == jspecs[k].init, k
        if init == "normal":
            assert std == jspecs[k].stddev, k
    assert tgate.feature_dim() == D
    from repro.core.features import feature_dim
    assert feature_dim() == D


def test_init_gate_params_seeded():
    cfg = tgate.GateConfig(d_feature=D)
    a = tgate.init_gate_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tgate.init_gate_params(cfg, torch.Generator().manual_seed(3), "cpu")
    c = tgate.init_gate_params(cfg, torch.Generator().manual_seed(4), "cpu")
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        assert a[k].dtype == torch.float32
    assert not torch.equal(a["w_g"], c["w_g"])
    assert float(a["alpha"]) == 1.0 and not a["b_g"].any()
    # stddev d^-0.5 on the dx projections
    assert abs(float(a["w_g"].std()) - D ** -0.5) < 0.05


def test_gate_params_round_trip():
    jp, tp = _params(2)
    back = gate_params_to_numpy(tp)
    assert set(back) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(back[k], np.asarray(jp[k]))


def test_gate_config_fields_match_reference():
    names = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]
    assert names(tgate.GateConfig) == names(jgate.GateConfig)
