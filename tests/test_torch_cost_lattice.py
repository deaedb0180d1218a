"""Port parity: cost model, decision lattice and pole set (repro_torch vs the
JAX reference, on the CPU).

Tables built by the same numpy or float32 arithmetic are compared exactly.
The accuracy surface goes through ``exp``, where torch and XLA differ by one
ulp on some float32 inputs, so it is compared at 2.5e-7 absolute (the
largest difference measured over a (4096, 50) grid was 1.2e-7).
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import lattice as jlat
from repro.core.robust import _poles as j_poles
from repro_torch.core import cost_model as tcm
from repro_torch.core import lattice as tlat
from repro_torch.core.robust import RobustProblem, _poles

CONFIGS = {
    "paper": (jcm.SystemConfig(), tcm.SystemConfig()),
    "gamma3_bw": (jcm.SystemConfig(gamma=3, total_bw_mbps=250.0, beta=0.1),
                  tcm.SystemConfig(gamma=3, total_bw_mbps=250.0, beta=0.1)),
}
ACC_ATOL = 2.5e-7


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_cost_tables_exact(cfg):
    jsys, tsys = CONFIGS[cfg]
    for j, t in zip(jcm.cost_tables(jsys), tcm.cost_tables(tsys, "cpu")):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert t.dtype == torch.float32


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_lattice_flat_vectors_exact(cfg):
    jsys, tsys = CONFIGS[cfg]
    jl = jlat.DecisionLattice.build(jsys)
    tl = tlat.DecisionLattice.build(tsys, "cpu")
    for name in ("c1", "b2", "bw", "c1_flat", "b2_flat", "bw_flat", "u_dev",
                 "rn_flat", "pn_flat", "tier_flat"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                      np.asarray(getattr(jl, name)),
                                      err_msg=name)
    assert tl.n_flat == jl.n_flat


def test_gflops_table_exact():
    jsys, tsys = CONFIGS["paper"]
    np.testing.assert_array_equal(tlat.gflops_table(tsys),
                                  jlat.gflops_table(jsys))


@pytest.mark.parametrize("k,gamma", [(5, 0), (5, 1), (5, 2), (5, 5), (3, 2)])
def test_poles_exact(k, gamma):
    np.testing.assert_array_equal(_poles(k, gamma).numpy(),
                                  np.asarray(j_poles(k, gamma)))


def test_robust_problem_pole_deviations_exact():
    from repro.core.robust import RobustProblem as JProb
    jp = JProb.build(jcm.SystemConfig())
    tp = RobustProblem.build(tcm.SystemConfig(), "cpu")
    np.testing.assert_array_equal(tp.poles.numpy(), np.asarray(jp.poles))
    np.testing.assert_array_equal(tp.u_all.numpy(),
                                  np.asarray(jp.poles * jp.lat.u_dev))


def test_index_maps_match():
    jl = jlat.DecisionLattice.build(jcm.SystemConfig())
    tl = tlat.DecisionLattice.build(tcm.SystemConfig(), "cpu")
    y = np.arange(jl.n_flat)
    for a, b in zip(jl.unflatten_index(jnp.asarray(y)),
                    tl.unflatten_index(torch.from_numpy(y))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    route, r, p = (b.numpy() for b in tl.unflatten_index(torch.from_numpy(y)))
    np.testing.assert_array_equal(
        tl.flatten_index(torch.from_numpy(route), torch.from_numpy(r),
                         torch.from_numpy(p)).numpy(), y)
    sol = {"route": route, "r": r, "p": p}
    np.testing.assert_array_equal(
        tl.solution_bandwidth({k: torch.from_numpy(v) for k, v in sol.items()}
                              ).numpy(),
        np.asarray(jl.solution_bandwidth({k: jnp.asarray(v)
                                          for k, v in sol.items()})))


@pytest.mark.parametrize("seed", [0, 1])
def test_accuracy_stage1_close(seed):
    jsys, tsys = CONFIGS["paper"]
    z = np.random.default_rng(seed).uniform(0, 1, 4096).astype(np.float32)
    z[:3] = [0.0, 1.0, 0.5]
    got = tcm.accuracy_stage1(tsys, torch.from_numpy(z)).numpy()
    want = np.asarray(jcm.accuracy_stage1(jsys, jnp.asarray(z)))
    assert got.shape == want.shape == (4096, tsys.n_res)
    np.testing.assert_allclose(got, want, rtol=0, atol=ACC_ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_accuracy_at_close(seed):
    jsys, tsys = CONFIGS["paper"]
    rng = np.random.default_rng(seed)
    m = 4096
    z = rng.uniform(0, 1, m).astype(np.float32)
    idx = [rng.integers(0, n, m) for n in (tsys.n_res, tsys.n_fps,
                                            tsys.num_versions, 2)]
    got = tcm.accuracy_at(tsys, torch.from_numpy(z),
                          *[torch.from_numpy(i) for i in idx]).numpy()
    want = np.asarray(jcm.accuracy_at(jsys, jnp.asarray(z),
                                      *[jnp.asarray(i, jnp.int32)
                                        for i in idx]))
    np.testing.assert_allclose(got, want, rtol=0, atol=ACC_ATOL)
    # the formula is float32 end to end
    assert got.dtype == np.float32
