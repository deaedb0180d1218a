"""Port parity: the CCG master step (repro_torch plain version vs the JAX
``ccg_master`` ref and Pallas interpret kernel, on the CPU).

The master is max / add / select / argmin on given float32 slabs, with no
transcendental in it, so ``y_star`` and ``o_down`` must be exactly equal on
every lane.  The slabs are drawn from a coarse grid so that the η maxima
and the objectives tie often; some tasks have no scenario yet (η = 0), some
have every option infeasible (y* = 0, o_down = BIG), and padded-looking
options (BIG recourse) sit beside real ones.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.robust import BIG as J_BIG
from repro.kernels.ccg_master.ops import ccg_master as j_ccg_master
from repro_torch.core.lattice import BIG
from repro_torch.kernels.ccg_master.ops import ccg_master


def test_shared_sentinel():
    assert BIG == J_BIG


def _slab(m, p, f, seed):
    rng = np.random.default_rng(seed)
    rec = (rng.integers(0, 6, (m, p, f)) * 0.125).astype(np.float32)
    rec[rng.uniform(size=(m, p, f)) < 0.05] = BIG     # no version fits
    scen = (rng.uniform(size=(m, p)) < 0.3).astype(np.float32)
    scen[::5] = 0.0                                   # empty scenario sets
    scen[1::7] = 1.0                                  # every pole generated
    fs_ok = rng.uniform(size=(m, f)) < 0.7
    fs_ok[2::6] = False                               # all-infeasible rows
    fs_ok[3::6] = True
    c1 = (rng.integers(0, 4, f) * 0.25).astype(np.float32)
    c1[f // 2:] = c1[: f - f // 2]                    # tied option costs
    return rec, scen, fs_ok, c1


@pytest.mark.parametrize("jforce", ["ref", "pallas"])
@pytest.mark.parametrize("shape", [(37, 16, 50), (130, 16, 50), (9, 3, 7),
                                   (20, 1, 50)])
def test_ccg_master_matches_reference(shape, jforce):
    m, p, f = shape
    rec, scen, fs_ok, c1 = _slab(m, p, f, seed=m * p + f)
    y_w, od_w = j_ccg_master(jnp.asarray(rec), jnp.asarray(scen),
                             jnp.asarray(fs_ok), jnp.asarray(c1),
                             block_m=32, force=jforce)
    y, od = ccg_master(torch.from_numpy(rec), torch.from_numpy(scen),
                       torch.from_numpy(fs_ok), torch.from_numpy(c1))
    assert y.dtype == torch.int32 and od.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_w))
    np.testing.assert_array_equal(od.numpy(), np.asarray(od_w))
    none = ~fs_ok.any(axis=1)
    assert none.any() and (y.numpy()[none] == 0).all()
    assert (od.numpy()[none] == np.float32(BIG)).all()


@pytest.mark.parametrize("jforce", ["ref", "pallas"])
@pytest.mark.parametrize("shape", [(37, 4, 50), (21, 33, 130), (9, 64, 70),
                                   (13, 16, 1)])
def test_ccg_master_matches_reference_where_the_kernel_branches(shape,
                                                                jforce):
    """The shapes at which the CUDA kernel takes another branch: P = 4 (the
    K = 3, Γ = 1 pole set), P > 32 (a second mask entry a lane), F > 64
    (more than one 64-option chunk) and F = 1 (one live lane)."""
    m, p, f = shape
    rec, scen, fs_ok, c1 = _slab(m, p, f, seed=3 * m + p + f)
    y_w, od_w = j_ccg_master(jnp.asarray(rec), jnp.asarray(scen),
                             jnp.asarray(fs_ok), jnp.asarray(c1),
                             block_m=32, force=jforce)
    y, od = ccg_master(torch.from_numpy(rec), torch.from_numpy(scen),
                       torch.from_numpy(fs_ok), torch.from_numpy(c1))
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_w))
    np.testing.assert_array_equal(od.numpy(), np.asarray(od_w))


def test_ccg_master_empty_scenarios_is_first_stage_argmin():
    """With no scenario generated η = 0: the master is argmin c1 over the
    feasible options, first index on ties."""
    rec, _, fs_ok, c1 = _slab(12, 16, 50, seed=3)
    fs_ok[:] = True
    y, od = ccg_master(torch.from_numpy(rec), torch.zeros(12, 16),
                       torch.from_numpy(fs_ok), torch.from_numpy(c1))
    assert (y.numpy() == int(np.argmin(c1))).all()
    assert (od.numpy() == c1.min()).all()
