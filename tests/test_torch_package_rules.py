"""Rules of the PyTorch port that hold on any machine: it imports neither JAX
nor the JAX package, imports Triton nowhere at module level, defaults every
entry point to CUDA (raising without a card), and never falls back from a
pinned kernel to the plain version."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.cost_model import SystemConfig, fps_norm, res_norm
from repro_torch.core.gating import GateConfig, init_batch_state, init_gate_params
from repro_torch.core.lattice import DecisionLattice
from repro_torch.core.robust import RobustProblem, solve_ccg_fused
from repro_torch.core.router import init_router_state
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels.c6_tail.ops import c6_tail
from repro_torch.kernels.ccg_encode.ops import ccg_encode
from repro_torch.kernels.ccg_master.ops import ccg_master
from repro_torch.kernels.ccg_solve.ops import ccg_solve
from repro_torch.kernels.lpt_queue.ops import lpt_queue
from repro_torch.kernels.temporal_gate.ops import gate_cell
from repro_torch.serving.policy import Observation, make_policy
from repro_torch.serving.session import ServeSession
from repro_torch.serving.simulator import Simulator, SimConfig

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
GCFG = GateConfig(d_feature=35)


def _imports(tree):
    """(module name, at module level) for every import in a module."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in top


def test_package_imports_no_jax_and_no_reference():
    files = sorted(PKG.rglob("*.py")) + [PKG.parents[1] / "chip_smoke.py"]
    assert len(files) >= 16
    for path in files:
        for name, top in _imports(ast.parse(path.read_text())):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)
            assert not (top and root == "triton"), (path, name)


def test_kernel_sources_present():
    for name in _build.SOURCES:
        src = (_build.CSRC / name).read_text()
        assert "Replaces" in src or "replaces" in src, name
        assert "What bounds it on the H100" in src, name
        assert "cudaGetLastError" in src, name
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    # one accuracy device function, included by every kernel that tests
    # feasibility
    for name in ("ccg_solve.cu", "ccg_encode.cu", "c6_tail.cu"):
        src = (_build.CSRC / name).read_text()
        assert '#include "accuracy.cuh"' in src, name
        assert "expf" not in src, name


def test_editing_a_header_changes_the_library_path(tmp_path, monkeypatch):
    """The built library is named by a hash that covers the headers the
    sources include, so an edited header never loads a stale library."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    assert _build.library_path() == before
    header = csrc / "accuracy.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after_header = _build.library_path()
    assert after_header != before
    (csrc / "new_helper.cuh").write_text("#pragma once\n")
    assert _build.library_path() not in (before, after_header)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


@pytest.mark.parametrize("entry", [
    "make_policy", "lattice", "robust_problem", "router_state", "gate_state",
    "gate_params", "simulator", "baseline_policy"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    _no_cuda()
    calls = {
        "make_policy": lambda: make_policy("r2evid", SystemConfig(),
                                           gate_cfg=GCFG,
                                           generator=torch.Generator()),
        "lattice": lambda: DecisionLattice.build(SystemConfig()),
        "robust_problem": lambda: RobustProblem.build(SystemConfig()),
        "router_state": lambda: init_router_state(GCFG, 4),
        "gate_state": lambda: init_batch_state(GCFG, 4),
        "gate_params": lambda: init_gate_params(GCFG, torch.Generator()),
        "simulator": lambda: Simulator(SystemConfig(), SimConfig()),
        "baseline_policy": lambda: make_policy("sniper", SystemConfig()),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_session_defaults_to_cuda_and_raises_without_it():
    _no_cuda()
    pol = make_policy("r2evid", SystemConfig(), device="cpu", gate_cfg=GCFG,
                      generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeSession(pol, n_streams=4)
    ServeSession(pol, n_streams=4, device="cpu")


def _kernel_calls():
    lat = DecisionLattice.build(SystemConfig(), "cpu")
    prob = RobustProblem.build(SystemConfig(), "cpu")
    m = 4
    i32 = torch.zeros(m, dtype=torch.int32)
    f32 = torch.full((m,), 0.5)
    gp = init_gate_params(GCFG, torch.Generator().manual_seed(0), "cpu")
    panel = torch.movedim(lat.bw, -1, 0)[i32.long()].reshape(m, -1)
    return {
        "gate_cell": lambda f: gate_cell(torch.zeros(m, 35),
                                         torch.zeros(m, 32), f32, gp,
                                         force=f),
        "ccg_solve": lambda f: ccg_solve(
            f32, f32, lat.rn_flat, lat.pn_flat, lat.tier_flat, lat.b2_flat,
            prob.u_all, lat.c1_flat, i32 - 1, margin=0.02, num_versions=5,
            force=f),
        "c6_tail": lambda f: c6_tail(panel, i32, i32, i32, i32, f32, f32,
                                     res_norm(SystemConfig(), "cpu"),
                                     fps_norm(SystemConfig(), "cpu"),
                                     n_fps=5, force=f),
        "lpt_queue": lambda f: lpt_queue(f32, i32, 4, 1, force=f),
        "ccg_encode": lambda f: ccg_encode(
            f32, f32, lat.rn_flat, lat.pn_flat, lat.tier_flat,
            prob.b2_scaled, prob.rec_table, margin=0.02, num_versions=5,
            force=f),
        "ccg_master": lambda f: ccg_master(
            torch.zeros(m, 16, 50), torch.zeros(m, 16),
            torch.ones(m, 50, dtype=torch.bool), lat.c1_flat, force=f),
    }


@pytest.mark.parametrize("name", ["gate_cell", "ccg_solve", "c6_tail",
                                  "lpt_queue", "ccg_encode", "ccg_master"])
def test_force_kernel_on_cpu_tensor_raises(name):
    call = _kernel_calls()[name]
    reset_launch_counts()
    with pytest.raises(ValueError, match="force='kernel'"):
        call("kernel")
    with pytest.raises(ValueError, match="force must be"):
        call("pallas")
    # the plain version runs for "auto" and "ref" on the CPU, uncounted
    call("auto")
    call("ref")
    assert launch_counts() == {}


def test_unported_branches_raise():
    """Only the branches still to port raise, naming their ROADMAP item:
    tier outages in serving and in the fused solve (A.9) and the mesh
    (A.15).  Every registered policy builds, including R2E-VID's τ-proxy
    mode and its ablations."""
    prob = RobustProblem.build(SystemConfig(), "cpu")
    z = torch.full((3,), 0.5)
    with pytest.raises(NotImplementedError, match="A.9"):
        solve_ccg_fused(prob, z, z, tier_ok=torch.ones(2))
    for name in ("jcab", "A2", "sniper", "rdap", "r2evid"):
        make_policy(name, SystemConfig(), device="cpu")
    for kw in ({"use_stage1": False}, {"use_stage2": False}):
        make_policy("r2evid", SystemConfig(), device="cpu", **kw)
    with pytest.raises(KeyError):
        make_policy("nope", SystemConfig(), device="cpu")
    pol = make_policy("r2evid", SystemConfig(), device="cpu", gate_cfg=GCFG,
                      generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="A.15"):
        ServeSession(pol, n_streams=3, device="cpu", mesh=object())
    obs = Observation(z=z, aq=z, dx=torch.zeros(3, 35), bw_mult=torch.ones(2),
                      u=torch.zeros(5), tier_ok=torch.ones(2))
    for p in (pol, make_policy("sniper", SystemConfig(), device="cpu")):
        sess = ServeSession(p, n_streams=3, device="cpu")
        with pytest.raises(NotImplementedError, match="A.9"):
            sess.step(obs)


def test_pad_rows_appends_neutral_lanes():
    t = torch.arange(6, dtype=torch.int32)
    assert _build.pad_rows(t, 0) is t
    np.testing.assert_array_equal(_build.pad_rows(t, 2, value=-1).numpy(),
                                  [0, 1, 2, 3, 4, 5, -1, -1])
