"""Rules of the PyTorch port that hold on any machine: it imports neither JAX
nor the JAX package, imports Triton nowhere at module level, defaults every
entry point to CUDA (raising without a card), and never falls back from a
pinned kernel to the plain version."""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.cost_model import SystemConfig, fps_norm, res_norm
from repro_torch.core.curriculum import CurriculumConfig, offline_warmup
from repro_torch.core.gating import (
    GateConfig,
    init_batch_state,
    init_gate_params,
    init_state,
)
from repro_torch.core.lattice import DecisionLattice
from repro_torch.core.robust import RobustProblem, solve_ccg_fused
from repro_torch.core.router import init_router_state
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels.c6_tail.ops import c6_repair, c6_tail
from repro_torch.kernels.ccg_encode.ops import ccg_encode
from repro_torch.kernels.ccg_master.ops import ccg_master
from repro_torch.kernels.ccg_solve.ops import ccg_solve
from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    decode_attention_partial,
)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.lpt_queue.ops import lpt_queue
from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.temporal_gate.ops import gate_cell, gate_cell_vjp
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import host_mesh, run_ranks, single_rank_group
from repro_torch.models.config import MoEConfig, RGLRUConfig, SSMConfig
from repro_torch.models.model import model_specs
from repro_torch.models.params import init_params
from repro_torch.serving.policy import Observation, make_policy
from repro_torch.serving.pools import ModelPool, make_tier_pools
from repro_torch.serving.session import FinetuneConfig, ServeSession
from repro_torch.serving.simulator import Simulator, SimConfig
from repro_torch.train.trainer import TrainConfig, Trainer

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
    # the stream-sharding modules are held to the rule like the rest
    for mod in ("sharding/compat.py", "sharding/collectives.py",
                "sharding/audit.py", "runtime/cluster.py", "launch/mesh.py",
                "sharding/rules.py", "sharding/pipeline.py"):
        assert PKG / mod in files, mod
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
    # one set of tensor-core helpers, included by the forward and backward
    # attention kernels
    for name in ("flash_attention.cu", "flash_attention_bwd.cu"):
        src = (_build.CSRC / name).read_text()
        assert '#include "mma_bf16.cuh"' in src, name
        assert "mma.sync.aligned" not in src, name   # no copy of its asm


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
    header = csrc / "mma_bf16.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert _build.library_path() not in (before, after_header)
    after_header = _build.library_path()
    (csrc / "new_helper.cuh").write_text("#pragma once\n")
    assert _build.library_path() not in (before, after_header)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


@pytest.mark.parametrize("entry", [
    "make_policy", "lattice", "robust_problem", "router_state", "gate_state",
    "gate_params", "simulator", "baseline_policy", "model_pool",
    "tier_pools", "model_params", "gate_stream_state", "offline_warmup",
    "serve_launcher", "nccl_ranks", "trainer", "train_launcher"])
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
        "model_pool": lambda: ModelPool(get_smoke_config("qwen3-8b")),
        "tier_pools": lambda: make_tier_pools(
            get_smoke_config("qwen1.5-0.5b"), get_smoke_config("qwen3-8b")),
        "model_params": lambda: init_params(
            model_specs(get_smoke_config("qwen3-8b")), torch.Generator()),
        "gate_stream_state": lambda: init_state(GCFG, 4),
        "offline_warmup": lambda: offline_warmup(
            GCFG, iter([]), CurriculumConfig(), torch.Generator()),
        "serve_launcher": lambda: serve.main(["--rounds", "1"]),
        "nccl_ranks": lambda: run_ranks(print, 2, backend="nccl"),
        "trainer": lambda: Trainer(get_smoke_config("qwen1.5-0.5b"),
                                   TrainConfig()),
        "train_launcher": lambda: train_launcher.main(["--smoke",
                                                       "--steps", "1"]),
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
        "c6_repair": lambda f: c6_repair(panel, i32, i32, i32, i32, f32, f32,
                                         res_norm(SystemConfig(), "cpu"),
                                         fps_norm(SystemConfig(), "cpu"),
                                         600.0, n_fps=5, rounds=2, force=f),
        "gate_cell_bwd": lambda f: gate_cell_vjp(
            torch.zeros(m, 35), torch.zeros(m, 32), f32, gp, dtau=f32,
            force=f),
        "lpt_queue": lambda f: lpt_queue(f32, i32, 4, 1, force=f),
        "ccg_encode": lambda f: ccg_encode(
            f32, f32, lat.rn_flat, lat.pn_flat, lat.tier_flat,
            prob.b2_scaled, prob.rec_table, margin=0.02, num_versions=5,
            force=f),
        "ccg_master": lambda f: ccg_master(
            torch.zeros(m, 16, 50), torch.zeros(m, 16),
            torch.ones(m, 50, dtype=torch.bool), lat.c1_flat, force=f),
        "decode_attention": lambda f: decode_attention(
            torch.zeros(m, 8, 64), torch.zeros(m, 2, 20, 64),
            torch.zeros(m, 2, 20, 64), torch.full((m,), 3), force=f),
        "decode_attention_partial": lambda f: decode_attention_partial(
            torch.zeros(m, 8, 64), torch.zeros(m, 2, 20, 64),
            torch.zeros(m, 2, 20, 64), torch.full((m,), 3), force=f),
        "flash_attention": lambda f: flash_attention(
            torch.zeros(1, 8, 12, 64), torch.zeros(1, 2, 12, 64),
            torch.zeros(1, 2, 12, 64), force=f),
        "flash_attention_bwd": lambda f: flash_attention_bwd(
            torch.zeros(1, 8, 12, 64), torch.zeros(1, 2, 12, 64),
            torch.zeros(1, 2, 12, 64), torch.zeros(1, 8, 12, 64),
            torch.ones(1, 8, 12, 64), force=f),
        "mamba_scan": lambda f: selective_scan(
            torch.zeros(2, 3, 16), torch.zeros(2, 3, 16),
            torch.zeros(2, 3, 4), torch.zeros(2, 3, 4), -torch.ones(16, 4),
            torch.ones(16), torch.zeros(2, 16, 4), force=f),
        "rglru_scan": lambda f: rglru_scan(
            torch.zeros(2, 3, 16), torch.full((2, 3, 16), 0.5),
            torch.full((2, 3, 16), 0.5), -torch.ones(16), force=f),
    }


@pytest.mark.parametrize("name", ["gate_cell", "gate_cell_bwd",
                                  "ccg_solve", "c6_tail",
                                  "c6_repair", "lpt_queue", "ccg_encode",
                                  "ccg_master", "decode_attention",
                                  "decode_attention_partial",
                                  "flash_attention",
                                  "flash_attention_bwd",
                                  "mamba_scan", "rglru_scan"])
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


def _launching_wrappers():
    """{(module, function): source} of every function of the kernel
    wrappers' modules that launches a kernel (counts a launch)."""
    out = {}
    for path in sorted((PKG / "kernels").glob("*/ops.py")):
        src = path.read_text()
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.FunctionDef):
                body = ast.get_source_segment(src, node)
                if "_build.LAUNCHES[" in body:
                    out[(path.parent.name, node.name)] = body
    return out


def test_kernel_wrappers_without_a_backward_refuse_grad():
    """A kernel's output carries no gradient, so every wrapper that
    launches one refuses operands that need a gradient
    (``_build.refuse_grad``), except the kernels that autograd reaches
    through their own ``torch.autograd.Function`` (``GateCellFn``,
    ``FlashAttentionFn``, ``SelectiveScanFn``, ``RGLRUScanFn``: their
    backward is a kernel too) and those backward kernels.  The forward
    wrappers of the last three refuse, as their functions call them with
    grad disabled.  The refusal raises only where grad is enabled and an
    operand requires it."""
    wrappers = _launching_wrappers()
    assert len(wrappers) >= 13
    free = {name for name, body in wrappers.items()
            if "_build.refuse_grad(" not in body}
    assert free == {("temporal_gate", "gate_cell"),
                    ("temporal_gate", "gate_cell_vjp"),
                    ("flash_attention", "flash_attention_bwd"),
                    ("mamba_scan", "selective_scan_bwd"),
                    ("rglru", "rglru_scan_bwd")}
    for forward in (("flash_attention", "flash_attention"),
                    ("mamba_scan", "selective_scan"),
                    ("rglru", "rglru_scan")):
        assert forward in wrappers and forward not in free
    for mod, fn in (("temporal_gate", "GateCellFn"),
                    ("flash_attention", "FlashAttentionFn"),
                    ("mamba_scan", "SelectiveScanFn"),
                    ("rglru", "RGLRUScanFn")):
        assert f"class {fn}(torch.autograd.Function)" in (
            PKG / "kernels" / mod / "ops.py").read_text()
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        _build.refuse_grad("k", torch.zeros(2), x, None, 1.0)
    with torch.no_grad():
        _build.refuse_grad("k", x)
    _build.refuse_grad("k", x.detach(), None, 2.0)


def test_unported_branches_raise():
    """No branch of the serving path is left to port: a session on a mesh
    (A.15, ported) serves a round, and a mesh that is not a
    ``DeviceMesh`` raises ``TypeError``.  Model pools of configs with MoE blocks or M-RoPE
    serve (A.14 is ported); a config whose front end feeds embeddings has
    no token table, so its pool raises, as the reference's cannot serve it
    either.  Online finetuning (A.11) runs: a
    session with a ``FinetuneConfig`` serves a round.  Tier outages, ported
    with the scenarios (A.9), run: the fused solve and a session's step
    with ``tier_ok`` return solutions off the dead tier.
    Every registered policy builds, including R2E-VID's τ-proxy mode and
    its ablations, a session takes live tier pools, and pools with SSM or
    RG-LRU blocks (a dense config given either mixer, and the Falcon-Mamba
    and RecurrentGemma configs) build."""
    prob = RobustProblem.build(SystemConfig(), "cpu")
    z = torch.full((3,), 0.5)
    sol = solve_ccg_fused(prob, z, z, tier_ok=torch.tensor([0.0, 1.0]))
    assert sol["route"].tolist() == [1, 1, 1]
    for name in ("jcab", "A2", "sniper", "rdap", "r2evid"):
        make_policy(name, SystemConfig(), device="cpu")
    for kw in ({"use_stage1": False}, {"use_stage2": False}):
        make_policy("r2evid", SystemConfig(), device="cpu", **kw)
    with pytest.raises(KeyError):
        make_policy("nope", SystemConfig(), device="cpu")
    pol = make_policy("r2evid", SystemConfig(), device="cpu", gate_cfg=GCFG,
                      generator=torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServeSession(pol, n_streams=3, device="cpu", mesh=object())
    with single_rank_group("gloo"):
        sharded = ServeSession(pol, n_streams=3, device="cpu",
                               mesh=host_mesh())
        mesh_round = sharded.run(Observation(
            z=z[None], aq=z[None], dx=torch.zeros(1, 3, 35),
            bw_mult=torch.ones(1, 2), u=torch.zeros(1, 5)))
    assert mesh_round["route"].shape == (1, 3)
    assert bool(torch.isfinite(mesh_round["cost"]).all())
    # online finetuning (A.11) is ported: a session builds and serves a
    # round, and its first round (before any update) is the plain round
    ft = ServeSession(pol, n_streams=3, device="cpu",
                      finetune=FinetuneConfig())
    stream = Observation(z=z[None], aq=z[None], dx=torch.zeros(1, 3, 35),
                         bw_mult=torch.ones(1, 2), u=torch.zeros(1, 5))
    out = ft.run(stream)
    assert int(ft._rounds_done) == 1
    plain = ServeSession(pol, n_streams=3, device="cpu").run(stream)
    for k in plain:
        assert torch.equal(out[k], plain[k]), k
    obs = Observation(z=z, aq=z, dx=torch.zeros(3, 35), bw_mult=torch.ones(2),
                      u=torch.zeros(5), tier_ok=torch.tensor([0.0, 1.0]))
    for p in (pol, make_policy("sniper", SystemConfig(), device="cpu")):
        out = ServeSession(p, n_streams=3, device="cpu").step(obs)
        assert out["route"].tolist() == [1, 1, 1]
        assert bool(torch.isfinite(out["cost"]).all())
    dense = get_smoke_config("qwen1.5-0.5b")
    with pytest.raises(ValueError, match="embeddings"):
        ModelPool(dataclasses.replace(dense, embed_inputs=False),
                  device="cpu")
    for arch in ("mixtral-8x22b", "moonshot-v1-16b-a3b", "qwen2-vl-2b",
                 "musicgen-medium"):
        assert get_config(arch).name == arch
    ported = {
        "moe": dataclasses.replace(dense, family="moe", moe=MoEConfig(
            num_experts=4, top_k=2, d_expert=32)),
        "mrope": dataclasses.replace(dense, mrope=True,
                                     mrope_sections=(2, 3, 3)),
        "moonshot-v1-16b-a3b": get_smoke_config("moonshot-v1-16b-a3b"),
        "mixtral-8x22b": get_smoke_config("mixtral-8x22b"),
        "ssm": dataclasses.replace(dense, family="ssm",
                                   layer_pattern=("ssm",), ssm=SSMConfig()),
        "rglru": dataclasses.replace(dense, layer_pattern=("rglru", "attn"),
                                     rglru=RGLRUConfig()),
        "falcon-mamba-7b": get_smoke_config("falcon-mamba-7b"),
        "recurrentgemma-9b": get_smoke_config("recurrentgemma-9b"),
    }
    for cfg in ported.values():
        pool = ModelPool(cfg, device="cpu")
        ids = pool.serve_segment(torch.zeros((1, 4), dtype=torch.long), 2)
        assert ids.shape == (1, 2)
    ServeSession(pol, n_streams=3, device="cpu",
                 pools={0: ModelPool(dense, device="cpu")})


def test_pad_rows_appends_neutral_lanes():
    t = torch.arange(6, dtype=torch.int32)
    assert _build.pad_rows(t, 0) is t
    np.testing.assert_array_equal(_build.pad_rows(t, 2, value=-1).numpy(),
                                  [0, 1, 2, 3, 4, 5, -1, -1])
