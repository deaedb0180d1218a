"""The kernel bounds that ``chip_smoke.py`` reports, checked on the CPU.

A bound is the least time the H100 could take for a kernel's work: the
larger of its bytes over the memory rate and its compute.  Compute is its
float32 operations over the CUDA cores' rate, unless its exponentials and
square roots would keep the special function units (16 a clock per SM)
busy longer; then part of them moves onto the CUDA cores as polynomials,
and the compute ends when both pipes are done.  The scans are sized here at
Falcon-Mamba-7B's and RecurrentGemma-9B's decode step (16 slots) and longest
prefill (8 × 80 tokens) on meta tensors, so nothing is allocated.
``chip_smoke.py`` is loaded by its path: the tests do not put the
repository root on ``sys.path``.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

DI, N, DT_RANK = 8192, 16, 256    # Falcon-Mamba-7B's mixer
LRU_WIDTH = 4096                  # RecurrentGemma-9B's RG-LRU


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _mamba_args(b, s, with_h0):
    """x and the x_proj output in bf16 (B and C its column slices), dt, A,
    D and h0 float32, as the model passes them."""
    proj = _meta((b, s, DT_RANK + 2 * N), torch.bfloat16)
    return (_meta((b, s, DI), torch.bfloat16), _meta((b, s, DI)),
            proj[..., DT_RANK:DT_RANK + N], proj[..., DT_RANK + N:],
            _meta((DI, N)), _meta((DI,)),
            _meta((b, DI, N)) if with_h0 else None)


def _rglru_args(b, s, with_h0):
    return (_meta((b, s, LRU_WIDTH), torch.bfloat16),
            _meta((b, s, LRU_WIDTH)), _meta((b, s, LRU_WIDTH)),
            _meta((LRU_WIDTH,)), _meta((b, LRU_WIDTH)) if with_h0 else None)


def test_sfu_rate_is_sixteen_a_clock_per_sm(smoke):
    assert smoke.SFU_OP_PER_S == pytest.approx(132 * 16 * 1.98e9)
    assert smoke.FP32_FLOP_PER_S == pytest.approx(132 * 128 * 2 * 1.98e9,
                                                  rel=2e-3)


def _split_ms(smoke, flops, sfu):
    """Compute time with ``sfu`` ops split between the SFUs and the cores,
    solved apart from ``compute_ms``: the SFUs' share ``sfu - x`` and the
    cores' ``flops + c·x`` take the same time."""
    c, r_s, r_f = smoke.SFU_POLY_FLOPS, smoke.SFU_OP_PER_S, smoke.FP32_FLOP_PER_S
    x = (sfu * r_f - flops * r_s) / (r_f + c * r_s)
    assert 0 <= x <= sfu
    assert (sfu - x) / r_s == pytest.approx((flops + c * x) / r_f)
    return (sfu - x) / r_s * 1e3


@pytest.mark.parametrize("term", ["bytes", "operations", "sfu"])
def test_bound_names_its_largest_term(smoke, term):
    """Each term alone at 2 ms, the others at 1 ms: the bound names that
    term; bytes and operations take their own time, the SFU term less than
    its 2 ms, since part of its work moves onto the cores."""
    rate = {"bytes": smoke.HBM_BYTES_PER_S, "operations":
            smoke.FP32_FLOP_PER_S, "sfu": smoke.SFU_OP_PER_S}
    work = {k: r * (2e-3 if k == term else 1e-3) for k, r in rate.items()}
    t, by = smoke.bound(work["bytes"], work["operations"],
                        sfu_ops=work["sfu"])
    assert by == term
    if term == "sfu":
        assert t == pytest.approx(_split_ms(smoke, work["operations"],
                                            work["sfu"]))
        assert 1.0 < t < 2.0
    else:
        assert t == pytest.approx(2.0)


def test_sfu_ops_below_the_cores_time_add_nothing(smoke):
    """When the cores take longer than the SFUs would, the SFU work runs
    beside them and the compute is the operations' time."""
    flops = smoke.FP32_FLOP_PER_S * 1e-3
    t, by = smoke.compute_ms(flops, sfu_ops=smoke.SFU_OP_PER_S * 0.9e-3)
    assert (t, by) == (pytest.approx(1.0), "operations")


def test_mamba_prefill_counts_one_exponential_per_state_and_step(smoke):
    b, s = 8, 80
    nbytes, flops, sfu = smoke.scan_work("mamba_scan",
                                         _mamba_args(b, s, False))
    assert sfu == 8 * 80 * 8192 * 16
    assert flops == b * s * DI * (7 * N + 2)
    # x bf16, dt float32, B and C bf16, A and D, h_final, y float32
    assert nbytes == (2 * b * s * DI + 4 * b * s * DI + 2 * 2 * b * s * N
                      + 4 * (DI * N + DI) + 4 * b * DI * N + 4 * b * s * DI)


@pytest.mark.parametrize("name,b,s,with_h0,term", [
    ("mamba_scan", 16, 1, True, "bytes"),     # decode: the state's bytes
    ("mamba_scan", 8, 80, False, "bytes"),    # prefill: exps split, below
    ("rglru_scan", 16, 1, True, "bytes"),
    ("rglru_scan", 8, 80, False, "bytes"),
])
def test_scan_bound_term(smoke, name, b, s, with_h0, term):
    make = _mamba_args if name == "mamba_scan" else _rglru_args
    nbytes, flops, sfu = smoke.scan_work(name, make(b, s, with_h0))
    t, by = smoke.bound(nbytes, flops, sfu_ops=sfu)
    assert by == term
    t_cmp, _ = smoke.compute_ms(flops, sfu_ops=sfu)
    assert t == pytest.approx(max(nbytes / smoke.HBM_BYTES_PER_S * 1e3,
                                  t_cmp))


def test_mamba_prefill_bound_is_its_bytes(smoke):
    """83.9 M exponentials take the SFUs ~20 µs alone, above the ~17 µs
    that its 57 MB take at 3.35 TB/s; split with polynomials on the cores
    beside its 598 M other operations, the compute is ~12.6 µs, so the
    bound is the bytes."""
    nbytes, flops, sfu = smoke.scan_work("mamba_scan",
                                         _mamba_args(8, 80, False))
    assert 0.0195 < sfu / smoke.SFU_OP_PER_S * 1e3 < 0.0205
    t_cmp, by = smoke.compute_ms(flops, sfu_ops=sfu)
    assert by == "sfu"
    assert t_cmp == pytest.approx(_split_ms(smoke, flops, sfu))
    assert 0.0120 < t_cmp < 0.0132
    t, by = smoke.bound(nbytes, flops, sfu_ops=sfu)
    assert by == "bytes"
    assert 0.0165 < t < 0.0175


@pytest.mark.parametrize("routes,n_edge,n_cloud,chain_ops", [
    ("all_edge", 4, 1, 4096 * 3),   # the main path: add, compare, select
    ("all_cloud", 4, 1, 4096 * 1),  # a2_cloud_only: one server, the add alone
    ("all_edge", 7, 1, 4096 * 3),   # the sorted insert's chain at any width
    ("half", 3, 5, 2048 * 3),       # both tiers side by side: the longer one
    ("half", 4, 1, 2048 * 3),       # the edge's chain, not the two added
])
def test_lpt_bound_is_its_serial_chain(smoke, routes, n_edge, n_cloud,
                                       chain_ops):
    """M = 4096 tasks; a tier's tasks form one chain of 1 (one server) or 3
    (add, compare, select on loads kept sorted) dependent operations a task
    of 4 clocks at 1.98 GHz, the two tiers' chains side by side; the
    chain, not the 80 KB the walk moves, bounds it."""
    m = 4096
    route = {"all_edge": torch.zeros(m), "all_cloud": torch.ones(m),
             "half": torch.arange(m) % 2}[routes]
    chain = smoke.lpt_chain_ms(route, n_edge, n_cloud)
    assert chain == pytest.approx(chain_ops * 4 / 1.98e9 * 1e3)
    t, by = smoke.bound(m * 20, m * n_edge, chain_ms=chain)
    assert (t, by) == (chain, "chain")
    if routes == "all_edge" and n_edge == 4:
        assert 0.0248 < chain < 0.0249


@pytest.mark.parametrize("iters,n_opts,n_poles,n_versions,levels", [
    (8, 50, 16, 5, 8 * (6 + 4 + 1) + 6 + 4 + 3),   # the paper's lattice
    (3, 50, 16, 5, 3 * 11 + 13),                    # an early-exit run
    (1, 64, 32, 8, 1 * (6 + 5 + 1) + 6 + 5 + 3),
    (2, 2, 1, 1, 2 * (1 + 0 + 1) + 1 + 0 + 0),      # one pole, one version
])
def test_ccg_chain_counts_the_dependent_reductions(smoke, iters, n_opts,
                                                   n_poles, n_versions,
                                                   levels):
    """Per CCG step the argmin over F (⌈log₂F⌉ levels), the worst pole over
    P (⌈log₂P⌉) and the bound update; the encode's reduction over F and
    the epilogue's worst pole and v* over K; at 4 clocks a level."""
    chain = smoke.ccg_chain_ms(iters, n_opts, n_poles, n_versions)
    assert chain == pytest.approx(levels * 4 / 1.98e9 * 1e3)


def test_ccg_solve_bound_is_its_chain_at_the_main_path(smoke):
    """M = 4096 tasks of the paper's lattice at 8 iterations: 101
    dependent levels (0.204 µs) outlast the 8.15 M operations that a
    table-driven solve needs (0.122 µs) and its 147 KB (0.044 µs)."""
    chain = smoke.ccg_chain_ms(8, 50, 16, 5)
    assert 0.000203 < chain < 0.000205
    t, by = smoke.bound(147e3, 8.15e6, chain_ms=chain)
    assert (t, by) == (chain, "chain")


@pytest.mark.parametrize("m,rounds_run,sorted_counts,levels", [
    (4096, 1, [], 4 + 10),                          # the main path's rounds
    (4096, 4, [4096, 4095, 3989], 4 * 14 + 3 * (78 + 8 + 10)),
    (60, 2, [1], 2 * 11 + (0 + 2 + 10)),            # one key: no network
    (16384, 1, [5], 16 + 10 + (6 + 2 + 10)),
])
def test_c6_repair_chain_counts_its_levels(smoke, m, rounds_run,
                                           sorted_counts, levels):
    """Per round run ⌈M/1024⌉ dependent adds and two 5-level butterflies;
    per demoting round the bitonic network over 2^s keys (s(s+1)/2
    levels), the chunk sums and the running sum (⌈n/1024⌉ each) and two
    5-level Kogge–Stone passes; at 4 clocks a level."""
    chain = smoke.c6_repair_chain_ms(m, rounds_run, sorted_counts)
    assert chain == pytest.approx(levels * 4 / 1.98e9 * 1e3)


@pytest.mark.parametrize("m,rounds_run,sorted_counts,levels", [
    (3328, 1, [], 4 + 10 + 15),                     # 53,248 on 16 blocks
    (3328, 4, [3328, 3327], 4 * 29 + 2 * (78 + 8 + 10 + 4 * 15)),
    (16384, 2, [16384], 2 * 41 + (105 + 32 + 10 + 16 * 15)),
])
def test_c6_cluster_chain_adds_the_blocks_links(smoke, m, rounds_run,
                                                sorted_counts, levels):
    """On a cluster of 16 blocks (``m`` tasks and ``sorted_counts`` keys a
    block): per round run the 15 adds of the blocks' draws beside the
    one-block chain, and per demoting round 15 adds of the other blocks'
    prefixes for each of a thread's ⌈n/1024⌉ keys."""
    chain = smoke.c6_repair_chain_ms(m, rounds_run, sorted_counts, 16)
    assert chain == pytest.approx(levels * 4 / 1.98e9 * 1e3)


def _repair_args(m, lo, seed):
    from repro_torch.core.cost_model import SystemConfig, fps_norm, res_norm
    from repro_torch.core.lattice import DecisionLattice

    sys_ = SystemConfig()
    lat = DecisionLattice.build(sys_, "cpu")
    gen = torch.Generator().manual_seed(seed)
    d = {k: torch.randint(lo if k != "route" else 0, n, (m,), generator=gen)
         for k, n in (("route", 2), ("r", 5), ("p", 5), ("v", 5))}
    panel = torch.movedim(lat.bw, -1, 0)[d["route"]].reshape(m, -1)
    z = torch.rand(m, generator=gen) * 0.6 + 0.05
    thr = torch.rand(m, generator=gen) * 0.25 + 0.52
    args = (panel, d["r"], d["p"], d["v"], d["route"], z, thr,
            res_norm(sys_, "cpu"), fps_norm(sys_, "cpu"))
    return args, float(lat.solution_bandwidth(d).sum())


def test_c6_repair_work_counts_what_the_run_needs(smoke):
    """Nothing to demote (r = p = 0): one round run, no sort, the bytes of
    the lanes, the outputs and one panel entry a task.  Half the draw as
    budget: the rounds that demote each sort their positive gains, and the
    bound is the chain."""
    m, rounds = 600, 8
    args, draw = _repair_args(m, 0, seed=1)
    zero = torch.zeros(m, dtype=torch.int64)
    still = (args[0], zero, zero, *args[3:])
    nbytes, flops, run, counts = smoke.c6_repair_work(torch, still,
                                                      0.5 * draw, rounds, 5)
    assert (run, counts) == (1, [])
    assert nbytes == m * (40 + 16 + 4) + 4 * rounds + 4 * 10
    assert flops == m * 27
    args, draw = _repair_args(m, 2, seed=2)
    nbytes, flops, run, counts = smoke.c6_repair_work(torch, args,
                                                      0.5 * draw, rounds, 5)
    assert len(counts) >= 2 and run >= len(counts)
    assert all(0 < n <= m for n in counts)
    chain = smoke.c6_repair_chain_ms(m, run, counts)
    assert smoke.bound(nbytes, flops, chain_ms=chain) == (chain, "chain")


def test_master_work_counts_each_steps_generated_poles(smoke):
    """ccg_master's work over the launches of a solve: per launch the
    recourse of each task's generated poles at its feasible options, the
    whole mask, the feasibility bytes, c1 and the two outputs; per
    feasible option the η max over the poles, the add and the compare, per
    option the select."""
    m, p, f = 4, 3, 5
    fs_ok = torch.tensor([[1, 1, 0, 0, 0], [0] * 5, [1] * 5,
                          [1, 0, 1, 0, 1]], dtype=torch.bool)
    first = torch.zeros((m, p))
    first[0, 0] = 1.0
    first[2] = 1.0
    later = first.clone()
    later[3, 1] = 1.0                   # poles a task: (1, 0, 3, 1)
    nbytes, flops = smoke.master_work([first, later], fs_ok)
    fixed = 4 * m * p + m * f + 4 * f + 8 * m
    # Σ poles · feasible options: 1·2 + 3·5 = 17, then 17 + 1·3 = 20
    assert nbytes == 4 * (17 + 20) + 2 * fixed
    # Σ feasible · (poles + 2) + M·F: (6 + 25 + 6) + 20, (6 + 25 + 9) + 20
    assert flops == 57 + 60
    assert smoke.master_work([], fs_ok) == (0.0, 0.0)
    # a first step's handful of poles is far below the float32 peak: bytes
    assert smoke.bound(nbytes, flops)[1] == "bytes"


@pytest.mark.parametrize("d", [1, 35, 64])
def test_gate_bwd_counts_forward_backward_and_weight_gradients(smoke, d):
    """``gate_cell_bwd``'s operations a stream: the forward again (the
    count ``chip_smoke.py`` gives ``gate_cell``), the backward through the
    hidden units (three 32 × 32 products), and two operations a stream for
    each entry of the weight gradients; ~34 kFLOP a stream at d = 35,
    139 MFLOP at B = 4096: an operations bound of ~2.07 µs."""
    m = 32
    per = smoke.gate_bwd_flops(1, d, m)
    fwd = 2 * (3 * d * m + 3 * m * m + m) + 30 * m
    n_weights = 3 * d * m + 3 * m * m
    assert per >= fwd + 3 * 2 * m * m + 2 * n_weights
    assert smoke.gate_bwd_flops(4096, d, m) == 4096 * per
    if d == 35:
        assert 33_000 <= per <= 35_000
        flops = smoke.gate_bwd_flops(4096, d, m)
        t, by = smoke.bound(4 * 4096 * (d + 3 * m + 3), flops,
                            sfu_ops=4096 * (3 * m + 1))
        assert by == "operations"
        assert t == pytest.approx(flops / smoke.FP32_FLOP_PER_S * 1e3)
        assert 0.0020 < t < 0.0022
