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
