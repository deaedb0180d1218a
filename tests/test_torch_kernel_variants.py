"""``tools/kernel_variants.py`` edits the committed CUDA sources by text:
every edit of every variant must still find its text exactly once, or the
tool fails on the card before it times anything.  Checked here on the CPU,
without nvcc; the tool is loaded by its path."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "kernel_variants", ROOT / "tools" / "kernel_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", ["ccg_encode", "ccg_master", "mamba_scan",
                                    "flash_attention", "decode_attention",
                                    "lpt_queue", "rglru_scan", "ccg_solve",
                                    "gate_cell", "gate_cell_bwd",
                                    "c6_repair", "flash_attention_bwd"])
@pytest.mark.parametrize("make", ["variants", "diagnostics"])
def test_every_variant_edits_the_committed_source(tool, kernel, make):
    src = (CSRC / tool.source_file(kernel)).read_text()
    out = getattr(tool, make)(kernel, src)
    assert out["committed"] == src
    assert len(out) >= 3 if make == "diagnostics" else len(out) >= 2
    others = [v for name, v in out.items() if name != "committed"]
    assert all(v != src for v in others)
    assert len(set(others)) == len(others)


def test_edit_needs_its_text_exactly_once(tool):
    assert tool.edit("a b c", ("b", "x")) == "a x c"
    with pytest.raises(AssertionError):
        tool.edit("a b b", ("b", "x"))
    with pytest.raises(AssertionError):
        tool.edit("a b c", ("d", "x"))


def test_replace_span_needs_both_markers_once(tool):
    assert tool.replace_span("a [b] c", "[", "]", "x") == "a x] c"
    with pytest.raises(AssertionError):
        tool.replace_span("a [b] [c]", "[", "]", "x")
    with pytest.raises(AssertionError):
        tool.replace_span("a ]b[ c", "[", "]", "x")


def test_with_constant_sets_the_declared_value(tool):
    src = "constexpr int kStore = 0;   // note\nint x = 0;"
    assert tool.with_constant(src, "constexpr int kStore = 0;", 2) == \
        "constexpr int kStore = 2;   // note\nint x = 0;"


@pytest.mark.parametrize("kernel,variant,text", [
    ("ccg_encode", "fold", "constexpr int kTableMaxK = 0;"),
    ("ccg_encode", "stores_vector", "dst[v] = src[v];"),
    ("ccg_encode", "stores_bulk", "cp.async.bulk.global.shared::cta"),
    ("ccg_master", "warp_per_task", "warp_argmin(best, arg);"),
    ("ccg_master", "two_per_warp", "constexpr int kLanes = 16;"),
    ("flash_attention_bwd", "first_design",
     "constexpr bool kTensorCores = false;"),
    ("flash_attention_bwd", "d256_one_pass",
     "constexpr bool kSplitDkv = false;"),
])
def test_named_variants_make_their_change(tool, kernel, variant, text):
    src = (CSRC / tool.source_file(kernel)).read_text()
    assert text not in src
    assert text in tool.variants(kernel, src)[variant]


def test_warp_per_task_keeps_the_launcher(tool):
    """The first design replaces the kernel only: its launcher's grid (one
    warp a task at kLanes = 32) and the entry point stay."""
    src = (CSRC / "ccg_master.cu").read_text()
    out = tool.variants("ccg_master", src)["warp_per_task"]
    assert "vote_first" not in out and "extern \"C\" int ccg_master_launch" in out
    assert "constexpr int kLanes = 32;" in out


def test_shared_layout_puts_each_subset_at_its_row(tool):
    """rec[p][code][f] sits at p·ps + code·fs + f of the flat layout, the
    padding is zero."""
    import torch

    p, f, k = 3, 50, 2
    rec = torch.arange(p * f * 2 ** k, dtype=torch.float32).view(p, f, 2 ** k)
    table = tool.shared_layout(torch, rec)
    fs, ps = 64, 4 * 64 + 1
    assert table.shape == (p, ps)
    flat = table.reshape(-1)
    for pole, opt, code in [(0, 0, 0), (1, 49, 3), (2, 17, 1)]:
        assert flat[pole * ps + code * fs + opt] == rec[pole, opt, code]
    assert float(table.sum()) == float(rec.sum())


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_attention_bwd"])
def test_tensor_core_cuts_inline_the_shared_header(tool, kernel):
    """The attention sources take their mma/cp.async helpers from
    mma_bf16.cuh: a cut of a helper inlines the header and edits its copy,
    so the committed header and the other source stay as they are."""
    src = (CSRC / tool.source_file(kernel)).read_text()
    out = tool.diagnostics(kernel, src)
    for name in ("no_mma", "no_loads"):
        assert '#include "mma_bf16.cuh"' not in out[name]
        assert "static __device__ __forceinline__ void mma_bf16(" in out[name]
    assert tool.NO_MMA in out["no_mma"] and tool.MMA not in out["no_mma"]


def test_ptxas_report_reads_registers_and_spills(tool):
    log = """ptxas info    : Compiling entry function '_ZN1a9fa_bwd_dkvE' for 'sm_90a'
ptxas info    : Function properties for _ZN1a9fa_bwd_dkvE
    8 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Function properties for _ZN1a5otherE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 384 bytes cmem[0]
"""
    assert tool.ptxas_report(log, "fa_bwd") == {"_ZN1a9fa_bwd_dkvE": {
        "stack": 8, "spill_stores": 16, "spill_loads": 24, "registers": 255}}
