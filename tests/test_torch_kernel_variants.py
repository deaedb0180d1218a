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


@pytest.mark.parametrize("kernel", ["ccg_encode", "mamba_scan",
                                    "flash_attention", "decode_attention",
                                    "lpt_queue"])
@pytest.mark.parametrize("make", ["variants", "diagnostics"])
def test_every_variant_edits_the_committed_source(tool, kernel, make):
    src = (CSRC / f"{kernel}.cu").read_text()
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
