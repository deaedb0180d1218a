"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``<name>/ref.py``) and its dispatching wrapper (``<name>/ops.py``).

``force=`` on every wrapper: ``"auto"`` launches the kernel for CUDA tensors
and runs the plain version for CPU tensors; ``"ref"`` always runs the plain
version; ``"kernel"`` always launches the kernel (a CPU tensor raises).  A
build or launch failure raises; nothing falls back.
"""
from repro_torch.kernels._build import LAUNCHES


def reset_launch_counts() -> None:
    """Zero every wrapper's launch counter."""
    LAUNCHES.clear()


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return dict(LAUNCHES)
