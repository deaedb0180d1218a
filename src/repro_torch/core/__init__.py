"""R2E-VID core: temporal gating + two-stage robust routing (the paper's
primary contribution).  The package exports the gate's front end and its
training surface, as the reference's ``repro/core/__init__.py:4-5`` does;
the routing modules are imported by their own names (the kernels' plain
versions import ``core.cost_model``, so exporting them here would make an
import cycle)."""
from repro_torch.core.features import feature_dim, motion_features, segment_features  # noqa: F401
from repro_torch.core.gating import GateConfig, gate_loss, gate_scan, gate_scan_batch, gate_specs  # noqa: F401
