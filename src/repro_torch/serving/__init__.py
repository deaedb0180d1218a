"""Serving: policies, the simulator, the session and its round graphs, the
tier pools and their dispatch executor, and the scenarios."""
from repro_torch.serving.session import (  # noqa: F401
    AdmissionConfig,
    FinetuneConfig,
    ServeSession,
)
