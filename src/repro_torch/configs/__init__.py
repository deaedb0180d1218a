"""Model configurations of the port (copies of ``repro/configs``)."""
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
