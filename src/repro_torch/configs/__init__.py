"""Architecture registry: importing this package registers every architecture
the port serves (``--arch <id>``).  Only qwen2-0.5b so far; ROADMAP.md lists
the families still to port."""
from repro_torch.configs.base import ModelConfig, get_config, list_configs, register

from repro_torch.configs import qwen2_0_5b  # noqa: F401  (registers its CONFIG)

ARCH_IDS = list_configs()

__all__ = ["ModelConfig", "ARCH_IDS", "get_config", "list_configs", "register"]
