"""Architecture registry: importing this package registers every architecture
the port runs (``--arch <id>``): the dense qwen2-0.5b, deepseek-7b,
minitron-8b and llama3-405b, the hybrid hymba-1.5b and the ssm
falcon-mamba-7b.  ROADMAP.md lists the families still to port."""
from repro_torch.configs.base import ModelConfig, get_config, list_configs, register

from repro_torch.configs import deepseek_7b  # noqa: F401  (registers its CONFIG)
from repro_torch.configs import falcon_mamba_7b  # noqa: F401
from repro_torch.configs import hymba_1_5b  # noqa: F401
from repro_torch.configs import llama3_405b  # noqa: F401
from repro_torch.configs import minitron_8b  # noqa: F401
from repro_torch.configs import qwen2_0_5b  # noqa: F401

ARCH_IDS = list_configs()

__all__ = ["ModelConfig", "ARCH_IDS", "get_config", "list_configs", "register"]
