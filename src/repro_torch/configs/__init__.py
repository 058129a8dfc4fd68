"""Architecture registry: importing this package registers every architecture
the port runs (``--arch <id>``): the dense qwen2-0.5b, deepseek-7b,
minitron-8b and llama3-405b, the moe qwen2-moe-a2.7b and
phi3.5-moe-42b-a6.6b, the vlm llava-next-mistral-7b, the hybrid hymba-1.5b,
the ssm falcon-mamba-7b and the encdec whisper-medium: all ten of the JAX
package's.  Besides them the port-only interleaved jamba2-3b
(``port_only_configs``)."""
from repro_torch.configs.base import (SHAPES, InterleavedConfig, ModelConfig, ShapeConfig,
                                      get_config, list_configs, port_only_configs, register)

from repro_torch.configs import deepseek_7b  # noqa: F401  (registers its CONFIG)
from repro_torch.configs import falcon_mamba_7b  # noqa: F401
from repro_torch.configs import hymba_1_5b  # noqa: F401
from repro_torch.configs import jamba2_3b  # noqa: F401
from repro_torch.configs import llama3_405b  # noqa: F401
from repro_torch.configs import llava_next_mistral_7b  # noqa: F401
from repro_torch.configs import minitron_8b  # noqa: F401
from repro_torch.configs import phi3_5_moe  # noqa: F401
from repro_torch.configs import qwen2_0_5b  # noqa: F401
from repro_torch.configs import qwen2_moe_a2_7b  # noqa: F401
from repro_torch.configs import whisper_medium  # noqa: F401

ARCH_IDS = list_configs()

__all__ = ["SHAPES", "InterleavedConfig", "ModelConfig", "ShapeConfig", "ARCH_IDS",
           "get_config", "list_configs", "port_only_configs", "register"]
