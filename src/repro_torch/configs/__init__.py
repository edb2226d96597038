"""Config registry — importing this package registers the port's configs."""
from repro_torch.configs import mamba2_2p7b, paper_native, qwen3_1p7b, tiny  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    REGISTRY,
    ModelConfig,
    SSMConfig,
    get_config,
    register,
)
