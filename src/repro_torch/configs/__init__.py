"""Config registry — importing this package registers the port's configs."""
from repro_torch.configs import paper_native, qwen3_1p7b, tiny  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    REGISTRY,
    ModelConfig,
    get_config,
    register,
)
