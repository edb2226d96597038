"""Config registry — importing this package registers the port's configs."""
from repro_torch.configs import (  # noqa: F401
    codeqwen1p5_7b,
    deepseek_moe_16b,
    deepseek_v2_236b,
    gemma_2b,
    gemma_7b,
    mamba2_2p7b,
    paper_native,
    qwen2_vl_7b,
    qwen3_1p7b,
    seamless_m4t_large_v2,
    tiny,
    zamba2_2p7b,
)
from repro_torch.configs.base import (  # noqa: F401
    REGISTRY,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    register,
)
