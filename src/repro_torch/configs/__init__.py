"""Architecture registry: importing this package registers all configs."""

from .base import ModelConfig, get_config, list_configs, register, make_smoke  # noqa

from . import (  # noqa
    whisper_large_v3,
    qwen2_vl_7b,
    gemma_7b,
    qwen3_8b,
    deepseek_7b,
    starcoder2_15b,
    mamba2_130m,
    recurrentgemma_9b,
    grok_1_314b,
    deepseek_v2_lite_16b,
)

ARCHS = list_configs()
