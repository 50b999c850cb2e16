"""Architecture registry of the port: the configurations it runs.

Each ``<arch>.py`` is a copy of the JAX package's file of the same name;
``get_config`` resolves the dashed arch id (``olmo-1b``).
"""

from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.utils.registry import Registry

ARCHS: Registry = Registry("architecture")


def register(name: str):
    def deco(fn):
        ARCHS.register(name, fn)
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    return ARCHS.get(name)()


# import for registration side effects
from repro_torch.configs import (  # noqa: E402,F401
    arctic_480b,
    bert_large,
    gemma_7b,
    hubert_xlarge,
    hymba_1_5b,
    llama32_vision_90b,
    mistral_nemo_12b,
    olmo_1b,
    qwen3_moe_235b,
    rwkv6_7b,
    stablelm_12b,
)

# The ten assigned architectures (dry-run set), in assignment order.
ASSIGNED = [
    "rwkv6-7b",
    "olmo-1b",
    "mistral-nemo-12b",
    "stablelm-12b",
    "gemma-7b",
    "hubert-xlarge",
    "arctic-480b",
    "qwen3-moe-235b-a22b",
    "hymba-1.5b",
    "llama-3.2-vision-90b",
]
