"""Architecture registry of the port: the dense configurations it serves.

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
from repro_torch.configs import gemma_7b, mistral_nemo_12b, olmo_1b  # noqa: E402,F401
