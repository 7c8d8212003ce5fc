"""Architecture registry of the port: ``get_config(arch_id)``.

Only the architectures the port runs are registered; each module under
``repro_torch/configs/`` exports ``CONFIG`` with the same values as its
twin in the reference.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.core.config import ModelConfig

_ALIAS = {"smollm-135m": "smollm_135m"}


def list_archs() -> List[str]:
    return sorted(_ALIAS)


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIAS.get(arch, arch)
    if mod_name not in _ALIAS.values():
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
