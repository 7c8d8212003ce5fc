"""Architecture registry of the port: ``get_config(arch_id)``.

The reference's architectures, in the reference's order; each module
under ``repro_torch/configs/`` exports ``CONFIG`` with the same values
as its twin in the reference.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.core.config import ModelConfig

_ALIAS = {
    "qwen3-32b": "qwen3_32b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mamba2-130m": "mamba2_130m",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen2.5-32b": "qwen2_5_32b",
    "granite-8b": "granite_8b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mixtral-8x22b": "mixtral_8x22b",
    "smollm-135m": "smollm_135m",
    "paper-llama-pair": "paper_llama_pair",
    "paper-gemma-pair": "paper_gemma_pair",
}


def list_archs() -> List[str]:
    return list(_ALIAS)


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIAS.get(arch, arch)
    if mod_name not in _ALIAS.values():
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
