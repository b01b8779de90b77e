"""Assigned-architecture registry: ``get_config(arch_id)``.

The port's own copy of ``repro.configs``: the same ten configs and smoke
configs, as pure data. The model serves the dense family without
gemma2's local/global window and softcaps; the others raise
``NotImplementedError`` in ``models.model``."""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ArchConfig

ARCH_IDS = (
    "llava_next_34b", "grok_1_314b", "qwen3_moe_235b_a22b",
    "deepseek_coder_33b", "smollm_135m", "granite_8b", "gemma2_9b",
    "whisper_base", "xlstm_1_3b", "hymba_1_5b",
)

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({
    "llava-next-34b": "llava_next_34b",
    "grok-1-314b": "grok_1_314b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "smollm-135m": "smollm_135m",
    "granite-8b": "granite_8b",
    "gemma2-9b": "gemma2_9b",
    "whisper-base": "whisper_base",
    "xlstm-1.3b": "xlstm_1_3b",
    "hymba-1.5b": "hymba_1_5b",
})


def get_config(arch: str) -> ArchConfig:
    key = _ALIASES.get(arch, arch)
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f".{key}", __package__)
    return mod.CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    key = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f".{key}", __package__)
    return mod.smoke_config()


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
