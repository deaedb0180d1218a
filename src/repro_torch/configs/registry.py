"""Architecture registry: dashed public ids -> config modules.

The ids are the reference's (``repro/configs/registry.py``).  The dense
decoders and the two sub-quadratic models (Falcon-Mamba's SSM blocks,
RecurrentGemma's RG-LRU and local-attention blocks) are copied into the
port; the others need MoE blocks or front ends the port does not have yet,
and asking for them raises, naming ROADMAP queue A.14.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "yi-34b": "repro_torch.configs.yi_34b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}

# ids of the reference whose layers the port cannot run yet
_UNPORTED = {
    "musicgen-medium": "an embedding-input front end",
    "moonshot-v1-16b-a3b": "MoE blocks",
    "mixtral-8x22b": "MoE blocks and sliding-window attention",
    "qwen2-vl-2b": "M-RoPE and an embedding-input front end",
}

ARCH_IDS = tuple(_MODULES) + tuple(_UNPORTED)


def _module(arch: str):
    if arch in _UNPORTED:
        raise NotImplementedError(
            f"{arch!r} needs {_UNPORTED[arch]}: ROADMAP queue A.14")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
