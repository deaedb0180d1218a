"""Architecture registry: dashed public ids -> config modules.

The ids are the reference's (``repro/configs/registry.py``), and every one
of its ten configs is copied into the port: the dense decoders, the two
sub-quadratic models (Falcon-Mamba's SSM blocks, RecurrentGemma's RG-LRU
and local-attention blocks), the MoE models (Moonshot-v1-16B-A3B,
Mixtral-8x22B) and the two embedding-input front ends (Qwen2-VL-2B with
M-RoPE, MusicGen-medium).
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
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
