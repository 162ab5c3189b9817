"""Architecture registry: ``--arch <id>`` resolves through here.

The port registers every arch of the reference's registry: the dense GQA
ones (qwen2, danube, smollm and glm4), the GQA mixture of experts
(mixtral), DeepSeek-V3 (MLA, a leading dense stack, shared and routed
experts, the MTP head), the attention-free Mamba2 SSM stack (mamba2),
Jamba's hybrid of SSM, attention and MoE sublayers (jamba), Whisper's
encoder-decoder (whisper) and PaliGemma's prefix-LM decoder (paligemma).
An unknown arch raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from repro_torch.configs.base import (ArchConfig, SHAPES, ShapeConfig,
                                      shape_applicable)

_ARCH_MODULES = {
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube_3_4b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id.endswith("-smoke"):
        return get_config(arch_id[: -len("-smoke")]).smoke()
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; "
                       f"known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


__all__ = [
    "ArchConfig", "ShapeConfig", "SHAPES", "ARCH_IDS",
    "get_config", "shape_applicable",
]
