"""Configs of the port: ``base.ModelConfig``, the SCOPE estimator configs
(``scope_estimator.CONFIG`` / ``TINY``), the dense GQA stacks
(``starcoder2_3b.CONFIG``, ``internlm2_1_8b.CONFIG``), gemma2's
(``gemma2_2b.CONFIG``, ``gemma2_9b.CONFIG``), the Mamba2 backbone
(``mamba2_1_3b.CONFIG``), the zamba2 hybrid (``zamba2_7b.CONFIG``), the
multimodal stub backbones (``qwen2_vl_7b.CONFIG``,
``whisper_medium.CONFIG``), the mixture-of-experts backbones
(``qwen3_moe_235b_a22b.CONFIG``, ``deepseek_v2_lite_16b.CONFIG``) and the
``get_config(name)`` registry: the reference's ten assigned configs and
the two SCOPE estimators; ``ASSIGNED_ARCHS`` in the reference's order, and
the planning shapes of ``base``."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_v2_lite_16b, gemma2_2b, gemma2_9b,
                                 internlm2_1_8b, mamba2_1_3b, qwen2_vl_7b,
                                 qwen3_moe_235b_a22b, scope_estimator,
                                 starcoder2_3b, whisper_medium, zamba2_7b)
from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                     shape_applicable)

_REGISTRY: Dict[str, ModelConfig] = {
    cfg.name: cfg for cfg in (scope_estimator.CONFIG, scope_estimator.TINY,
                              starcoder2_3b.CONFIG, internlm2_1_8b.CONFIG,
                              gemma2_2b.CONFIG, gemma2_9b.CONFIG,
                              mamba2_1_3b.CONFIG, zamba2_7b.CONFIG,
                              qwen2_vl_7b.CONFIG, whisper_medium.CONFIG,
                              qwen3_moe_235b_a22b.CONFIG,
                              deepseek_v2_lite_16b.CONFIG)}

ASSIGNED_ARCHS = (
    "starcoder2-3b",
    "whisper-medium",
    "internlm2-1.8b",
    "zamba2-7b",
    "gemma2-9b",
    "qwen2-vl-7b",
    "qwen3-moe-235b-a22b",
    "gemma2-2b",
    "mamba2-1.3b",
    "deepseek-v2-lite-16b",
)


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}") from None


def list_configs():
    return dict(_REGISTRY)


__all__ = [
    "ModelConfig", "InputShape", "INPUT_SHAPES", "shape_applicable",
    "get_config", "list_configs", "ASSIGNED_ARCHS",
]
