"""Configs of the port: ``base.ModelConfig``, the SCOPE estimator configs
(``scope_estimator.CONFIG`` / ``TINY``), the Mamba2 backbone
(``mamba2_1_3b.CONFIG``), the zamba2 hybrid (``zamba2_7b.CONFIG``) and the
``get_config(name)`` registry."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import mamba2_1_3b, scope_estimator, zamba2_7b
from repro_torch.configs.base import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {
    cfg.name: cfg for cfg in (scope_estimator.CONFIG, scope_estimator.TINY,
                              mamba2_1_3b.CONFIG, zamba2_7b.CONFIG)}


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}") from None


__all__ = ["ModelConfig", "get_config"]
