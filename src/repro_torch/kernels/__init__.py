"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

  topk_retrieval   — anchor retrieval   (replaces kernels/topk_retrieval.py)
  flash_attention  — prefill attention  (replaces kernels/flash_attention.py)
  decode_attention — decode attention   (replaces kernels/decode_attention.py)

Each module keeps a ``launches`` count of its kernel's launches; the helpers
below read and reset all three at once.
"""
from typing import Dict

from repro_torch.kernels import (decode_attention, flash_attention,
                                 topk_retrieval)

_MODULES = {"topk_retrieval": topk_retrieval,
            "flash_attention": flash_attention,
            "decode_attention": decode_attention}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
