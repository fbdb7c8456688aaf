"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

  topk_retrieval         — anchor retrieval  (replaces kernels/topk_retrieval.py)
  flash_attention        — prefill attention (replaces kernels/flash_attention.py)
  flash_attention_bwd    — its gradient, for training (XLA's gradient of
                           ref.attention in the reference)
  decode_attention       — decode attention, dense cache
                           (replaces kernels/decode_attention.py::decode_attention)
  paged_decode_attention — decode attention, block-paged cache (replaces
                           kernels/decode_attention.py::paged_decode_attention)
  ssd_scan               — Mamba2 SSD chunk scan of the prefill
                           (replaces kernels/ssd_scan.py)
  ssd_scan_bwd           — its gradient, for training (XLA's gradient of
                           ref.ssd in the reference)
  ssd_decode_step        — Mamba2 SSD decode step, state updated in place
                           (the reference's plain-XLA ref.ssd_decode_step)

Each kernel's wrapper keeps a count of its launches in a module attribute;
the helpers below read and reset all eight at once (and the flash
forward's and backward's counts by shape, ``flash_attention.shape_launches``
and ``bwd_shape_launches``).
"""
from typing import Dict

from repro_torch.kernels import (decode_attention, flash_attention,
                                 ssd_decode_step, ssd_scan, topk_retrieval)

# kernel -> (module, counter attribute)
_COUNTERS = {"topk_retrieval": (topk_retrieval, "launches"),
             "flash_attention": (flash_attention, "launches"),
             "flash_attention_bwd": (flash_attention, "bwd_launches"),
             "decode_attention": (decode_attention, "launches"),
             "paged_decode_attention": (decode_attention, "paged_launches"),
             "ssd_scan": (ssd_scan, "launches"),
             "ssd_scan_bwd": (ssd_scan, "bwd_launches"),
             "ssd_decode_step": (ssd_decode_step, "launches")}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
    flash_attention.shape_launches.clear()
    flash_attention.bwd_shape_launches.clear()
