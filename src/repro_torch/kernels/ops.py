"""The kernel entry points model and core code call.

Each dispatches on its input's device and nothing else: a CUDA tensor
launches the hand-written kernel (or raises on what it does not take), a
CPU tensor runs the plain PyTorch version.  There is no implementation
switch, so the main path on the card always goes through the kernels.
"""
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_decode_step import ssd_decode_step
from repro_torch.kernels.ssd_scan import ssd_scan as ssd
from repro_torch.kernels.topk_retrieval import topk_retrieval

__all__ = ["decode_attention", "flash_attention", "paged_decode_attention",
           "ssd", "ssd_decode_step", "topk_retrieval"]
