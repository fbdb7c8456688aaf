"""Device selection for the port's entry points.

Every entry point (``init_params``, the weight bridge, ``AnchorRetriever``,
``ReasoningEstimator``, ``ScopeEngine.build``) runs on the card unless the
caller asks for the CPU.  There is no silent fallback: without CUDA the
default raises, so a run that meant to use the kernels can never slide onto
their plain versions.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises without CUDA); anything else as given.

    Resolving a CUDA device also turns TF32 off for float32 matmuls and
    convolutions: TF32 keeps ~3 decimal digits, which breaks the 2e-5 float32
    parity the port is held to.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "port on the CPU (plain PyTorch versions of the kernels)")
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
