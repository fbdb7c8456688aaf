"""Device selection for the port's entry points.

Every entry point (``init_params``, the weight bridge, ``AnchorRetriever``,
``ReasoningEstimator``, ``ScopeEngine.build``) runs on the card unless the
caller asks for the CPU.  There is no silent fallback: without CUDA the
default raises, so a run that meant to use the kernels can never slide onto
their plain versions.  Under an initialised process group (one process a
card, as ``torchrun`` starts them) the default is the rank's own card,
``cuda:{LOCAL_RANK}``.
"""
from __future__ import annotations

import os
from typing import Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0``, or ``cuda:{LOCAL_RANK}`` under an initialised
    process group (raises without CUDA); anything else as given.

    Resolving a CUDA device also turns TF32 off for float32 matmuls and
    convolutions: TF32 keeps ~3 decimal digits, which breaks the 2e-5 float32
    parity the port is held to.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "port on the CPU (plain PyTorch versions of the kernels)")
        rank = (int(os.environ.get("LOCAL_RANK", 0))
                if dist.is_available() and dist.is_initialized() else 0)
        device = f"cuda:{rank}"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
