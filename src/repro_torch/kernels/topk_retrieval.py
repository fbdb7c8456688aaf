"""Top-k cosine retrieval: the CUDA kernel ``csrc/topk_retrieval.cu`` and
its plain PyTorch version.

Replaces ``repro/kernels/topk_retrieval.py::topk_retrieval`` (Pallas TPU).
At the SCOPE shape (a few queries against 250 anchors of width 32) the work
is tiny and the kernel is bound by its launch and its latency chain; one
launch does the whole call: one block per query normalizes the query,
scores the anchors with their loads in flight (normalizing them too unless
the caller passes them unit-norm), and selects with warp shuffles, ties to
the lower anchor index.

``topk_retrieval`` dispatches on the tensor's device: a CPU tensor goes to
``topk_retrieval_plain`` (``ref.topk_retrieval``), a CUDA tensor launches the
kernel (or raises).  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, ref

MAX_K = 64
MAX_DIM = 4096

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

topk_retrieval_plain = ref.topk_retrieval


def topk_retrieval(queries: torch.Tensor, anchors: torch.Tensor, k: int, *,
                   anchors_prenormalized: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (q, d), anchors (n, d) -> (scores (q, k) f32, idx (q, k)
    int32), best first, ties to the lower anchor index."""
    if queries.device.type == "cpu":
        return topk_retrieval_plain(
            queries, anchors, k, anchors_prenormalized=anchors_prenormalized)
    return topk_retrieval_cuda(queries, anchors, k,
                               anchors_prenormalized=anchors_prenormalized)


def check_args(queries: torch.Tensor, anchors: torch.Tensor, k: int) -> None:
    """Raise ``ValueError`` on any input the kernel does not take."""
    if queries.dim() != 2 or anchors.dim() != 2 \
            or queries.shape[1] != anchors.shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} / anchors "
                         f"{tuple(anchors.shape)} must be (q, d) / (n, d)")
    if queries.dtype != torch.float32 or anchors.dtype != torch.float32:
        raise ValueError("the kernel takes float32 queries and anchors")
    if not (queries.is_contiguous() and anchors.is_contiguous()):
        raise ValueError("queries and anchors must be contiguous")
    if not 1 <= k <= min(MAX_K, anchors.shape[0]):
        raise ValueError(f"k={k}: the kernel takes 1 <= k <= "
                         f"min({MAX_K}, n={anchors.shape[0]})")
    if not 1 <= queries.shape[1] <= MAX_DIM or queries.shape[0] == 0:
        raise ValueError(f"queries {tuple(queries.shape)}: need q >= 1 and "
                         f"1 <= d <= {MAX_DIM}")


def topk_retrieval_cuda(queries, anchors, k: int, *,
                        anchors_prenormalized: bool = False):
    """One launch: the kernel normalizes the queries (and the anchors unless
    ``anchors_prenormalized``) as ``topk_retrieval_plain`` does."""
    global launches
    dev = queries.device
    if dev.type != "cuda" or anchors.device != dev:
        raise ValueError(f"topk_retrieval kernel needs CUDA tensors on one "
                         f"device, got {dev}/{anchors.device}")
    check_args(queries, anchors, k)
    nq, d = queries.shape
    scores = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    fn = build.load("topk_retrieval", "repro_topk_retrieval", _ARGTYPES)
    err = fn(queries.data_ptr(), anchors.data_ptr(), scores.data_ptr(),
             idx.data_ptr(), nq, anchors.shape[0], d, int(k),
             int(not anchors_prenormalized),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "topk_retrieval")
    # scopelint-torch: allow[device-body-side-effect] -- counted at the Python call; a CUDA graph replay repeats the launch without counting it (ROADMAP item 8b)
    launches += 1
    return scores, idx
