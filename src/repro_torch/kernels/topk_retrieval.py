"""Top-k cosine retrieval: the CUDA kernel ``csrc/topk_retrieval.cu`` and
its plain PyTorch version.

Replaces ``repro/kernels/topk_retrieval.py::topk_retrieval`` (Pallas TPU).
At the SCOPE shape (a few queries against 250 anchors of width 32) the work
is tiny and the kernel is bound by its launch and its k selection rounds;
one block per query keeps the scores in shared memory and merges them into a
running top-k buffer, ties to the lower anchor index.  As on the TPU, the
query normalization stays outside the kernel, in this wrapper.

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

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

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


def check_args(qn: torch.Tensor, an: torch.Tensor, k: int) -> None:
    """Raise ``ValueError`` on any input the kernel does not take."""
    if qn.dim() != 2 or an.dim() != 2 or qn.shape[1] != an.shape[1]:
        raise ValueError(f"queries {tuple(qn.shape)} / anchors "
                         f"{tuple(an.shape)} must be (q, d) / (n, d)")
    if qn.dtype != torch.float32 or an.dtype != torch.float32:
        raise ValueError("the kernel takes float32 queries and anchors")
    if not (qn.is_contiguous() and an.is_contiguous()):
        raise ValueError("queries and anchors must be contiguous")
    if not 1 <= k <= min(MAX_K, an.shape[0]):
        raise ValueError(f"k={k}: the kernel takes 1 <= k <= "
                         f"min({MAX_K}, n={an.shape[0]})")
    if not 1 <= qn.shape[1] <= MAX_DIM or qn.shape[0] == 0:
        raise ValueError(f"queries {tuple(qn.shape)}: need q >= 1 and "
                         f"1 <= d <= {MAX_DIM}")


def topk_retrieval_cuda(queries, anchors, k: int, *,
                        anchors_prenormalized: bool = False):
    global launches
    dev = queries.device
    if dev.type != "cuda" or anchors.device != dev:
        raise ValueError(f"topk_retrieval kernel needs CUDA tensors on one "
                         f"device, got {dev}/{anchors.device}")
    qn = queries / (torch.linalg.norm(queries, dim=-1, keepdim=True) + 1e-8)
    an = anchors if anchors_prenormalized else anchors / (
        torch.linalg.norm(anchors, dim=-1, keepdim=True) + 1e-8)
    qn, an = qn.float().contiguous(), an.float().contiguous()
    check_args(qn, an, k)
    nq, d = qn.shape
    scores = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    fn = build.load("topk_retrieval", "repro_topk_retrieval", _ARGTYPES)
    err = fn(qn.data_ptr(), an.data_ptr(), scores.data_ptr(), idx.data_ptr(),
             nq, an.shape[0], d, int(k),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "topk_retrieval")
    launches += 1
    return scores, idx
