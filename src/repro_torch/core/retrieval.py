"""Dense top-K anchor retrieval (SCOPE §3.2, Eq. 2-3).

Cosine similarity between query and anchor embeddings through
``kernels.ops.topk_retrieval``: the CUDA kernel on the card, its plain
PyTorch version on the CPU.  The anchor set is fixed for the retriever's
lifetime, so its unit-norm matrix is computed once, on the device, at
construction.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.fingerprint import AnchorSet
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops


class AnchorRetriever:
    def __init__(self, anchor_set: AnchorSet, *, device: DeviceLike = None):
        self.anchor_set = anchor_set
        self.device = resolve_device(device)
        embs = torch.as_tensor(np.asarray(anchor_set.embeddings, np.float32),
                               device=self.device)
        # unit rows, same epsilon as the kernels' in-call normalization
        self._anchors_norm = embs / (
            torch.linalg.norm(embs, dim=-1, keepdim=True) + 1e-8)

    def retrieve(self, query_embs: np.ndarray, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """query_embs: (Q, d) or (d,).  Returns (sims (Q, k), idx (Q, k))."""
        q = torch.as_tensor(np.ascontiguousarray(np.atleast_2d(query_embs),
                                                 dtype=np.float32),
                            device=self.device)
        scores, idx = ops.topk_retrieval(q, self._anchors_norm, int(k),
                                         anchors_prenormalized=True)
        return scores.cpu().numpy(), idx.cpu().numpy()
