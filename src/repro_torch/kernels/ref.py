"""Plain PyTorch reference oracles, mirroring ``repro/kernels/ref.py``.

Ground truth for the kernel tests and the math the JAX main path runs
(``ops.flash_attention`` sends sq, sk <= 1024 to ``ref.attention``; the
retriever's default is ``ref.topk_retrieval``).  Same layouts, masks and
epsilons as the JAX functions, float32 math throughout.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def softcap_fn(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def attention_mask(sq: int, sk: int, *, causal: bool, window: int,
                   q_offset: int, device) -> torch.Tensor:
    """(sq, sk) bool: which keys each query position may attend."""
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: Optional[float] = None, q_offset: int = 0
              ) -> torch.Tensor:
    """Naive masked softmax attention.

    q: (b, hq, sq, d); k: (b, hkv, sk, d); v: (b, hkv, sk, dv), hq % hkv == 0
    (q-head h reads kv-head h // (hq // hkv)).  ``window`` > 0 keeps the last
    ``window`` keys (inclusive of self); ``q_offset`` is q[0]'s absolute
    position.  A row with no valid key gets the uniform average of v, as in
    the JAX oracle (masked logits are -1e30, not -inf).
    """
    b, hq, sq, d = q.shape
    dv = v.shape[-1]
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5

    qg = (q.float() * scale).reshape(b, hkv, group, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if softcap > 0.0:
        logits = softcap_fn(logits, softcap)
    mask = attention_mask(sq, sk, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def topk_retrieval(queries: torch.Tensor, anchors: torch.Tensor, k: int, *,
                   anchors_prenormalized: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine-similarity top-k: (scores (q, k) f32, idx (q, k) int32).

    Ties go to the lower anchor index, the order ``lax.top_k`` gives: a
    stable ascending sort of the negated scores keeps equal scores in index
    order (``torch.topk`` promises no order among ties).
    """
    qn = queries / (torch.linalg.norm(queries, dim=-1, keepdim=True) + 1e-8)
    if anchors_prenormalized:
        an = anchors
    else:
        an = anchors / (torch.linalg.norm(anchors, dim=-1, keepdim=True)
                        + 1e-8)
    sims = qn.float() @ an.float().T
    neg, order = torch.sort(-sims, dim=-1, stable=True)
    return -neg[:, :k], order[:, :k].to(torch.int32)
