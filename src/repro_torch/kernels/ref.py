"""Plain PyTorch reference oracles, mirroring ``repro/kernels/ref.py``.

Ground truth for the kernel tests and the math the JAX main path runs
(``ops.flash_attention`` sends sq, sk <= 1024 to ``ref.attention``; the
retriever's default is ``ref.topk_retrieval``; ``ops.ssd`` defaults to
``ref.ssd``).  Same layouts, masks and epsilons as the JAX functions,
float32 math throughout.
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


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality, chunked) — the minimal listing of
# arXiv:2405.21060 App. B, with an explicit initial state for decode handoff.
# ---------------------------------------------------------------------------
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k]."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, chunk: int,
        init_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x:  (b, l, h, p)  per-head inputs
    dt: (b, l, h)     positive step sizes (already softplus'd)
    A:  (h,)          negative per-head decay rates
    B:  (b, l, n)     input projections (single group)
    C:  (b, l, n)     output projections
    Returns y (b, l, h, p) in x's dtype and the final state (b, h, p, n)
    f32 (f64 for f64 inputs, a witness for the f32 versions).  Where JAX
    scans the inter-chunk recurrence, this loops over the chunks.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence {l} is not a multiple of chunk {chunk}")
    nc = l // chunk

    a = dt * A[None, None, :]                       # (b, l, h) log-decay <= 0
    xdt = x * dt[..., None]                         # discretized input

    ar = a.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)          # (b,h,c,t)
    xr = xdt.reshape(b, nc, chunk, h, p)                         # (b,c,t,h,p)
    Br = B.reshape(b, nc, chunk, n)                              # (b,c,t,n)
    Cr = C.reshape(b, nc, chunk, n)

    # 1. intra-chunk (diagonal block) output
    L = torch.exp(_segsum(ar))                                   # (b,h,c,t,t)
    y_diag = torch.einsum("bcsn,bctn,bhcst,bcthp->bcshp", Cr, Br, L, xr)

    # 2. chunk-final states
    a_cum = torch.cumsum(ar, dim=-1)                             # (b,h,c,t)
    a_total = a_cum[..., -1]                                     # (b,h,c)
    decay_states = torch.exp(a_total[..., None] - a_cum)         # (b,h,c,t)
    states = torch.einsum("bctn,bhct,bcthp->bchpn", Br, decay_states, xr)

    # 3. inter-chunk recurrence over chunk states: the state *entering*
    #    each chunk, and the final one
    sdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    state = (torch.zeros((b, h, p, n), dtype=sdt, device=x.device)
             if init_state is None else init_state.to(sdt))
    entry = []
    for c in range(nc):
        entry.append(state)
        state = (state * torch.exp(a_total[:, :, c])[..., None, None]
                 + states[:, c].to(sdt))
    entry_states = torch.stack(entry)                            # (c,b,h,p,n)

    # 4. inter-chunk (off-diagonal) output: y_off = C_t . (decay_in . h_entry)
    decay_out = torch.exp(a_cum)                                 # (b,h,c,t)
    y_off = torch.einsum("bcsn,bhcs,cbhpn->bcshp", Cr, decay_out,
                         entry_states)

    y = (y_diag + y_off).reshape(b, l, h, p)
    return y.to(x.dtype), state


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent SSD update.

    state: (b, h, p, n); x: (b, h, p); dt: (b, h); B, C: (b, n).
    Returns (y (b, h, p) in x's dtype, new_state).
    """
    a = torch.exp(dt * A[None, :])                      # (b, h)
    upd = torch.einsum("bhp,bn->bhpn", x * dt[..., None], B)
    new_state = state * a[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C)
    return y.to(x.dtype), new_state


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
