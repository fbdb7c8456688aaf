"""Mixture-of-Experts FFN (Qwen3-MoE, DeepSeek-V2): token-choice routing
with capacity buckets, the function of ``repro.models.moe.moe_forward``.

Tokens are regrouped into routing groups of ``_group_size`` tokens (the
largest divisor of b * s that is at most ``MOE_GROUP``).  In each group a
float32 router picks every token's top-k experts (ties to the lower expert
index, as ``jax.lax.top_k``), their probabilities renormalized to sum to
one; each choice gets its rank among the group's choices of that expert in
the flat (token, choice) order, and a choice ranked at or beyond the
capacity C = max(ceil(T k / E * capacity_factor), 1) is dropped.  Each
expert is a SwiGLU over its C slots; every token's output is the sum of its
kept choices' outputs weighted by their probabilities, which are rounded to
the activation dtype first, as the reference's combine tensor is.  Shared
experts (DeepSeek) are one dense SwiGLU of width ``moe_d_ff *
num_shared_experts`` over every token.  The load-balance loss is E *
sum_e(f_e * P_e): f_e the share of all choices (dropped ones too) that
went to expert e, P_e its mean router probability.

Where the reference dispatches and combines with one-hot einsums over a
(G, T, E, C) tensor, the port gathers the same positions: each of a
group's E * C expert slots reads the token that fills it (or a zero row),
and each token reads back its kept choices' slots.  Dispatch is exact
either way; the combine sums a token's k products in float32.  The expert
products are batched GEMMs over the expert axis (``torch.bmm``), which the
reference leaves to XLA outside any Pallas kernel: every expert's weights
are read whatever the tokens chose, so a decode step reads them all.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init
from repro_torch.models.mlp import init_mlp, mlp_forward

MOE_GROUP = 256

# None, or a list to which every ``moe_forward`` call appends its routing's
# {"dropped": choices dropped at capacity, "gap": the smallest margin
# between a token's k-th and (k + 1)-th router probability}, as device
# tensors (read them after the run): how a run shows its drops, and how
# close a choice came to flipping
records = None


def init_moe(generator: torch.Generator, cfg: ModelConfig, *, device,
             dtype) -> Dict:
    """``router`` (d, E), ``wi_gate`` / ``wi_up`` (E, d, f), ``wo`` (E, f,
    d), each expert's matrices with the fan-in of one; ``shared``, an MLP
    of width f * num_shared_experts, where the config has shared
    experts."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.resolved_moe_d_ff
    p = {"router": dense_init((d, e), generator, device=device, dtype=dtype)}
    for name, shape in (("wi_gate", (e, d, f)), ("wi_up", (e, d, f)),
                        ("wo", (e, f, d))):
        p[name] = dense_init(shape, generator, device=device, dtype=dtype,
                             stacked=True)
    if cfg.num_shared_experts > 0:
        p["shared"] = init_mlp(generator, cfg, device=device, dtype=dtype,
                               d_ff=f * cfg.num_shared_experts)
    return p


def _group_size(total: int) -> int:
    """The largest divisor of ``total`` that is at most ``MOE_GROUP``."""
    g = min(MOE_GROUP, total)
    while total % g != 0:
        g -= 1
    return g


def routing_groups(b: int, s: int) -> int:
    """How many routing groups ``moe_forward`` cuts a (b, s) batch's
    tokens into, rows in order."""
    return b * s // _group_size(b * s)


def capacity(cfg: ModelConfig, group: int) -> int:
    """Slots per expert in a routing group of ``group`` tokens."""
    return max(int(math.ceil(group * cfg.num_experts_per_tok
                             / cfg.num_experts * cfg.capacity_factor)), 1)


def route(p: Dict, cfg: ModelConfig, xg: torch.Tensor):
    """The router of groups ``xg`` (G, T, d): (probs (G, T, E) f32, top_p
    (G, T, k) renormalized, top_i (G, T, k) int64, pos (G, T, k) each
    choice's rank within its expert, counts (G, E) each expert's choices
    in the group).  Top-k is a stable descending sort, so equal
    probabilities go to the lower expert index."""
    k = cfg.num_experts_per_tok
    probs = torch.softmax(xg.float() @ p["router"].float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-9)
    G, T = xg.shape[:2]
    # a choice's rank within its expert is its place in a stable sort of
    # the group's (T k) choices by expert, less the choices of the experts
    # before it: the reference's cumsum of one-hots, on (G, T k) indices
    flat = top_i.reshape(G, T * k)
    order = torch.sort(flat, dim=1, stable=True).indices
    counts = torch.zeros(G, cfg.num_experts, dtype=torch.long,
                         device=xg.device).scatter_add_(
        1, flat, torch.ones_like(flat))
    starts = (counts.cumsum(1) - counts).gather(1, flat.gather(1, order))
    rank = torch.arange(T * k, device=xg.device) - starts
    pos = torch.empty_like(flat).scatter_(1, order, rank).reshape(G, T, k)
    return probs, top_p, top_i, pos, counts


def moe_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor, *, lay=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y (b, s, d), aux load-balance loss f32).  Where
    ``lay`` (a ``collectives.Layout``) splits the batch's rows over
    ``data``, x is this rank's whole routing groups and the loss is the
    whole batch's: the counts and the mean router probabilities are summed
    over ``data`` (the probabilities' backward each rank's own)."""
    b, s, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    total = b * s
    T = _group_size(total)
    G = total // T
    C = capacity(cfg, T)
    xg = x.reshape(G, T, d)
    probs, top_p, top_i, pos, counts = route(p, cfg, xg)
    keep = pos < C
    slot = top_i * C + pos                          # (G, T, k) in [0, E C)

    # dispatch: slot j of a group reads token src[j], T a zero row
    tok = torch.arange(T, device=x.device)[:, None].expand(G, T, k)
    src = torch.full((G, E * C + 1), T, dtype=torch.long, device=x.device)
    src.scatter_(1, torch.where(keep, slot, E * C).reshape(G, -1),
                 tok.reshape(G, -1))
    xpad = torch.cat([xg, xg.new_zeros(G, 1, d)], dim=1)
    ein = torch.gather(xpad, 1, src[:, :E * C, None].expand(-1, -1, d))
    ein = ein.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)

    h = F.silu(torch.bmm(ein, p["wi_gate"])) * torch.bmm(ein, p["wi_up"])
    eo = torch.bmm(h, p["wo"])                      # (E, G C, d)
    eo = eo.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # combine: each token's kept choices, weights rounded to x's dtype
    w = torch.where(keep, top_p, 0.0).to(x.dtype)
    back = torch.gather(eo, 1, torch.where(keep, slot, 0).reshape(G, -1, 1)
                        .expand(-1, -1, d)).reshape(G, T, k, d)
    y = (w.float()[..., None] * back.float()).sum(2).to(x.dtype)
    y = y.reshape(b, s, d)
    if cfg.num_shared_experts > 0:
        y = y + mlp_forward(p["shared"], cfg, x)

    counts, mean_p = counts.sum(0), probs.mean(dim=(0, 1))
    n = 1
    if lay is not None:
        # every rank holds G groups: the batch's mean is the ranks' mean
        n = lay.row_ranks
        counts, mean_p = lay.summed(counts), lay.total(mean_p) / n
    frac = counts.float() / (G * n * T * k)
    aux = E * torch.sum(frac * mean_p)
    if records is not None:
        top = torch.sort(probs, dim=-1, descending=True).values
        # scopelint-torch: allow[device-body-side-effect] -- a diagnostic hook, None on the serve path; a captured step would record once
        records.append({"dropped": (~keep).sum(), "gap": (
            top[..., k - 1] - top[..., k]).min() if k < E else None})
    return y, aux
