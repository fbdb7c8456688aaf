"""GQA attention block (RoPE or M-RoPE or none, qk-norm, causal or not,
optionally windowed, with gemma2's logit softcap and an optional score
scale), and whisper's cross-attention.

Activations are (batch, seq, d_model); heads are split internally.  The
full-sequence path (prefill) returns the layer's K/V; the single-token
decode paths write the new K/V into the cache at each row's own slot, of a
dense (b, hkv, S, hd) cache or of a block-paged one.  A layer's window is
``resolve_window``'s, as in the JAX package, and so is the ring-buffer
decode of a windowed layer whose dense cache holds exactly ``window``
slots.  Every attention call passes ``cfg.logit_softcap`` and
``cfg.attn_scale`` (0: 1/sqrt(head_dim)) to its kernel.  Under
``rope_kind="none"`` the position tables are None and nothing rotates.

Cross-attention (the encoder-decoder's decoder blocks) has ``num_heads``
K/V heads, projected once from the encoder output (``cross_kv``) and kept
in the cache as ``ck`` / ``cv`` (b, hq, enc_seq, hd); every query, of a
prefill and of each decode step (sq = 1), attends all of them through the
flash kernel with no causal mask, as the reference does.  Split over
``model``, a rank projects and caches its own heads' K/V (``ck`` / ``cv``
(b, hq / n, enc_seq, hd)) and attends with its own query heads, giving the
float32 share of ``wo`` (``partial``), as self-attention does.

Multi-head latent attention (DeepSeek-V2's ``mla`` kinds) caches one
latent a token instead of per-head K/V: ``c_kv`` (b, S, kv_lora_rank),
RMS-normalized, and ``k_rope`` (b, S, qk_rope_head_dim), one rotated key
head shared by every query head.  The full-sequence path up-projects the
latent to per-head keys (nope part from ``w_uk``, the shared rope head
broadcast beside it) and values (``w_uv``) and runs the flash kernel at
q / k head dim nope + rope and v head dim ``v_head_dim`` (192 / 128 at
deepseek-v2-lite's width, 48 / 32 on ``reduced()``), scaled by (nope +
rope) ** -0.5.  The decode step attends in the latent space (the absorbed
form): ``w_uk`` folds into the query and ``w_uv`` into the output, in
float32 einsums, as the reference's plain XLA decode; it runs as plain
PyTorch on the card too, as there is no Pallas kernel behind it.  Split
over ``model`` (``partial``), a rank holds its heads' columns of ``wq``,
``w_uk`` and ``w_uv`` and rows of ``wo``, and the whole ``w_dkv``: it
computes the whole latent (the caches stay whole on every rank, each
writing the same latent) and attends with its own heads only, the flash
call at h / n heads.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import rope as rope_mod
from repro_torch.models.common import (dense_init, init_rmsnorm, out_proj,
                                      promoted_matmul, rmsnorm)


def resolve_window(cfg: ModelConfig, kind: str) -> int:
    if cfg.force_window > 0:
        return cfg.force_window
    if kind == "attn_local":
        return cfg.sliding_window
    return 0


def init_gqa(generator: torch.Generator, cfg: ModelConfig, *, device,
             dtype) -> Dict:
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {name: dense_init(shape, generator, device=device, dtype=dtype)
         for name, shape in (("wq", (d, hq * hd)), ("wk", (d, hkv * hd)),
                             ("wv", (d, hkv * hd)), ("wo", (hq * hd, d)))}
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, device=device, dtype=dtype)
        p["k_norm"] = init_rmsnorm(hd, device=device, dtype=dtype)
    return p


def _gqa_qkv(p, cfg: ModelConfig, x, cos, sin):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.rmsnorm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.rmsnorm_eps)
    if cos is not None:
        q = rope_mod.apply_rope(q, cos, sin)
        k = rope_mod.apply_rope(k, cos, sin)
    return q, k, v


def gqa_full(p, cfg: ModelConfig, x, cos, sin, *, kind: str = "attn",
             causal: bool = True, partial: bool = False
             ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence GQA over the layer's window, causal unless ``causal``
    is False (the encoder's).  Returns (y, {"k", "v"}) with the cache slice
    as (b, hkv, s, hd) views (head-major, not copied).  ``partial``: the
    heads are one rank's share of a split over ``model``, and y is their
    float32 share of the output projection (``common.out_proj``)."""
    b, s, _ = x.shape
    q, k, v = _gqa_qkv(p, cfg, x, cos, sin)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out = ops.flash_attention(qh, kh, vh, causal=causal,
                              window=resolve_window(cfg, kind),
                              softcap=cfg.logit_softcap,
                              scale=cfg.attn_scale or None)
    y = out.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return out_proj(y, p["wo"], partial), {"k": kh, "v": vh}


def gqa_decode(p, cfg: ModelConfig, x, cos, sin, cache: Dict,
               pos: torch.Tensor, *, kind: str = "attn",
               partial: bool = False) -> torch.Tensor:
    """Single-token GQA decode.

    x: (b, 1, d); cache["k"/"v"]: (b, hkv, S, hd); pos: (b,) — per-row count
    of tokens already cached, so row i's new K/V land at slot ``pos[i]`` and
    it attends ``pos[i] + 1`` entries, the last ``window`` of them where the
    layer has one.

    A windowed layer whose cache has exactly ``window`` slots runs in
    ring-buffer mode, as in the JAX package: row i's new K/V land at slot
    ``pos[i] % window`` and it attends ``min(pos[i] + 1, window)`` slots
    with no window mask (softmax does not depend on the slots' order), so
    decode memory stays O(window).

    The cache is updated IN PLACE (the JAX package builds a new array with
    ``.at[rows, :, slot].set``); callers that need the old cache copy it.
    ``partial`` as ``gqa_full``'s.
    """
    window = resolve_window(cfg, kind)
    if window > 0 and cache["k"].shape[2] == window:
        slot = pos % window
        valid = torch.clamp(pos + 1, max=window)
        window = 0                          # the ring already enforces it
    else:
        slot, valid = pos, pos + 1
    b = x.shape[0]
    q, k, v = _gqa_qkv(p, cfg, x, cos, sin)
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, :, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, :, slot] = v[:, 0].to(cache["v"].dtype)
    out = ops.decode_attention(q.transpose(1, 2), cache["k"], cache["v"],
                               valid, window=window,
                               softcap=cfg.logit_softcap,
                               scale=cfg.attn_scale or None)
    y = out.transpose(1, 2).reshape(b, 1, cfg.num_heads * cfg.resolved_head_dim)
    return out_proj(y, p["wo"], partial)


def gqa_decode_paged(p, cfg: ModelConfig, x, cos, sin, cache: Dict,
                     pos: torch.Tensor, table: torch.Tensor, spec,
                     partial: bool = False) -> torch.Tensor:
    """Single-token GQA decode against a block-paged cache.

    cache["k"/"v"]: (n_pages + 1, hkv, page_size, hd) physical pages shared
    by the whole batch; ``table``: (b, W) int32 page table; ``spec``: a
    ``kv_pool.PagedSpec`` (page_size, kv_cap).  Row i's new K/V go to slot
    ``pos[i] % page_size`` of page ``table[i, min(pos[i] // page_size, W -
    1)]``.  The clamp only fires for retired and done rows, whose tables
    point at the trash page: their PAD writes collide there, so the scatter
    is a plain index assignment that tolerates duplicate indices (which of
    them wins is irrelevant — the trash page is never read unmasked for a
    live row).  Written IN PLACE, as ``gqa_decode``; ``partial`` as
    ``gqa_full``'s.
    """
    b = x.shape[0]
    q, k, v = _gqa_qkv(p, cfg, x, cos, sin)
    lp = torch.clamp(pos // spec.page_size, max=table.shape[1] - 1)
    rows = torch.arange(b, device=x.device)
    pid = table[rows, lp].long()
    slot = pos % spec.page_size
    cache["k"][pid, :, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][pid, :, slot] = v[:, 0].to(cache["v"].dtype)
    out = ops.paged_decode_attention(
        q.transpose(1, 2), cache["k"], cache["v"], pos + 1, table,
        page_size=spec.page_size, kv_cap=spec.kv_cap,
        softcap=cfg.logit_softcap, scale=cfg.attn_scale or None)
    y = out.transpose(1, 2).reshape(b, 1, cfg.num_heads * cfg.resolved_head_dim)
    return out_proj(y, p["wo"], partial)


def init_cross(generator: torch.Generator, cfg: ModelConfig, *, device,
               dtype) -> Dict:
    d, hq, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    return {name: dense_init(shape, generator, device=device, dtype=dtype)
            for name, shape in (("wq", (d, hq * hd)), ("wk", (d, hq * hd)),
                                ("wv", (d, hq * hd)), ("wo", (hq * hd, d)))}


def cross_kv(p, cfg: ModelConfig, enc_out: torch.Tensor) -> Dict:
    """Project the encoder output once: {"ck", "cv"} as (b, hq, enc_seq,
    hd) views of the (b, enc_seq, hq * hd) projections, cached for the whole
    decode (hq ``cfg``'s heads: a rank's share under a split over
    ``model``).  An encoder output in another dtype than the weights
    (float32 stubs in a bf16 model) projects in the promoted dtype, as in
    JAX."""
    b, se, _ = enc_out.shape
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    k = promoted_matmul(enc_out, p["wk"]).reshape(b, se, hq, hd)
    v = promoted_matmul(enc_out, p["wv"]).reshape(b, se, hq, hd)
    return {"ck": k.transpose(1, 2), "cv": v.transpose(1, 2)}


def init_mla(generator: torch.Generator, cfg: ModelConfig, *, device,
             dtype) -> Dict:
    d, h = cfg.d_model, cfg.num_heads
    nope, rdim, vdim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    lora = cfg.kv_lora_rank
    p = {name: dense_init(shape, generator, device=device, dtype=dtype)
         for name, shape in (("wq", (d, h * (nope + rdim))),
                             ("w_dkv", (d, lora + rdim)))}
    p["kv_norm"] = init_rmsnorm(lora, device=device, dtype=dtype)
    for name, shape in (("w_uk", (lora, h * nope)),
                        ("w_uv", (lora, h * vdim)), ("wo", (h * vdim, d))):
        p[name] = dense_init(shape, generator, device=device, dtype=dtype)
    return p


def _mla_q(p, cfg: ModelConfig, x, cos, sin):
    """(q_nope (b, s, h, nope), q_rope (b, s, h, rope) rotated)."""
    b, s, _ = x.shape
    nope = cfg.qk_nope_head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads,
                              nope + cfg.qk_rope_head_dim)
    return q[..., :nope], rope_mod.apply_rope(q[..., nope:], cos, sin)


def _mla_compress(p, cfg: ModelConfig, x, cos, sin):
    """The latent of x: (c_kv (b, s, lora) normalized, k_rope (b, s, rope)
    rotated as one head)."""
    lora = cfg.kv_lora_rank
    dkv = x @ p["w_dkv"]
    c_kv = rmsnorm(p["kv_norm"], dkv[..., :lora], cfg.rmsnorm_eps)
    k_rope = rope_mod.apply_rope(dkv[..., lora:][:, :, None], cos, sin)
    return c_kv, k_rope[:, :, 0]


def mla_full(p, cfg: ModelConfig, x, cos, sin, *, kind: str = "mla",
             causal: bool = True, partial: bool = False
             ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence MLA in the up-projected form (train and prefill):
    q and k of head dim nope + rope, v of ``v_head_dim``, one flash call.
    Returns (y, {"c_kv", "k_rope"}), the latent cache of the sequence.
    ``partial``: the heads are one rank's share of a split over ``model``
    (the latent whole), and y is their float32 share of the output
    projection (``common.out_proj``)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    nope, rdim, vdim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    q_nope, q_rope = _mla_q(p, cfg, x, cos, sin)
    c_kv, k_rope = _mla_compress(p, cfg, x, cos, sin)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, nope)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, vdim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, rdim)], -1)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              scale=(nope + rdim) ** -0.5,
                              window=resolve_window(cfg, kind),
                              softcap=cfg.logit_softcap)
    y = out.transpose(1, 2).reshape(b, s, h * vdim)
    return out_proj(y, p["wo"], partial), {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(p, cfg: ModelConfig, x, cos, sin, cache: Dict,
               pos: torch.Tensor, *, kind: str = "mla",
               partial: bool = False) -> torch.Tensor:
    """Absorbed-form MLA decode: attention runs in the latent space.

    cache: {"c_kv": (b, S, lora), "k_rope": (b, S, rope)}; pos: (b,) — row
    i's new latent lands at slot ``pos[i]`` (written IN PLACE, as
    ``gqa_decode``) and it attends slots 0..pos[i].  ``w_uk`` is folded
    into the query and ``w_uv`` into the output, all in float32; the
    heads' context is cast to the model dtype before ``wo``.  ``partial``
    as ``mla_full``'s: the rank's heads attend the whole latent cache."""
    b = x.shape[0]
    h = cfg.num_heads
    nope, rdim, vdim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    lora = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(p, cfg, x, cos, sin)
    c_new, r_new = _mla_compress(p, cfg, x, cos, sin)
    rows = torch.arange(b, device=x.device)
    ckv, krope = cache["c_kv"], cache["k_rope"]
    ckv[rows, pos] = c_new[:, 0].to(ckv.dtype)
    krope[rows, pos] = r_new[:, 0].to(krope.dtype)
    w_uk = p["w_uk"].reshape(lora, h, nope).float()
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope[:, 0].float(), w_uk)
    scale = (nope + rdim) ** -0.5
    ckv32 = ckv.float()
    s = (torch.einsum("bhl,bsl->bhs", q_lat, ckv32) * scale
         + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(), krope.float())
         * scale)
    if cfg.logit_softcap > 0.0:
        s = cfg.logit_softcap * torch.tanh(s / cfg.logit_softcap)
    kpos = torch.arange(ckv.shape[1], device=x.device)[None, None]
    mask = kpos <= pos[:, None, None]
    window = resolve_window(cfg, kind)
    if window > 0:
        mask = mask & (kpos > pos[:, None, None] - window)
    probs = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    ctx = torch.einsum("bhs,bsl->bhl", probs, ckv32)
    w_uv = p["w_uv"].reshape(lora, h, vdim).float()
    v_ctx = torch.einsum("bhl,lhv->bhv", ctx, w_uv)
    return out_proj(v_ctx.reshape(b, 1, h * vdim).to(x.dtype), p["wo"],
                    partial)


def cross_attend(p, cfg: ModelConfig, x: torch.Tensor, kv: Dict, *,
                 partial: bool = False) -> torch.Tensor:
    """x: (b, s, d) attends every cached encoder position (no mask) ->
    (b, s, d); s = 1 in decode.  ``partial`` as ``gqa_full``'s: ``cfg``'s
    heads are one rank's share, and ``kv`` holds them."""
    b, s, _ = x.shape
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, hq, hd).transpose(1, 2)
    out = ops.flash_attention(q, kv["ck"], kv["cv"], causal=False)
    return out_proj(out.transpose(1, 2).reshape(b, s, hq * hd), p["wo"],
                    partial)
