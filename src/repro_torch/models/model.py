"""Top-level model API of the estimator backbones: the dense GQA stacks
(gemma2's local / global one included), the pure-SSM Mamba2 stack and the
zamba2 hybrid.

  init_params(cfg, *, seed, device)          -> params dict
  forward_train(params, cfg, batch)          -> (logits (b, s, V), aux)
  loss_fn(params, cfg, batch)                -> (loss, metrics)
  prefill(params, cfg, batch)                -> (logits (b, s, V), caches)
  decode_step(params, cfg, token, caches, pos, paged=None)
                                             -> (logits (b, 1, V), caches)
  init_cache(cfg, batch_size, max_len, device) -> zeroed caches

The params dict has the JAX pytree's layout: ``embed`` (V, d),
``final_norm.scale`` (d,), ``segments``, a tuple with one dict per segment
of (L, ...) stacked layer leaves, and for the hybrid ``shared_attn``, the
one unstacked attention + MLP block every ``shared_attn`` position runs.
Caches are a tuple with one dict per segment, ``{"<j>": {"k", "v"}}`` of
shape (L, b, hkv, S, hd) for an attention layer (a shared block's: one per
occurrence), ``{"<j>": {"conv", "ssm"}}`` of shape (L, b, width - 1,
d_inner + 2 n) in the model dtype and (L, b, heads, head_dim, n) in float32
for a mamba layer.  gemma2 scales its embeddings by sqrt(d_model) (the
factor rounded to the model dtype first, as the reference does) and softcaps
its logits in float32, so its prefill and decode logits are float32; every
other stack's are in the model dtype.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.io import tree_map
from repro_torch.models import rope as rope_mod
from repro_torch.models import transformer as tf
from repro_torch.models.attention import resolve_window
from repro_torch.models.common import (
    dtype_of, embed_init, init_rmsnorm, rmsnorm, softcap)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``, with
    the JAX initializers' distributions and dtypes.  JAX casts every float32
    leaf of rank >= 2 to ``cfg.dtype`` after stacking, so the embedding and
    every per-layer leaf (projections, norm scales, and a mamba layer's conv
    weights and bias, ``A_log``, ``D`` and ``dt_bias``) are made in
    ``cfg.dtype``; the final norm scale and the unstacked shared block's
    norm scales stay float32.  Untied heads are not supported."""
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied LM heads are not ported yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype_of(cfg.dtype)
    plan = tf.build_plan(cfg)
    segments = tuple(tf.init_segment(gen, cfg, unit, count, device=dev,
                                     dtype=dt)
                     for unit, count in plan)
    shared = None
    if any("shared_attn" in unit for unit, _ in plan):
        shared = tree_map(
            lambda t: t.to(dt) if t.dim() >= 2 else t,
            tf.init_block(gen, cfg, "attn", device=dev, dtype=torch.float32))
    params = {"embed": embed_init((cfg.vocab_size, cfg.d_model), gen,
                                  device=dev, dtype=dt),
              "final_norm": init_rmsnorm(cfg.d_model, device=dev),
              "segments": segments}
    if shared is not None:
        params["shared_attn"] = shared
    return params


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows, times sqrt(d_model) under ``scale_embeddings``: the
    factor is rounded to the embedding's dtype before the product (the
    reference's ``jnp.asarray(d ** 0.5, h.dtype)``; sqrt(3584) is 59.75 in
    bfloat16)."""
    h = params["embed"][tokens]
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype).item()
    return h


def _logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Tied head: rmsnorm(h) @ embed.T, in the model dtype; under
    ``final_logit_softcap`` cast to float32 and softcapped."""
    h = rmsnorm(params["final_norm"], h, cfg.rmsnorm_eps)
    logits = h @ params["embed"].T
    if cfg.final_logit_softcap > 0.0:
        logits = softcap(logits.float(), cfg.final_logit_softcap)
    return logits


def _cos_sin(cfg: ModelConfig, pos: torch.Tensor):
    """RoPE tables at ``pos``; none for a stack with no attention at all
    (whose ``resolved_head_dim`` would divide by its zero heads): the
    hybrid's layer kinds are all ``mamba``, but its shared block rotates."""
    if cfg.is_attention_free() and cfg.shared_attn_every == 0:
        return None, None
    return rope_mod.rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)


def forward_train(params, cfg: ModelConfig, batch: Dict, *,
                  remat: bool = True):
    """Full causal forward over ``batch["tokens"]`` (b, s) with no caches:
    (logits (b, s, V) in the model dtype, or float32 under a final softcap,
    aux).  Each layer is one checkpoint when ``remat`` (the reference's
    default); ``aux`` (the MoE router loss in the reference) is 0 for
    every stack, dense, pure-SSM and hybrid.  On the card the attention
    (the hybrid's tied block included) runs the flash forward and backward
    kernels, and a mamba layer's SSD runs the scan kernel forward and
    ``csrc/ssd_scan_bwd.cu`` backward (``kernels.ssd_scan.SSDScan``)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = _embed(params, cfg, tokens)
    cos, sin = _cos_sin(cfg, torch.arange(s, device=tokens.device)
                        .expand(b, s))
    for seg, (unit, count) in zip(params["segments"], tf.build_plan(cfg),
                                  strict=True):
        h, _ = tf.segment_full(seg, params.get("shared_attn"), cfg, unit,
                               count, h, cos, sin, remat=remat,
                               want_cache=False)
    return _logits(params, cfg, h), torch.zeros((), device=tokens.device)


def loss_fn(params, cfg: ModelConfig, batch: Dict, *, remat: bool = True):
    """Masked next-token cross-entropy in float32 over the full vocabulary:
    (loss, {"ce", "aux", "acc"}).  ``batch["labels"]`` (b, s), -100 = ignore;
    without labels, position t predicts token t + 1 and the last position
    is ignored."""
    logits, aux = forward_train(params, cfg, batch, remat=remat)
    tokens = batch["tokens"]
    labels = batch.get("labels")
    if labels is None:
        labels = torch.cat([tokens[:, 1:],
                            torch.full_like(tokens[:, :1], -100)], dim=1)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    maskf = mask.float()
    denom = torch.clamp(mask.sum(), min=1).float()
    ce = torch.sum(nll * maskf) / denom
    acc = torch.sum((torch.argmax(logits, -1) == safe).float() * maskf) / denom
    # the reference adds router_aux_coef * aux, and aux is 0 here
    return ce, {"ce": ce, "aux": aux, "acc": acc}


def prefill(params, cfg: ModelConfig, batch: Dict):
    """Full causal forward over ``batch["tokens"]`` (b, s); returns the
    logits and per-layer caches: K/V sized to the prompt (seq axis = s),
    a mamba layer's conv window and final SSM state."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = _embed(params, cfg, tokens)
    cos, sin = _cos_sin(cfg, torch.arange(s, device=tokens.device)
                        .expand(b, s))
    caches = []
    for seg, (unit, count) in zip(params["segments"], tf.build_plan(cfg),
                                  strict=True):
        h, cache = tf.segment_full(seg, params.get("shared_attn"), cfg,
                                   unit, count, h, cos, sin)
        caches.append(cache)
    return _logits(params, cfg, h), tuple(caches)


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, caches,
                pos: torch.Tensor, paged=None):
    """token: (b, 1) int; pos: (b,) int — per-row count of tokens already
    cached (row i's new token lands at absolute position pos[i]).
    ``paged`` = (``kv_pool.PagedSpec``, (b, W) int32 page table) when the
    caches are block-paged storage (n_pages + 1, hkv, page, hd) per layer.

    Returns (logits (b, 1, V), caches).  The caches are written in place
    and returned as the same objects (JAX returns new arrays)."""
    b = token.shape[0]
    pos = pos.reshape(-1).expand(b)
    h = _embed(params, cfg, token)
    cos, sin = _cos_sin(cfg, pos[:, None])
    for seg, cache, (unit, count) in zip(params["segments"], caches,
                                         tf.build_plan(cfg), strict=True):
        h = tf.segment_decode(seg, params.get("shared_attn"), cfg, unit,
                              count, h, cos, sin, cache, pos, paged)
    return _logits(params, cfg, h), caches


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device: DeviceLike = None):
    """Zeroed caches shaped for ``decode_step``.  As in the JAX package, a
    windowed attention layer's K/V get ``min(max_len, window)`` slots (at
    exactly ``window`` slots its decode is the ring buffer)."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)

    def spec(kind: str, count: int):
        """(shape, dtype) of each cache leaf of a ``kind`` layer stack."""
        if kind == "mamba":
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            return {"conv": ((count, batch_size, cfg.ssm_conv_width - 1,
                              conv_dim), dt),
                    "ssm": ((count, batch_size, cfg.resolved_ssm_heads,
                             cfg.ssm_head_dim, cfg.ssm_state), torch.float32)}
        w = resolve_window(cfg, kind)
        shape = (count, batch_size, cfg.num_kv_heads,
                 min(max_len, w) if w > 0 else max_len, cfg.resolved_head_dim)
        return {"k": (shape, dt), "v": (shape, dt)}

    return tuple(
        {str(j): {name: torch.zeros(shape, dtype=dtype, device=dev)
                  for name, (shape, dtype) in spec(
                      "attn" if kind == "shared_attn" else kind,
                      count).items()}
         for j, kind in enumerate(unit)}
        for unit, count in tf.build_plan(cfg))
