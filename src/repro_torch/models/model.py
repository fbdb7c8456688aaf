"""Top-level model API of the estimator backbones: the dense GQA stacks
(gemma2's local / global one included), the pure-SSM Mamba2 stack, the
zamba2 hybrid, the multimodal-stub backbones: Qwen2-VL's (M-RoPE,
projected patch embeddings) and whisper's encoder-decoder, and the
mixture-of-experts stacks: Qwen3-MoE (GQA + MoE) and DeepSeek-V2 (MLA,
shared + routed experts, a dense first layer).

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
for a mamba layer, ``{"<j>": {"c_kv", "k_rope"}}`` of shape (L, b, S,
kv_lora_rank) and (L, b, S, qk_rope_head_dim) for an MLA layer (no ring
buffer, no window).  An MLA stack rotates ``qk_rope_head_dim`` dims of
its queries and its shared key head.  gemma2 scales its embeddings by sqrt(d_model) (the
factor rounded to the model dtype first, as the reference does) and softcaps
its logits in float32, so its prefill and decode logits are float32; every
other stack's are in the model dtype.

Batch keys, as the reference's ``_forward_full`` reads them: "tokens" (b,
s) int; optional "labels" (b, s) (-100 = ignore); "enc_features" (b,
enc_seq, d), the encoder-decoder's stub frame embeddings (required there);
"image_embeds" (b, P, d), a VLM's stub patch embeddings, which replace the
first P positions of the token embeddings after ``vision_proj`` (so s >= P);
"positions_3d" (3, b, s) int, M-RoPE's (t, h, w) position streams (default:
text positions, all three equal).  Stubs come in the model dtype; float32
stubs with bf16 weights compute in float32 where JAX promotes (the patch
projection, the encoder, the cross K/V).  An encoder-decoder's params add
``encoder`` ({"frontend_proj", "segments", "final_norm"}) and its decoder
blocks ``cross_norm`` / ``cross``; its caches add ``ck`` / ``cv`` (L, b,
hq, enc_seq, hd), which decode reads and never grows.  A VLM's params add
``vision_proj`` (d, d).

Every entry point also takes params sharded over a device mesh
(``ReasoningEstimator.shard``: DTensors placed per
``distributed.sharding.param_specs``).  A rank then gathers each layer over
``data`` just before it runs and computes its own heads (GQA and MLA
attention, Mamba's SSD) and MLP columns where ``collectives.model_split``
splits them (a split Mamba layer's caches hold its channels and heads, a
split MLA layer's the whole latent, written alike on every rank along
``model``); MoE experts are gathered whole over ``model``; the vocabulary
splits too, and the logits come back whole on every rank (the local slice all-gathered
along the last dim: (b, s, V) a rank, as one process holds).  ``loss_fn``
(and GRPO's loss) computes this rank's rows of the batch (``local_batch``)
and returns the whole batch's loss on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.io import tree_map
from repro_torch.models import rope as rope_mod
from repro_torch.models import transformer as tf
from repro_torch.models.attention import resolve_window
from repro_torch.models.common import (
    dense_init, dtype_of, embed_init, init_rmsnorm, promoted_matmul, rmsnorm,
    sinusoid_at, sinusoidal_positions, softcap)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``, with
    the JAX initializers' distributions and dtypes.  JAX casts every float32
    leaf of rank >= 2 to ``cfg.dtype`` after stacking, so the embedding and
    every per-layer leaf (projections, norm scales, and a mamba layer's conv
    weights and bias, ``A_log``, ``D`` and ``dt_bias``) are made in
    ``cfg.dtype``, and so are the encoder's ``frontend_proj`` and stacked
    layers and ``vision_proj``; the final norm scales (the encoder's too)
    and the unstacked shared block's norm scales stay float32.  Untied
    heads are not supported.  On ``device="meta"`` nothing is drawn and
    nothing allocated: the same code gives every leaf's shape and dtype
    (``launch.specs.abstract_params``)."""
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied LM heads are not ported yet")
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dt = dtype_of(cfg.dtype)
    plan = tf.build_plan(cfg)
    segments = tuple(tf.init_segment(gen, cfg, unit, count, device=dev,
                                     dtype=dt, cross=cfg.is_encoder_decoder)
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
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "frontend_proj": dense_init((cfg.d_model, cfg.d_model), gen,
                                        device=dev, dtype=dt),
            "segments": (tf.init_segment(gen, cfg, ("attn",),
                                         cfg.num_encoder_layers, device=dev,
                                         dtype=dt),),
            "final_norm": init_rmsnorm(cfg.d_model, device=dev)}
    if cfg.num_stub_patches > 0:
        params["vision_proj"] = dense_init((cfg.d_model, cfg.d_model), gen,
                                           device=dev, dtype=dt)
    return params


def _top(tree, lay):
    """An unstacked leaf (or dict of them) as plain tensors, gathered whole
    when sharded."""
    return tree if lay is None else lay.tree(tree)


def _lookup(params, cfg: ModelConfig, tokens: torch.Tensor,
            lay=None) -> torch.Tensor:
    """Embedding rows, times sqrt(d_model) under ``scale_embeddings``: the
    factor is rounded to the embedding's dtype before the product (the
    reference's ``jnp.asarray(d ** 0.5, h.dtype)``; sqrt(3584) is 59.75 in
    bfloat16).  Sharded, the lookup is ``Layout.lookup``'s."""
    h = (params["embed"][tokens] if lay is None
         else lay.lookup(params["embed"], tokens))
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype).item()
    return h


def _sinusoid_positions(cfg: ModelConfig) -> bool:
    """Whether the stack adds sinusoid positions (no RoPE, and attention)."""
    return cfg.rope_kind == "none" and not cfg.is_attention_free()


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           batch: Optional[Dict] = None, lay=None) -> torch.Tensor:
    """The full sequence's input: ``_lookup``, plus the sinusoid table of
    positions 0..s-1 in the embedding's dtype under ``rope_kind="none"``;
    a VLM's first P positions replaced by ``batch["image_embeds"] @
    vision_proj`` (computed in the promoted dtype, then cast)."""
    h = _lookup(params, cfg, tokens, lay)
    if _sinusoid_positions(cfg):
        h = h + sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                     device=h.device, dtype=h.dtype)[None]
    if cfg.num_stub_patches > 0 and batch and "image_embeds" in batch:
        img = promoted_matmul(batch["image_embeds"],
                              _top(params["vision_proj"], lay))
        npatch = img.shape[1]
        if npatch > h.shape[1]:
            # the reference concatenates regardless and fails further on
            raise ValueError(f"{npatch} image patches do not fit a "
                             f"{h.shape[1]}-token sequence")
        h = torch.cat([img.to(h.dtype), h[:, npatch:]], dim=1)
    return h


def _logits(params, cfg: ModelConfig, h: torch.Tensor,
            lay=None) -> torch.Tensor:
    """Tied head: rmsnorm(h) @ embed.T, in the model dtype; under
    ``final_logit_softcap`` cast to float32 and softcapped, in place when
    no gradient is recorded (the same operations in the same order: at
    gemma2's vocabulary of 256000 a 32768-token row's float32 logits are
    33.5 GB, and the out-of-place form holds three of them at once).
    Sharded, the product is ``Layout.logits``'s: whole on every rank."""
    h = rmsnorm(_top(params["final_norm"], lay), h, cfg.rmsnorm_eps)
    logits = (h @ params["embed"].T if lay is None
              else lay.logits(params["embed"], h))
    cap = cfg.final_logit_softcap
    if cap > 0.0:
        logits = logits.float()
        if torch.is_grad_enabled():
            return softcap(logits, cap)
        return logits.div_(cap).tanh_().mul_(cap)
    return logits


def _cos_sin(cfg: ModelConfig, pos: torch.Tensor, pos3=None):
    """RoPE tables at ``pos`` (b, s); none under ``rope_kind="none"``, and
    none for a stack with no attention at all (whose ``resolved_head_dim``
    would divide by its zero heads): the hybrid's layer kinds are all
    ``mamba``, but its shared block rotates.  M-RoPE takes the (3, b, s)
    streams ``pos3``, text positions (``pos`` on all three) when None;
    decode always passes None, so it rotates by the cache index on every
    stream, as the reference does."""
    if cfg.rope_kind == "none" or (cfg.is_attention_free()
                                   and cfg.shared_attn_every == 0):
        return None, None
    dim = cfg.qk_rope_head_dim if cfg.has_mla() else cfg.resolved_head_dim
    if cfg.rope_kind == "mrope":
        if pos3 is None:
            pos3 = rope_mod.text_positions_3d(pos)
        return rope_mod.mrope_cos_sin(pos3, dim, cfg.rope_theta,
                                      cfg.mrope_sections)
    return rope_mod.rope_cos_sin(pos, dim, cfg.rope_theta)


def _encode(params, cfg: ModelConfig, enc_features: torch.Tensor, *,
            remat: bool = True, lay=None) -> torch.Tensor:
    """The whisper-style encoder over stub frame embeddings (b, enc_seq,
    d): ``frontend_proj``, the sinusoid table, the non-causal stack, the
    final norm.  Frames in another dtype than the weights (float32 stubs,
    bf16 model) run the whole encoder in the promoted dtype, as JAX's
    promotion does: the weights are upcast, exactly."""
    enc = params["encoder"]
    proj = _top(enc["frontend_proj"], lay)
    h = promoted_matmul(enc_features, proj)
    h = h + sinusoidal_positions(h.shape[1], cfg.d_model, device=h.device,
                                 dtype=h.dtype)[None]
    seg = enc["segments"][0]
    if h.dtype != proj.dtype:
        seg = tree_map(lambda t: t.to(torch.promote_types(t.dtype, h.dtype)),
                       seg)
    h, _, _ = tf.segment_full(seg, None, cfg, ("attn",),
                              cfg.num_encoder_layers, h, None, None,
                              causal=False, remat=remat, want_cache=False,
                              lay=lay)
    return rmsnorm(_top(enc["final_norm"], lay), h, cfg.rmsnorm_eps)


def _forward_full(params, cfg: ModelConfig, batch: Dict, *,
                  want_cache: bool, remat: bool = True, lay=None):
    """(logits, aux, caches) of the full sequence: ``aux`` the summed MoE
    load-balance losses (0 without MoE), ``caches`` () without
    ``want_cache``.  ``lay`` (a ``collectives.Layout``) runs sharded
    params; None takes the params' own (rows not split)."""
    if lay is None:
        lay = coll.layout(params, cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = _embed(params, cfg, tokens, batch, lay)
    cos, sin = _cos_sin(cfg, torch.arange(s, device=tokens.device)
                        .expand(b, s), batch.get("positions_3d"))
    enc_out = (_encode(params, cfg, batch["enc_features"], remat=remat,
                       lay=lay)
               if cfg.is_encoder_decoder else None)
    caches = []
    aux = h.new_zeros((), dtype=torch.float32)
    for seg, (unit, count) in zip(params["segments"], tf.build_plan(cfg),
                                  strict=True):
        h, a, cache = tf.segment_full(seg, params.get("shared_attn"), cfg,
                                      unit, count, h, cos, sin,
                                      enc_out=enc_out, remat=remat,
                                      want_cache=want_cache, lay=lay)
        aux = aux + a
        caches.append(cache)
    return (_logits(params, cfg, h, lay), aux,
            tuple(caches) if want_cache else ())


def forward_train(params, cfg: ModelConfig, batch: Dict, *,
                  remat: bool = True, lay=None):
    """The full forward over ``batch`` (the keys above) with no caches:
    (logits (b, s, V) in the model dtype, or float32 under a final softcap,
    aux).  Each layer is one checkpoint when ``remat`` (the reference's
    default); ``aux`` is the sum of the MoE layers' load-balance losses
    (float32; 0 for a stack without MoE).  On the card the attention (the
    hybrid's tied block, the encoder and the cross-attention included)
    runs the flash forward and backward kernels, and a mamba layer's SSD
    runs the scan kernel forward and ``csrc/ssd_scan_bwd.cu`` backward
    (``kernels.ssd_scan.SSDScan``).  MLA's flash call (q, k of nope + rope,
    v of ``v_head_dim``, its scale passed explicitly) takes the backward
    kernel at those head dims too.  ``lay`` as ``_forward_full``'s
    (``local_batch`` gives it with this rank's rows)."""
    logits, aux, _ = _forward_full(params, cfg, batch, want_cache=False,
                                   remat=remat, lay=lay)
    return logits, aux


def local_batch(params, cfg: ModelConfig, batch: Dict):
    """(batch, lay) for a per-token loss on ``params``: on sharded params
    this rank's ``collectives.train_rows`` of every (b, ...) column of
    ``batch`` (``positions_3d`` (3, b, s) by its second dim) and a layout
    with the rows split, or the whole batch and the params' own layout
    where every rank computes every row; (batch, None) on plain params."""
    lay = coll.layout(params, cfg)
    if lay is None:
        return batch, None
    b, s = batch["tokens"].shape
    rows = coll.train_rows(lay.mesh, cfg, b, s)
    if rows is None:
        return batch, lay
    return ({k: v[:, rows] if k == "positions_3d" else v[rows]
             for k, v in batch.items()},
            coll.layout(params, cfg, rows_split=True))


def loss_fn(params, cfg: ModelConfig, batch: Dict, *, remat: bool = True):
    """Masked next-token cross-entropy in float32 over the full vocabulary,
    plus ``router_aux_coef`` times the MoE load-balance loss: (loss, {"ce",
    "aux", "acc"}).  ``batch["labels"]`` (b, s), -100 = ignore;
    without labels, position t predicts token t + 1 and the last position
    is ignored.

    On sharded params a rank computes its ``collectives.train_rows`` of
    the batch (``local_batch``), each rank's share of the cross-entropy is
    divided by the count of labelled tokens over the whole batch, and the
    shares are summed over ``data`` (backward: each rank differentiates
    its own); a MoE's load-balance loss is the whole batch's
    (``moe.moe_forward``): the loss and metrics are the whole batch's on
    every rank."""
    batch, lay = local_batch(params, cfg, batch)
    logits, aux, _ = _forward_full(params, cfg, batch, want_cache=False,
                                   remat=remat, lay=lay)
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
    count = mask.sum() if lay is None else lay.summed(mask.sum())
    denom = torch.clamp(count, min=1).float()
    ce = torch.sum(nll * maskf) / denom
    acc = torch.sum((torch.argmax(logits, -1) == safe).float() * maskf) / denom
    if lay is not None:
        ce, acc = lay.total(ce), lay.summed(acc)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux, "acc": acc}


def prefill(params, cfg: ModelConfig, batch: Dict):
    """The full forward over ``batch`` (the keys above); returns the logits
    and per-layer caches: K/V (or an MLA layer's latent) sized to the
    prompt (seq axis = s), a mamba layer's conv window and final SSM
    state, a cross block's ck / cv.  An encoder-decoder needs
    ``batch["enc_features"]`` (KeyError without it, as in the
    reference)."""
    logits, _, caches = _forward_full(params, cfg, batch, want_cache=True)
    return logits, caches


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, caches,
                pos: torch.Tensor, paged=None):
    """token: (b, 1) int; pos: (b,) int — per-row count of tokens already
    cached (row i's new token lands at absolute position pos[i]).
    ``paged`` = (``kv_pool.PagedSpec``, (b, W) int32 page table) when the
    caches are block-paged storage (n_pages + 1, hkv, page, hd) per layer.
    Under ``rope_kind="none"`` the token's embedding gets the sinusoid row
    of its position; M-RoPE rotates by ``pos`` on all three streams.

    Returns (logits (b, 1, V), caches).  The caches are written in place
    and returned as the same objects (JAX returns new arrays)."""
    b = token.shape[0]
    pos = pos.reshape(-1).expand(b)
    lay = coll.layout(params, cfg)
    h = _lookup(params, cfg, token, lay)
    if _sinusoid_positions(cfg):
        h = h + sinusoid_at(pos, cfg.d_model).to(h.dtype)[:, None]
    cos, sin = _cos_sin(cfg, pos[:, None])
    for seg, cache, (unit, count) in zip(params["segments"], caches,
                                         tf.build_plan(cfg), strict=True):
        h = tf.segment_decode(seg, params.get("shared_attn"), cfg, unit,
                              count, h, cos, sin, cache, pos, paged, lay=lay)
    return _logits(params, cfg, h, lay), caches


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device: DeviceLike = None):
    """Zeroed caches shaped for ``decode_step``.  As in the JAX package, a
    windowed attention layer's K/V get ``min(max_len, window)`` slots (at
    exactly ``window`` slots its decode is the ring buffer), and an
    encoder-decoder's attention layers add zero ``ck`` / ``cv`` (L, b, hq,
    enc_seq, hd).  An MLA layer's latent caches hold ``max_len`` slots,
    never a ring."""
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
        hd = cfg.resolved_head_dim
        if tf.is_mla(kind):
            leaves = {"c_kv": ((count, batch_size, max_len,
                                cfg.kv_lora_rank), dt),
                      "k_rope": ((count, batch_size, max_len,
                                  cfg.qk_rope_head_dim), dt)}
        else:
            w = resolve_window(cfg, kind)
            shape = (count, batch_size, cfg.num_kv_heads,
                     min(max_len, w) if w > 0 else max_len, hd)
            leaves = {"k": (shape, dt), "v": (shape, dt)}
        if cfg.is_encoder_decoder:
            cross = (count, batch_size, cfg.num_heads, cfg.encoder_seq_len,
                     hd)
            leaves.update(ck=(cross, dt), cv=(cross, dt))
        return leaves

    return tuple(
        {str(j): {name: torch.zeros(shape, dtype=dtype, device=dev)
                  for name, (shape, dtype) in spec(
                      "attn" if kind == "shared_attn" else kind,
                      count).items()}
         for j, kind in enumerate(unit)}
        for unit, count in tf.build_plan(cfg))
