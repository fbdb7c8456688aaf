"""Decoder and encoder stacks: the ``attn``, ``attn_local``, ``mla``,
``moe``, ``mla_moe`` and ``mamba`` block kinds, the zamba2 hybrid's
``shared_attn``, whisper's cross-attention, and a loop over stacked layers.

As in the JAX package, layers are grouped into segments of a repeated unit
whose parameters are stacked on a leading layer axis (gemma2: one unit
``("attn_local", "attn")`` repeated); where JAX scans the unit body, the
port runs a Python loop over the stack.  Each pass unbinds each stacked
leaf once (layer ``i`` reads the ``i``-th view), so under autograd the
gradient of a stack is stacked once, not summed from a zero-filled stack
per layer; decode reads its caches' views ``leaf[i]``.  An
attention layer caches {"k", "v"}, a ``mamba`` layer {"conv", "ssm"},
each leaf stacked per segment.  Under ``sandwich_norm`` (gemma2) an
attention block also normalizes the attention and MLP outputs before each
residual add (``post_attn_norm``, ``post_mlp_norm``).

zamba2's unit is ``("mamba",) * k + ("shared_attn",)``: the ``shared_attn``
position holds no parameters of its own but runs the model-level
``params["shared_attn"]`` attention block (one tied set at every
occurrence), while its K/V caches are per occurrence, stacked under the
unit's key like any other layer's.

An encoder-decoder's decoder blocks (``init_block(..., cross=True)``) hold
``cross_norm`` and ``cross`` besides: after self-attention, the block
attends the encoder output (``enc_out``, projected once into ``ck`` /
``cv``, which join the layer's cache) and adds the result before the MLP.
The encoder runs the same stack non-causally (``causal=False``).

On params sharded over a device mesh (``distributed.collectives``) the
stacked leaves are DTensors: a rank unbinds its local block of each, and a
layer's pieces are gathered (``Layout.block``) just before the layer runs,
inside its checkpoint under ``remat``, so the backward gathers again and no
layer stays whole after it ran.  A block that splits over ``model`` runs
its attention on its own heads (a config of the local head counts), its
MLP on its own columns and a Mamba layer on its own SSD heads, and sums
their outputs over ``model``; a split MLA layer attends with its own heads
and keeps the whole latent caches, the same on every rank along ``model``;
a split decoder block's cross-attention projects and caches its own heads'
``ck`` / ``cv`` and attends with them, its output summed over ``model``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import init_rmsnorm, rmsnorm


def build_plan(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(unit_kinds, count), ...]: for an SSM stack with shared attention,
    ``shared_attn_every`` mambas and the shared block as one unit, then the
    remaining mambas; for a pattern of several kinds that fills the stack
    a whole number of times, the pattern as one unit; otherwise consecutive
    identical kinds grouped, after the first ``first_dense_layers`` MoE
    layers became dense (deepseek-v2: ``[(("mla",), 1), (("mla_moe",),
    26)]``)."""
    if cfg.has_ssm() and cfg.shared_attn_every > 0:
        every = cfg.shared_attn_every
        full, rem = divmod(cfg.num_layers, every)
        plan = []
        if full:
            plan.append((("mamba",) * every + ("shared_attn",), full))
        if rem:
            plan.append((("mamba",), rem))
        return plan
    kinds = list(cfg.layer_kinds())
    for i in range(min(cfg.first_dense_layers, len(kinds))):
        kinds[i] = {"mla_moe": "mla", "moe": "attn"}.get(kinds[i], kinds[i])
    pat = tuple(cfg.block_pattern)
    # layer_kinds() repeats the pattern, so it fills the stack exactly when
    # the depth is a multiple of its length (and no first layer was made
    # dense)
    if (len(pat) > 1 and len(kinds) % len(pat) == 0
            and all(k == pat[i % len(pat)] for i, k in enumerate(kinds))):
        return [(pat, len(kinds) // len(pat))]
    plan = []
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        plan.append(((kinds[i],), j - i))
        i = j
    return plan


def is_mla(kind: str) -> bool:
    return kind in ("mla", "mla_moe")


def is_moe(kind: str) -> bool:
    return kind in ("moe", "mla_moe")


def init_block(generator: torch.Generator, cfg: ModelConfig, kind: str, *,
               device, dtype, cross: bool = False) -> Dict:
    d = cfg.d_model
    if kind == "mamba":
        return {"norm": init_rmsnorm(d, device=device, dtype=dtype),
                "mamba": ssm_mod.init_mamba(generator, cfg, device=device,
                                            dtype=dtype)}
    init_attn = attn_mod.init_mla if is_mla(kind) else attn_mod.init_gqa
    p = {"attn_norm": init_rmsnorm(d, device=device, dtype=dtype),
         "mlp_norm": init_rmsnorm(d, device=device, dtype=dtype),
         "attn": init_attn(generator, cfg, device=device, dtype=dtype)}
    if is_moe(kind):
        p["moe"] = moe_mod.init_moe(generator, cfg, device=device,
                                    dtype=dtype)
    else:
        p["mlp"] = mlp_mod.init_mlp(generator, cfg, device=device,
                                    dtype=dtype)
    if cfg.sandwich_norm:
        p["post_attn_norm"] = init_rmsnorm(d, device=device, dtype=dtype)
        p["post_mlp_norm"] = init_rmsnorm(d, device=device, dtype=dtype)
    if cross:
        p["cross_norm"] = init_rmsnorm(d, device=device, dtype=dtype)
        p["cross"] = attn_mod.init_cross(generator, cfg, device=device,
                                         dtype=dtype)
    return p


def init_segment(generator: torch.Generator, cfg: ModelConfig,
                 unit: Tuple[str, ...], count: int, *, device, dtype,
                 cross: bool = False) -> Dict:
    """Stacked per-unit params ``{"<j>": (count, ...) leaves}``;
    ``shared_attn`` positions hold none (the tied set lives at model
    level).  ``cross`` gives each block a cross-attention.  Each layer is
    made and copied into its slot of the stack in turn, so the stack and
    one layer are all that is ever held (a qwen3-moe layer is ~5 GB)."""
    seg = {}
    for j, kind in enumerate(unit):
        if kind == "shared_attn":
            continue
        stack = None
        for i in range(count):
            block = init_block(generator, cfg, kind, device=device,
                               dtype=dtype, cross=cross)
            if stack is None:
                stack = _empty_stack(block, count)
            _copy_layer(stack, block, i)
            del block
        seg[str(j)] = stack
    return seg


def _empty_stack(block: Dict, count: int) -> Dict:
    if isinstance(block, dict):
        return {k: _empty_stack(v, count) for k, v in block.items()}
    return block.new_empty((count, *block.shape))


def _copy_layer(stack: Dict, block: Dict, i: int) -> None:
    if isinstance(stack, dict):
        for k in stack:
            _copy_layer(stack[k], block[k], i)
    else:
        stack[i].copy_(block)


def stack_trees(trees: List[Dict]) -> Dict:
    """Per-layer dicts -> one dict of (L, ...) stacked leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def unbind_tree(tree: Dict) -> List[Dict]:
    """A stacked dict as per-layer dicts of views, each leaf unbound once
    (a sharded leaf's local block, as ``collectives.Block``s)."""
    if isinstance(tree, dict):
        per_key = {k: unbind_tree(v) for k, v in tree.items()}
        return [dict(zip(per_key, layer, strict=True)) for layer in
                zip(*per_key.values(), strict=True)]
    return coll.unstack(tree)


def layer_view(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked dict, as views (no copy)."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    return tree[i]


def _blocks(tree):
    """An unstacked dict with its sharded leaves as ``Block``s."""
    if isinstance(tree, dict):
        return {k: _blocks(v) for k, v in tree.items()}
    return coll.as_block(tree)


def _whole(p: Dict, cfg: ModelConfig, kind: str, lay):
    """A layer's pieces as plain tensors and its split over ``model``."""
    return (p, None) if lay is None else lay.block(p, cfg, kind)


def _attn_cfg(cfg: ModelConfig, tp) -> ModelConfig:
    return cfg if tp is None or tp.attn_cfg is None else tp.attn_cfg


def block_full(p: Dict, cfg: ModelConfig, kind: str, h: torch.Tensor, cos,
               sin, enc_out=None, causal: bool = True, *, lay=None
               ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """(h, the layer's cache, its MoE load-balance loss: 0 without MoE).
    ``lay`` (a ``collectives.Layout``) gathers a sharded layer's pieces;
    under a split over ``model`` the cache holds the local K/V heads (a
    cross block's ``ck`` / ``cv`` too, (b, hq / n, enc_seq, hd); a Mamba
    layer's: its conv channels and SSD heads; an MLA layer's: the whole
    latent).  ``enc_out`` there has its gradient summed over ``model``
    already (``models.model``), as each rank reads it through its own
    heads' columns only."""
    p, tp = _whole(p, cfg, kind, lay)
    if kind == "mamba":
        y, cache = ssm_mod.mamba_full(p["mamba"], cfg,
                                      rmsnorm(p["norm"], h, cfg.rmsnorm_eps),
                                      tp=tp)
        return h + y, cache, h.new_zeros((), dtype=torch.float32)
    x = rmsnorm(p["attn_norm"], h, cfg.rmsnorm_eps)
    attend = attn_mod.mla_full if is_mla(kind) else attn_mod.gqa_full
    acfg = _attn_cfg(cfg, tp)
    if acfg is not cfg:
        y, cache = attend(p["attn"], acfg, coll.enter(x, tp.group), cos, sin,
                          kind=kind, causal=causal, partial=True)
        y = coll.leave(y, tp.group).to(x.dtype)
    else:
        y, cache = attend(p["attn"], cfg, x, cos, sin, kind=kind,
                          causal=causal)
    ckv = None
    if "cross" in p and enc_out is not None:
        ckv = attn_mod.cross_kv(p["cross"], acfg, enc_out)
        cache.update(ckv)
    h, aux = _attn_block_tail(p, cfg, kind, h, y, ckv, tp, lay=lay)
    return h, cache, aux


def _attn_block_tail(p: Dict, cfg: ModelConfig, kind: str, h: torch.Tensor,
                     y: torch.Tensor, ckv=None, tp=None, *, lay=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual adds and the MLP (or MoE) after an attention output
    ``y``, with gemma2's post-norms under ``sandwich_norm`` and, given the
    encoder's ``ckv``, the cross-attention between the two.  Returns (h,
    aux).  Under ``tp`` with ``tp.attn_cfg`` the cross-attention computes
    its own heads (``ckv`` holds them), with ``tp.mlp`` the MLP its own
    columns, each summing its output over ``model``; ``lay`` makes a
    MoE's loss the whole batch's where rows split over ``data``."""
    if cfg.sandwich_norm:
        y = rmsnorm(p["post_attn_norm"], y, cfg.rmsnorm_eps)
    h = h + y
    if ckv is not None:
        xc = rmsnorm(p["cross_norm"], h, cfg.rmsnorm_eps)
        acfg = _attn_cfg(cfg, tp)
        if acfg is not cfg:
            yc = coll.leave(attn_mod.cross_attend(
                p["cross"], acfg, coll.enter(xc, tp.group), ckv,
                partial=True), tp.group).to(xc.dtype)
        else:
            yc = attn_mod.cross_attend(p["cross"], cfg, xc, ckv)
        h = h + yc
    x2 = rmsnorm(p["mlp_norm"], h, cfg.rmsnorm_eps)
    if is_moe(kind):
        y2, aux = moe_mod.moe_forward(p["moe"], cfg, x2, lay=lay)
    elif tp is not None and tp.mlp:
        y2 = coll.leave(mlp_mod.mlp_forward(
            p["mlp"], cfg, coll.enter(x2, tp.group), partial=True),
            tp.group).to(x2.dtype)
        aux = h.new_zeros((), dtype=torch.float32)
    else:
        y2 = mlp_mod.mlp_forward(p["mlp"], cfg, x2)
        aux = h.new_zeros((), dtype=torch.float32)
    if cfg.sandwich_norm:
        y2 = rmsnorm(p["post_mlp_norm"], y2, cfg.rmsnorm_eps)
    return h + y2, aux


def block_decode(p: Dict, cfg: ModelConfig, kind: str, h: torch.Tensor,
                 cos, sin, cache: Dict, pos: torch.Tensor,
                 paged=None, *, lay=None) -> torch.Tensor:
    """Writes the new K/V (or conv window and SSM state) into ``cache`` in
    place (an MLA layer its latent); a cross-attention block reads ``ck``
    / ``cv`` from it.  ``paged`` = (spec, table) routes K/V through the
    block-paged layout; ``kv_pool.check_paged_support`` keeps SSM and MLA
    layers and encoder-decoders off it.  A MoE block's load-balance loss
    is dropped, as in the reference's decode.  ``lay`` as ``block_full``'s:
    under a split over ``model`` the cache holds the local K/V heads (a
    cross block's ``ck`` / ``cv`` too; a Mamba layer's: its conv channels
    and SSD heads; an MLA layer's: the whole latent)."""
    p, tp = _whole(p, cfg, kind, lay)
    if kind == "mamba":
        return h + ssm_mod.mamba_decode(
            p["mamba"], cfg, rmsnorm(p["norm"], h, cfg.rmsnorm_eps), cache,
            tp=tp)
    x = rmsnorm(p["attn_norm"], h, cfg.rmsnorm_eps)
    acfg = _attn_cfg(cfg, tp)
    split = acfg is not cfg
    if paged is not None:
        if is_mla(kind):
            raise ValueError("paged decode does not support MLA layers")
        spec, table = paged
        y = attn_mod.gqa_decode_paged(p["attn"], acfg, x, cos, sin, cache,
                                      pos, table, spec, partial=split)
    elif is_mla(kind):
        y = attn_mod.mla_decode(p["attn"], acfg, x, cos, sin, cache, pos,
                                kind=kind, partial=split)
    else:
        y = attn_mod.gqa_decode(p["attn"], acfg, x, cos, sin, cache, pos,
                                kind=kind, partial=split)
    if split:
        y = coll.leave(y, tp.group).to(x.dtype)
    ckv = ({"ck": cache["ck"], "cv": cache["cv"]} if "cross" in p
           else None)
    return _attn_block_tail(p, cfg, kind, h, y, ckv, tp)[0]


def _block_h(p: Dict, cfg: ModelConfig, kind: str, h: torch.Tensor, cos,
             sin, enc_out, causal: bool, *, lay=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    h, _, aux = block_full(p, cfg, kind, h, cos, sin, enc_out, causal,
                           lay=lay)
    return h, aux


def segment_full(seg: Dict, shared, cfg: ModelConfig, unit: Tuple[str, ...],
                 count: int, h: torch.Tensor, cos, sin, *,
                 enc_out=None, causal: bool = True,
                 remat: bool = True, want_cache: bool = True, lay=None):
    """Run ``count`` stacked units; ``shared`` is the model-level
    ``shared_attn`` block (None without one).  Returns (h, aux, {"<j>":
    cache}), as the reference's: ``aux`` the sum of the MoE blocks'
    load-balance losses (f32, 0 without MoE), each cache leaf stacked on a
    leading count axis: k/v (count, b, hkv, s, hd), c_kv (count, b, s,
    lora), k_rope (count, b, s, rope), conv (count, b, width - 1,
    conv_dim), ssm (count, b, heads, p, n), and a cross-attention block's
    ck / cv (count, b, hq, enc_seq, hd); under a split over ``model`` each
    holds a rank's share, as ``block_full`` says.  The dict is empty when
    ``want_cache`` is False.
    ``enc_out`` is the encoder output the cross blocks attend; ``causal``
    False runs the self-attention unmasked (the encoder).

    With ``remat`` and autograd recording, each block is one
    ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
    block from its input instead of keeping its internals, as the
    reference's ``jax.checkpoint`` of the layer body.  ``lay`` (a
    ``collectives.Layout``) runs sharded stacks: each layer gathered inside
    its checkpoint."""
    layers = {str(j): unbind_tree(seg[str(j)])
              for j, kind in enumerate(unit) if kind != "shared_attn"}
    if shared is not None:
        shared = _blocks(shared)
    per_layer = {str(j): [] for j in range(len(unit))}
    checkpoint = remat and torch.is_grad_enabled()
    aux = h.new_zeros((), dtype=torch.float32)
    for i in range(count):
        for j, kind in enumerate(unit):
            p, kk = ((shared, "attn") if kind == "shared_attn"
                     else (layers[str(j)][i], kind))
            if want_cache:
                h, cache, a = block_full(p, cfg, kk, h, cos, sin, enc_out,
                                         causal, lay=lay)
                per_layer[str(j)].append(cache)
            elif checkpoint:
                h, a = torch.utils.checkpoint.checkpoint(
                    _block_h, p, cfg, kk, h, cos, sin, enc_out, causal,
                    lay=lay, use_reentrant=False)
            else:
                h, a = _block_h(p, cfg, kk, h, cos, sin, enc_out, causal,
                                lay=lay)
            aux = aux + a
    if not want_cache:
        return h, aux, {}
    return h, aux, {j: stack_trees(kvs) for j, kvs in per_layer.items()}


def segment_decode(seg: Dict, shared, cfg: ModelConfig,
                   unit: Tuple[str, ...], count: int, h: torch.Tensor, cos,
                   sin, caches: Dict, pos: torch.Tensor,
                   paged=None, *, lay=None) -> torch.Tensor:
    """One decode step through ``count`` stacked units, each layer's cache
    (the shared block's too: one per occurrence) written in place; ``lay``
    as ``segment_full``'s."""
    if shared is not None:
        shared = _blocks(shared)
    layers = {str(j): unbind_tree(seg[str(j)])
              for j, kind in enumerate(unit) if kind != "shared_attn"}
    for i in range(count):
        for j, kind in enumerate(unit):
            p, kk = ((shared, "attn") if kind == "shared_attn"
                     else (layers[str(j)][i], kind))
            h = block_decode(p, cfg, kk, h, cos, sin,
                             layer_view(caches[str(j)], i), pos, paged,
                             lay=lay)
    return h
