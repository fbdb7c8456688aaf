"""The cost of one planned step: matrix-product FLOPs, a lower bound on HBM
bytes, planned memory, the microbatch count and the roofline on one H100.

The counterpart of ``repro/launch/hlo_analysis.py``.  That module reads the
FLOPs and bytes off a compiled XLA executable's HLO text, scaled by the
scans' trip counts; eager PyTorch has no HLO, so this module keeps the
meaning and not the mechanism:

* ``flops`` is counted from the config, the shape, the mode and the
  microbatch count, as ``hlo_analysis.analyze`` counts a lowering of the
  same step on the reference's default path (``impl="xla"``): 2 x output
  elements x contraction size for every matrix product the step runs.
  That covers the projections; the scores and P.V as the XLA twins form
  them (``repro/kernels/ops.py``: one unblocked product up to 1024 x 1024,
  or 4096 x 4096 when the heads divide by 16; else the banded
  sliding-window path, which skips the blocks outside its band, or the
  blocked causal path, which computes every padded block, the masked upper
  triangle included); the MoE expert GEMMs on their capacity buckets with
  the one-hot dispatch and combine products; the SSD chunk products in the
  pairwise order ``jnp.einsum`` picks; the LM head.  A train step adds the
  backward's products (one a differentiated operand) and the forward
  recomputed under one checkpoint a layer, less the products whose result
  the backward does not read.
* ``hbm_bytes`` is an analytic lower bound, NOT the reference's fusion-I/O
  count: the weights read once a microbatch, the gradients and the AdamW
  state read and written once a step, the caches read once, the
  activations at layer boundaries and the logits.

There are no collectives on one card: ``collectives`` and ``collective_s``
stay 0 so that a reader of the reference's rows finds them.

``analyze_mesh`` plans the step over a production mesh (``launch.mesh``)
of H100s, per device.  The reference reads these counts off an executable
compiled for 256 or 512 forced host devices; here they are analytic:

* the argument bytes are exact: each leaf of the params, the AdamW moments
  (train), the batch or the token and caches, over the product of the
  sizes of the axes its spec (``distributed.sharding``) shards it on;
* the microbatch count, memory plan, FLOPs and HBM bytes are those of the
  rows one device holds (the batch over its data axes, where they divide),
  the FLOPs and bytes over the ``model`` axis too;
* the collectives are the FSDP all-gathers (every leaf sharded on the
  data axes, gathered to its ``model`` share once a microbatch, twice in
  training for the recompute), the gradients' reduce-scatters (training,
  once a microbatch) and the row-parallel projections' all-reduces of
  their outputs (once a microbatch, three times in training: forward,
  recompute, and the column-parallel input gradient); each as the bytes one
  device receives, ring-style, at ``LINK_BYTES_PER_S``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.io import flatten
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf
from repro_torch.models.attention import resolve_window
from repro_torch.models.common import dtype_of
from repro_torch.models.ssm import _largest_chunk

# NVIDIA H100 SXM5 80GB: HBM3 at 3.35 TB/s; dense tensor-core peaks (bf16
# 989 TFLOP/s without sparsity; float32 on the FMA units, 67 TFLOP/s)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
CARD_BYTES = 80e9
# what the planned temporaries may take: the card less the CUDA context,
# the allocator's slack and the kernels' workspaces
HBM_BUDGET = CARD_BYTES - 4e9
MAX_MICROBATCHES = 16
# what one H100 of a mesh of 8-card nodes exchanges with the others: one
# 400 Gb/s InfiniBand NDR port a card (the NVLink inside a node is faster;
# a 16 x 16 mesh spans 32 nodes)
LINK_BYTES_PER_S = 50e9


@dataclasses.dataclass(frozen=True)
class Dot:
    """One matrix product: its FLOPs, how many of its two operands a loss
    differentiates with a product of the same size backward, whether its
    result is dead in the backward's recompute (it only adds into the layer
    unit's output, whose gradient does not read it), and whether the
    forward is a product at all (not an element-wise pair of
    ``einsum_dots``)."""
    flops: float
    grads: int = 2
    tail: bool = False
    forward: bool = True

    @property
    def fwd_flops(self) -> float:
        return self.flops if self.forward else 0.0


def _dot(*sizes: int, grads: int = 2, tail: bool = False) -> Dot:
    return Dot(2.0 * math.prod(sizes), grads, tail)


# ---------------------------------------------------------------------------
# jnp.einsum's pairwise order (opt_einsum's "optimal" search, unlimited
# memory, the first cheapest order in its search order kept)
# ---------------------------------------------------------------------------
def _size(idx, sizes) -> int:
    return math.prod(sizes[i] for i in idx)


def einsum_dots(spec: str, sizes: Dict[str, int], grads: int = 2
                ) -> List[Dot]:
    """The dot products ``jnp.einsum(spec, ...)`` lowers to: opt_einsum's
    optimal pairwise order, each pair's indices unique to one side summed
    out first (a reduce, no product).  ``grads`` 2 when both operands are
    differentiated, 0 when neither is."""
    ins, out = spec.split("->")
    inputs = [frozenset(t) for t in ins.split(",")]
    output = frozenset(out)
    best = {"flops": math.inf, "path": ()}

    def k12_cost(inps, remaining, i, j):
        k1, k2 = inps[i], inps[j]
        either, shared = k1 | k2, k1 & k2
        keep = frozenset().union(output,
                                 *(inps[r] for r in remaining - {i, j}))
        inner = bool(shared - keep)
        return either & keep, _size(either, sizes) * (1 + (1 if inner else 0))

    def search(path, remaining, inps, flops):
        if len(remaining) == 1:
            best["flops"], best["path"] = flops, path
            return
        for i, j in itertools.combinations(sorted(remaining), 2):
            k12, cost = k12_cost(inps, remaining, i, j)
            if flops + cost >= best["flops"]:
                continue
            search(path + ((i, j, inps[i], inps[j], k12),),
                   (remaining - {i, j}) | {len(inps)}, inps + (k12,),
                   flops + cost)

    search((), set(range(len(inputs))), tuple(inputs), 0)
    dots = []
    for _, _, k1, k2, k12 in best["path"]:
        uniques = (k1 | k2) - k12 - (k1 & k2)
        k1, k2 = k1 - uniques, k2 - uniques
        # a product that contracts nothing (or only size-1 indices) is an
        # element-wise multiply after XLA's simplifier; so is each operand's
        # gradient when the other operand has no index of its own
        contracted = {i for i in (k1 & k2) - k12 if sizes[i] > 1}
        dots.append(Dot(2.0 * _size(k1 | k2, sizes),
                        grads * ((k2 - k1 != set()) + (k1 - k2 != set()))
                        // 2,
                        forward=bool(contracted)))
    return dots


# ---------------------------------------------------------------------------
# Attention as the reference's XLA twins form it
# ---------------------------------------------------------------------------
def attention_dots(b: int, hq: int, sq: int, sk: int, d: int, dv: int, *,
                   window: int = 0) -> List[Dot]:
    """Scores and P.V of ``repro.kernels.ops.flash_attention(impl="xla")``:
    the unblocked oracle up to 1024 x 1024 (4096 x 4096 when the heads
    divide by 16), the banded window path (a (window + 512)-key span a
    block of 512 queries), or the blocked path (512 x 1024 blocks, every
    padded block computed)."""
    if (sq <= 1024 and sk <= 1024) or (sq <= 4096 and sk <= 4096
                                       and hq % 16 == 0):
        rows, keys = sq, sk
    elif window > 0:
        bq = min(512, sq)
        rows, keys = -(-sq // bq) * bq, min(sk, window + bq)
    else:
        bq, bk = min(512, max(sq, 1)), min(1024, max(sk, 1))
        rows, keys = -(-sq // bq) * bq, -(-sk // bk) * bk
    return [_dot(b, hq, rows, keys, d), _dot(b, hq, rows, keys, dv)]


def decode_attention_dots(b: int, hq: int, S: int, d: int, dv: int
                          ) -> List[Dot]:
    """``ops.decode_attention(impl="xla")``: scores and P.V over every slot
    of the cache, in float32."""
    return [_dot(b, hq, S, d), _dot(b, hq, S, dv)]


# ---------------------------------------------------------------------------
# One layer's products
# ---------------------------------------------------------------------------
def _mlp(cfg: ModelConfig, n: int, f: int) -> List[Dot]:
    d = cfg.d_model
    if cfg.mlp_kind == "gelu":
        return [_dot(n, d, f), _dot(n, f, d, tail=True)]
    return [_dot(n, d, f), _dot(n, d, f), _dot(n, f, d, tail=True)]


def _moe(cfg: ModelConfig, n: int) -> List[Dot]:
    d, E, k = cfg.d_model, cfg.num_experts, cfg.num_experts_per_tok
    f = cfg.resolved_moe_d_ff
    T = moe_mod._group_size(n)
    G, C = n // T, moe_mod.capacity(cfg, T)
    dots = [_dot(n, d, E),                           # router
            _dot(n, E, C, k, grads=0),               # dispatch
            _dot(n, E, C, k, grads=1),               # combine weights
            _dot(G, E, C, d, T, grads=1),            # expert_in
            _dot(G, E, C, d, f), _dot(G, E, C, d, f),
            _dot(G, E, C, f, d),
            _dot(n, d, E, C, tail=True)]             # combine
    if cfg.num_shared_experts > 0:
        dots += _mlp(cfg, n, f * cfg.num_shared_experts)
    return dots


def _gqa(cfg: ModelConfig, b: int, s: int, kind: str,
         decode_slots: int = 0) -> List[Dot]:
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    n = b * s
    dots = [_dot(n, d, hq * hd), _dot(n, d, hkv * hd), _dot(n, d, hkv * hd)]
    if decode_slots:
        dots += decode_attention_dots(b, hq, decode_slots, hd, hd)
    else:
        dots += attention_dots(b, hq, s, s, hd, hd,
                               window=resolve_window(cfg, kind))
    return dots + [_dot(n, hq * hd, d)]


def _mla(cfg: ModelConfig, b: int, s: int, kind: str,
         decode_slots: int = 0) -> List[Dot]:
    d, h = cfg.d_model, cfg.num_heads
    nope, rdim, vdim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    lora = cfg.kv_lora_rank
    n = b * s
    dots = [_dot(n, d, h * (nope + rdim)), _dot(n, d, lora + rdim)]
    if decode_slots:
        S = decode_slots
        dots += [_dot(b, h, lora, nope), _dot(b, h, S, lora),
                 _dot(b, h, S, rdim), _dot(b, h, lora, S),
                 _dot(b, h, vdim, lora)]
    else:
        dots += [_dot(n, lora, h * nope), _dot(n, lora, h * vdim)]
        dots += attention_dots(b, h, s, s, nope + rdim, vdim,
                               window=resolve_window(cfg, kind))
    return dots + [_dot(n, h * vdim, d)]


def _cross(cfg: ModelConfig, b: int, s: int, decode: bool) -> List[Dot]:
    d, hq, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    se = cfg.encoder_seq_len
    dots = [] if decode else [_dot(b * se, d, hq * hd),
                              _dot(b * se, d, hq * hd)]
    dots += [_dot(b * s, d, hq * hd)]
    dots += attention_dots(b, hq, s, se, hd, hd)
    return dots + [_dot(b * s, hq * hd, d)]


def _mamba(cfg: ModelConfig, b: int, s: int, decode: bool) -> List[Dot]:
    d, din, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    heads, p = cfg.resolved_ssm_heads, cfg.ssm_head_dim
    toks = b * s
    dots = [_dot(toks, d, 2 * din + 2 * n + heads)]
    if decode:
        sizes = dict(b=b, h=heads, p=p, n=n, w=cfg.ssm_conv_width,
                     c=din + 2 * n)
        dots += einsum_dots("bwc,wc->bc", sizes)
        dots += einsum_dots("bhp,bn->bhpn", sizes)
        dots += einsum_dots("bhpn,bn->bhp", sizes)
    else:
        chunk = cfg.ssm_chunk if s % cfg.ssm_chunk == 0 else (
            1 if s == 1 else _largest_chunk(s, cfg.ssm_chunk))
        sizes = dict(b=b, c=s // chunk, s=chunk, t=chunk, n=n, h=heads, p=p)
        dots += einsum_dots("bcsn,bctn,bhcst,bcthp->bcshp", sizes)
        dots += einsum_dots("bctn,bhct,bcthp->bchpn", sizes)
        dots += einsum_dots("bcsn,bhcs,cbhpn->bcshp", sizes)
    return dots + [_dot(toks, din, d, tail=True)]


def block_dots(cfg: ModelConfig, kind: str, b: int, s: int, *,
               cross: bool = False, decode_slots: int = 0) -> List[Dot]:
    """The products of one block of ``kind`` over (b, s) tokens (causal or
    not, the XLA twins form the same products); a decode step (s = 1)
    reads ``decode_slots`` cache slots."""
    decode = decode_slots > 0
    if kind == "mamba":
        return _mamba(cfg, b, s, decode)
    attn = _mla if tf.is_mla(kind) else _gqa
    dots = attn(cfg, b, s, kind, decode_slots=decode_slots)
    if cross:
        dots += _cross(cfg, b, s, decode)
    ffn = (_moe(cfg, b * s) if tf.is_moe(kind)
           else _mlp(cfg, b * s, cfg.d_ff))
    if cfg.sandwich_norm:
        # the post-norms read the MLP's output: nothing is dead
        ffn = [dataclasses.replace(x, tail=False) for x in ffn]
    return dots + ffn


def _train_flops(blocks: List[List[Dot]]) -> float:
    """One checkpointed unit body, trained: the forward, the recompute (the
    last block's tail products dead) and one product a differentiated
    operand."""
    fwd = sum(x.fwd_flops for blk in blocks for x in blk)
    dead = sum(x.fwd_flops for x in blocks[-1] if x.tail)
    bwd = sum(x.flops * x.grads for blk in blocks for x in blk)
    return fwd + (fwd - dead) + bwd


def _cache_slots(cfg: ModelConfig, kind: str, s: int) -> int:
    if kind == "mamba":
        return 0
    w = 0 if tf.is_mla(kind) else resolve_window(cfg, kind)
    return min(s, w) if w > 0 else s


def forward_flops(cfg: ModelConfig, b: int, s: int, mode: str) -> float:
    """FLOPs of one step of ``mode`` over ``b`` rows (one microbatch); a
    decode step reads caches of capacity ``s``."""
    train = mode == "train"
    d, se = cfg.d_model, cfg.encoder_seq_len

    def unit_flops(blocks: List[List[Dot]]) -> float:
        return (_train_flops(blocks) if train
                else sum(x.fwd_flops for blk in blocks for x in blk))

    def stub(x: Dot) -> float:          # a stub's projection: 1 gradient
        return x.flops * (1 + x.grads) if train else x.flops

    total = 0.0
    if mode == "decode":
        for unit, count in tf.build_plan(cfg):
            kinds = ["attn" if k == "shared_attn" else k for k in unit]
            total += count * unit_flops([
                block_dots(cfg, k, b, 1, cross=cfg.is_encoder_decoder,
                           decode_slots=max(1, _cache_slots(cfg, k, s)))
                for k in kinds])
        return total + _dot(b, d, cfg.vocab_size).flops
    if cfg.is_encoder_decoder:
        total += stub(_dot(b * se, d, d, grads=1))
        total += cfg.num_encoder_layers * unit_flops(
            [block_dots(cfg, "attn", b, se)])
    if cfg.num_stub_patches > 0:
        total += stub(_dot(b * cfg.num_stub_patches, d, d, grads=1))
    for unit, count in tf.build_plan(cfg):
        total += count * unit_flops([
            block_dots(cfg, "attn" if k == "shared_attn" else k, b, s,
                       cross=cfg.is_encoder_decoder) for k in unit])
    return total + _dot(b * s, d, cfg.vocab_size).flops * (3 if train else 1)


def step_flops(cfg: ModelConfig, shape: InputShape,
               microbatches: int = 1) -> float:
    """FLOPs of one step at ``shape``: train and prefill in
    ``microbatches`` slices of the batch, decode one token a row."""
    b = shape.global_batch
    if shape.mode == "decode":
        return forward_flops(cfg, b, shape.seq_len, "decode")
    return microbatches * forward_flops(cfg, b // microbatches,
                                        shape.seq_len, shape.mode)


# ---------------------------------------------------------------------------
# Bytes, planned memory, the microbatch count, the roofline
# ---------------------------------------------------------------------------
def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / tuple (meta tensors too)."""
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


def _logit_bytes(cfg: ModelConfig) -> int:
    return 4 if cfg.final_logit_softcap > 0 else dtype_of(cfg.dtype).itemsize


def _boundaries(cfg: ModelConfig, s: int) -> int:
    """Positions saved at layer boundaries a row: one checkpoint a layer
    (the encoder's over its frames)."""
    return cfg.num_layers * s + cfg.num_encoder_layers * (
        cfg.encoder_seq_len if cfg.is_encoder_decoder else 0)


def _layer_work(cfg: ModelConfig, b: int, s: int) -> float:
    """Bytes one layer holds while it is recomputed and differentiated:
    its widest activations (the projections, the MLP or expert buffers,
    the SSD inputs and chunk states), twice over for their gradients."""
    ab, n = dtype_of(cfg.dtype).itemsize, b * s
    d, hd = cfg.d_model, cfg.resolved_head_dim if cfg.num_heads else 0
    widths = [2 * cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd,
              3 * cfg.d_ff]
    if cfg.has_moe():
        k = cfg.num_experts_per_tok
        widths.append(int(k * cfg.capacity_factor + 1)
                      * (d + 3 * cfg.resolved_moe_d_ff))
    if cfg.has_mla():
        widths.append(cfg.num_heads * (2 * (cfg.qk_nope_head_dim
                                            + cfg.qk_rope_head_dim)
                                       + 2 * cfg.v_head_dim))
    if cfg.has_ssm():
        widths.append(3 * (2 * cfg.d_inner + 2 * cfg.ssm_state)
                      + 4 * cfg.resolved_ssm_heads * cfg.ssm_head_dim
                      * cfg.ssm_state // max(cfg.ssm_chunk, 1) // ab)
    return 2.0 * n * max(widths) * ab


def plan_memory(cfg: ModelConfig, shape: InputShape, microbatches: int, *,
                param_bytes: int, n_params: int,
                cache_bytes: int = 0) -> Dict[str, float]:
    """Planned device bytes of one step: bf16 weights (and grads), float32
    AdamW moments (and a float32 gradient accumulator over several
    microbatches), activations at one checkpoint a layer and one layer's
    working set, the caches, and the logits (float32 under a final
    softcap; train also holds their float32 log-softmax and its
    gradient).  ``temp`` is what the microbatch count shrinks."""
    ab, lb = dtype_of(cfg.dtype).itemsize, _logit_bytes(cfg)
    b, s, V = shape.global_batch, shape.seq_len, cfg.vocab_size
    mb = b // microbatches
    out = {"weights": float(param_bytes), "grads": 0.0, "adam": 0.0,
           "activations": 0.0, "caches": float(cache_bytes), "logits": 0.0}
    if shape.mode == "train":
        out["grads"] = float(param_bytes + (4 * n_params if microbatches > 1
                                            else 0))
        out["adam"] = 8.0 * n_params
        out["activations"] = (mb * _boundaries(cfg, s) * cfg.d_model * ab
                              + _layer_work(cfg, mb, s))
        out["logits"] = float(mb * s * V * (lb + 8))
    elif shape.mode == "prefill":
        out["activations"] = 2.0 * mb * s * cfg.d_model * ab + _layer_work(
            cfg, mb, s) / 2
        out["logits"] = float(b * s * V * lb)
    else:
        out["activations"] = 4.0 * b * cfg.d_model * ab
        out["logits"] = float(b * V * lb)
    out["temp"] = out["activations"] + out["logits"]
    out["total"] = sum(out[k] for k in ("weights", "grads", "adam",
                                        "caches", "temp"))
    return out


def fit_microbatches(cfg: ModelConfig, shape: InputShape, **sizes) -> int:
    """The reference's rule (``repro/launch/dryrun.py``): double the
    microbatch count until the planned temporaries fit the card's budget,
    at most ``MAX_MICROBATCHES``; decode takes one."""
    m = 1
    if shape.mode == "decode":
        return m
    while (plan_memory(cfg, shape, m, **sizes)["temp"] > HBM_BUDGET
           and m < MAX_MICROBATCHES
           and shape.global_batch % (2 * m) == 0):
        m *= 2
    return m


def step_hbm_bytes(cfg: ModelConfig, shape: InputShape, microbatches: int,
                   *, param_bytes: int, n_params: int,
                   cache_bytes: int = 0) -> float:
    """A lower bound on the bytes one step moves: the weights read once a
    microbatch; in training the gradients written once a microbatch (and
    accumulated in float32 over several), AdamW reading weights, gradients
    and moments and writing weights and moments once; the activations at
    layer boundaries written and read (and their gradients, in training);
    the caches read once; the logits written once (in training also read,
    and their gradient written and read)."""
    ab, lb = dtype_of(cfg.dtype).itemsize, _logit_bytes(cfg)
    b, s, V, d = shape.global_batch, shape.seq_len, cfg.vocab_size, \
        cfg.d_model
    m = microbatches
    if shape.mode == "decode":
        return float(param_bytes + cache_bytes + 2 * b * cfg.num_layers
                     * d * ab + b * V * lb)
    acts = 2.0 * b * _boundaries(cfg, s) * d * ab
    logits = float(b * s * V * lb)
    if shape.mode == "prefill":
        return m * param_bytes + acts + logits
    grads = m * param_bytes + (8.0 * n_params * m if m > 1 else 0.0)
    adam = 2 * param_bytes + 4.0 * n_params + 16.0 * n_params
    return m * param_bytes + grads + adam + 2 * acts + 4 * logits


def roofline(flops: float, hbm_bytes: float,
             dtype: str = "bfloat16") -> Dict[str, object]:
    """The step's terms on one H100: its FLOPs at the peak of ``dtype``,
    its bytes at the HBM rate; no collectives on one card."""
    terms: Dict[str, object] = {
        "compute_s": flops / PEAK_FLOPS[dtype],
        "memory_s": hbm_bytes / HBM_BYTES_PER_S,
        "collective_s": 0.0}
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                              key=lambda k: terms[k])
    return terms


def _leaf_bytes(leaf) -> int:
    return leaf.numel() * leaf.element_size()


def _collectives(cfg: ModelConfig, shape: InputShape, mesh, params,
                 pspecs, microbatches: int, rows: int) -> Dict[str, Dict]:
    """{"bytes": {op: bytes}, "ops": {op: count}} one device takes part in
    over one step (see the module docstring)."""
    train = shape.mode == "train"
    fsdp = set(shd.spec_axes(shd.data_axes(mesh)))
    sizes = shd.axis_sizes(mesh)
    s = 1 if shape.mode == "decode" else shape.seq_len
    act = dtype_of(cfg.dtype).itemsize
    out = {"bytes": {}, "ops": {}}

    def add(op, nbytes, count):
        out["bytes"][op] = out["bytes"].get(op, 0.0) + nbytes
        out["ops"][op] = out["ops"].get(op, 0) + count

    for key, leaf in flatten(params).items():
        spec = pspecs[key]
        axes = [shd.spec_axes(e) for e in spec]
        fs = math.prod(sizes[a] for ax in axes for a in ax if a in fsdp)
        tp = math.prod(sizes[a] for ax in axes for a in ax if a == "model")
        stack = math.prod(leaf.shape[: max(0, leaf.dim() - 2)]) or 1
        if fs > 1:
            share = _leaf_bytes(leaf) / tp * (fs - 1) / fs
            gathers = microbatches * (2 if train else 1)
            add("all-gather", gathers * share, gathers * stack)
            if train:
                add("reduce-scatter", microbatches * share,
                    microbatches * stack)
        name = key.rpartition("k:")[2]
        if (name in shd._ROW_PARALLEL and leaf.dim() >= 2 and tp > 1
                and "model" in axes[-2]):
            seq = cfg.encoder_seq_len if "k:encoder" in key else s
            passes = 3 if train else 1
            nbytes = rows * seq * leaf.shape[-1] * act * 2 * (tp - 1) / tp
            add("all-reduce", passes * stack * nbytes,
                passes * stack * microbatches)
    return out


def analyze_mesh(cfg: ModelConfig, shape: InputShape, mesh, params,
                 inputs) -> Dict[str, object]:
    """The step of ``shape`` planned per device of ``mesh``: its argument
    bytes, microbatches, memory plan, FLOPs, HBM bytes, collectives and
    roofline (see the module docstring).  ``params`` and ``inputs`` are
    meta tensors (``launch.specs``)."""
    pspecs = shd.param_specs(mesh, params)
    flat = flatten(params)
    n_params = sum(t.numel() for t in flat.values())
    n_dev = sum(t.numel() // shd.split(mesh, pspecs[k])
                for k, t in flat.items())
    param_dev = shd.local_bytes(mesh, params, pspecs)
    batch = ({"token": inputs["token"]} if shape.mode == "decode"
             else inputs["batch"])
    bspecs = shd.batch_specs(mesh, batch)
    in_dev = sum(_leaf_bytes(t) // shd.split(mesh, bspecs[k])
                 for k, t in batch.items())
    lead = bspecs["token" if shape.mode == "decode" else "tokens"][0]
    cache_dev = (0 if shape.mode != "decode" else shd.local_bytes(
        mesh, inputs["caches"], shd.cache_specs(mesh, inputs["caches"])))
    # the AdamW moments (float32, sharded as their params) and step count
    opt_dev = 8 * n_dev + 4 if shape.mode == "train" else 0
    rows = shape.global_batch // shd.axis_size(mesh, lead)
    model = shd.axis_size(mesh, "model")
    local = dataclasses.replace(shape, global_batch=rows)
    sizes = dict(param_bytes=param_dev, n_params=n_dev,
                 cache_bytes=cache_dev)
    m = fit_microbatches(cfg, local, **sizes)
    mem = plan_memory(cfg, local, m, **sizes)
    flops = step_flops(cfg, local, m) / model
    hbm = step_hbm_bytes(cfg, local, m, **sizes) / model
    coll = _collectives(cfg, shape, mesh, params, pspecs, m, rows)
    total = float(sum(coll["bytes"].values()))
    terms = roofline(flops, hbm, cfg.dtype)
    terms["collective_s"] = total / LINK_BYTES_PER_S
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                              key=lambda k: terms[k])
    return {"microbatches": m, "num_params": n_params, "flops": flops,
            "hbm_bytes": hbm, "collective_bytes": coll["bytes"],
            "collective_total_bytes": total,
            "collective_op_counts": coll["ops"],
            "argument_bytes": param_dev + opt_dev + in_dev + cache_dev,
            "memory": mem, "roofline": terms,
            "num_devices": math.prod(mesh.shape)}


def analyze(cfg: ModelConfig, shape: InputShape, microbatches: int, *,
            param_bytes: int, n_params: int,
            cache_bytes: int = 0) -> Dict[str, object]:
    """``hlo_analysis.analyze``'s keys for one step on one card."""
    return {"flops": step_flops(cfg, shape, microbatches),
            "hbm_bytes": step_hbm_bytes(cfg, shape, microbatches,
                                        param_bytes=param_bytes,
                                        n_params=n_params,
                                        cache_bytes=cache_bytes),
            "collective_bytes": {}, "collective_total_bytes": 0.0,
            "collective_op_counts": {}}
