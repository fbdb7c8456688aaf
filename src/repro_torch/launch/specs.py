"""Input specs and step functions of the planning path: the port of
``repro/launch/specs.py``.

``input_specs(cfg, shape)`` gives meta-device tensors with the reference's
keys, shapes and dtypes, so nothing is allocated.  Decode shapes run
``serve_step``: ONE token against caches of ``seq_len`` slots; train and
prefill take the full sequence.  The audio and VLM stub frontends surface
here as precomputed embedding inputs.  ``materialize`` turns the specs
into seeded tensors on a device, ``rows`` of the batch, for a real step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (InputShape, ModelConfig,
                                      long_context_variant)
from repro_torch.data.pipeline import grid_positions_3d
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.io import flatten, tree_map
from repro_torch.models import model as M
from repro_torch.models.common import dtype_of
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update,
                                            value_and_grad)

META = torch.device("meta")


def resolved_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    if shape.name == "long_500k":
        return long_context_variant(cfg)
    return cfg


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    act_dt = dtype_of(cfg.dtype)
    if shape.mode in ("train", "prefill"):
        batch: Dict[str, Any] = {"tokens": _spec((b, s), torch.int32)}
        if shape.mode == "train":
            batch["labels"] = _spec((b, s), torch.int32)
        if cfg.is_encoder_decoder:
            batch["enc_features"] = _spec((b, cfg.encoder_seq_len,
                                           cfg.d_model), act_dt)
        if cfg.num_stub_patches > 0:
            batch["image_embeds"] = _spec((b, cfg.num_stub_patches,
                                           cfg.d_model), act_dt)
        if cfg.rope_kind == "mrope":
            batch["positions_3d"] = _spec((3, b, s), torch.int32)
        return {"batch": batch}
    # decode: ONE new token + caches holding seq_len entries
    return {"token": _spec((b, 1), torch.int32),
            "caches": M.init_cache(cfg, b, s, device=META)}


def abstract_params(cfg: ModelConfig):
    """The params' shapes and dtypes on the meta device: ``init_params``'
    own code, which draws nothing there."""
    return M.init_params(cfg, device=META)


def abstract_opt_state(params_shapes) -> AdamWState:
    return adamw_init(params_shapes)


def num_params(params) -> int:
    return sum(t.numel() for t in flatten(params).values())


def materialize(cfg: ModelConfig, specs: Dict[str, Any], *, rows: int,
                seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
    """Seeded tensors for ``specs`` on ``device``, cut to ``rows`` rows:
    tokens and labels uniform over the vocabulary, stub embeddings and
    cache leaves standard normals in their dtypes, ``positions_3d`` on
    Qwen2-VL's grid with the stub patches in front
    (``data/pipeline.grid_positions_3d``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def fill(name: str, t: torch.Tensor) -> torch.Tensor:
        axis = 1 if name == "positions_3d" else 0
        shape = list(t.shape)
        shape[axis] = rows
        if name == "positions_3d":
            return grid_positions_3d(rows, shape[2], cfg.num_stub_patches,
                                     device=dev, dtype=t.dtype)
        if not t.dtype.is_floating_point:
            return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                 device=dev, dtype=t.dtype)
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(t.dtype)

    def cache_leaf(t: torch.Tensor) -> torch.Tensor:
        shape = list(t.shape)
        shape[1] = rows                 # (L, b, ...) stacked leaves
        out = torch.empty(shape, dtype=t.dtype, device=dev)
        for part in out.flatten(0, 1):  # one (layer, row) slice at a time
            part.copy_(torch.randn(part.shape, generator=gen, device=dev))
        return out

    if "batch" in specs:
        return {"batch": {k: fill(k, v) for k, v in specs["batch"].items()}}
    return {"token": fill("token", specs["token"]),
            "caches": tree_map(cache_leaf, specs["caches"])}


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------
def _split_microbatches(batch, m: int):
    """Every batch leaf cut into m slices of b/m rows; positions_3d
    batches on axis 1."""
    out = []
    for i in range(m):
        mb = {}
        for k, v in batch.items():
            axis = 1 if k == "positions_3d" else 0
            rows = v.shape[axis] // m
            mb[k] = v.narrow(axis, i * rows, rows)
        out.append(mb)
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    microbatches: int = 1):
    """Train step with optional gradient accumulation: over
    ``microbatches`` > 1 slices the gradients are summed in float32 and
    divided by the count, as is the loss; then one AdamW update, in place
    (``training/optimizer.adamw_update``).  On sharded params every rank
    takes the whole batch and each microbatch's gradients accumulate on
    the rank's blocks.  Returns (params, opt_state, loss)."""
    if opt_cfg is None:
        opt_cfg = AdamWConfig()

    def loss(batch):
        return lambda p: M.loss_fn(p, cfg, batch)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            value, _, grads = value_and_grad(loss(batch), params)
        else:
            gsum = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            acc = flatten(gsum)
            value = 0.0
            for mbatch in _split_microbatches(batch, microbatches):
                lv, _, g = value_and_grad(loss(mbatch), params)
                for key, t in flatten(g).items():
                    coll.local(acc[key]).add_(coll.local(t).float())
                value = value + lv
                del g
            for t in acc.values():
                coll.local(t).div_(microbatches)
            grads = gsum
            value = value / microbatches
        params, opt_state = adamw_update(opt_cfg, grads, opt_state, params)
        return params, opt_state, value
    return train_step


def make_prefill_step(cfg: ModelConfig, microbatches: int = 1):
    """Every position's logits of the full forward, slice by slice over
    ``microbatches`` and concatenated by rows."""
    @torch.no_grad()
    def prefill_step(params, batch):
        if microbatches == 1:
            return M.forward_train(params, cfg, batch)[0]
        return torch.cat([M.forward_train(params, cfg, mb)[0]
                          for mb in _split_microbatches(batch, microbatches)])
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: the new token lands at the last cache slot,
    ``_cache_capacity(caches) - 1`` (a windowed ring's last slot; 0 for a
    cache with no K/V or latent leaf)."""
    @torch.no_grad()
    def serve_step(params, token, caches):
        pos = _cache_capacity(caches) - 1
        pos_t = torch.full((token.shape[0],), pos, dtype=torch.int32,
                           device=token.device)
        return M.decode_step(params, cfg, token, caches, pos_t)
    return serve_step


def _cache_capacity(caches) -> int:
    """Max sequence capacity across K/V leaves (rank 5) and latent leaves
    (rank 4); 1 when there is none."""
    best = 1
    for key, leaf in flatten(caches).items():
        name = key.rpartition("k:")[2]
        if name in ("k", "v") and leaf.dim() == 5:
            best = max(best, leaf.shape[3])
        if name in ("c_kv", "k_rope") and leaf.dim() == 4:
            best = max(best, leaf.shape[2])
    return best
