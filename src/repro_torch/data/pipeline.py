"""Batching and padding: the port of ``repro/data/pipeline.py``.

Batches are built in numpy exactly as the reference builds them;
``batches`` hands them out as tensors on a given device (int32 columns as
int64, the dtype PyTorch indexes with).  ``with_stubs`` adds the stub
inputs a multimodal backbone's loss reads.  ``shard_batch`` places a batch
on a device mesh as DTensors.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import PAD
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import dtype_of


def pad_to(seq: Sequence[int], length: int, pad: int = PAD) -> np.ndarray:
    out = np.full((length,), pad, np.int32)
    out[: len(seq)] = np.asarray(seq[:length], np.int32)
    return out


def make_lm_batch(prompts: List[List[int]], targets: List[List[int]],
                  max_len: int) -> Dict[str, np.ndarray]:
    """Concatenate prompt+target; labels = next-token, -100 on prompt/pad.

    Loss applies only to target tokens (SFT over the generated suffix, as in
    hindsight distillation — the prompt is conditioning, not supervision).
    """
    bsz = len(prompts)
    tokens = np.full((bsz, max_len), PAD, np.int32)
    labels = np.full((bsz, max_len), -100, np.int32)
    for i, (p, t) in enumerate(zip(prompts, targets, strict=True)):
        seq = (p + t)[:max_len]
        tokens[i, : len(seq)] = seq
        # label at position j predicts tokens[j+1]
        start = max(len(p) - 1, 0)
        end = min(len(seq) - 1, max_len - 1)
        for j in range(start, end + 1):
            nxt = j + 1
            if nxt < len(seq):
                labels[i, j] = seq[nxt]
    return {"tokens": tokens, "labels": labels}


def to_tensors(batch: Dict[str, np.ndarray],
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """numpy columns -> tensors on ``device`` (int32 as int64)."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.tensor(np.asarray(v))
        out[k] = (t.long() if t.dtype == torch.int32 else t).to(dev)
    return out


def batches(data: Dict[str, np.ndarray], batch_size: int, *,
            shuffle: bool = True, seed: int = 0, drop_last: bool = True,
            device: DeviceLike = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Minibatches of ``data``'s rows in an order shuffled by
    ``np.random.default_rng(seed)``, as tensors on ``device`` (the card
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    n = len(next(iter(data.values())))
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    stop = n - (n % batch_size) if drop_last else n
    for i in range(0, stop, batch_size):
        sel = idx[i: i + batch_size]
        yield to_tensors({k: v[sel] for k, v in data.items()}, dev)


def stack_examples(examples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples]) for k in keys}


def shard_batch(batch: Dict[str, np.ndarray], mesh,
                spec) -> Dict[str, torch.Tensor]:
    """Place a host batch onto ``mesh`` (a ``DeviceMesh``) with the given
    spec (``distributed.sharding``): each column a DTensor of the same
    dtype, taken from the mesh's first rank."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import placements
    place = placements(mesh, spec)
    return {k: distribute_tensor(torch.as_tensor(np.asarray(v)).to(
        mesh.device_type), mesh, place) for k, v in batch.items()}


def with_stubs(batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
               seed: int) -> Dict[str, torch.Tensor]:
    """``batch`` (tokens, labels) with the stub inputs ``cfg``'s loss
    reads, under the names of the reference's input specs
    (``repro/launch/specs.py::input_specs``); a text-only config's batch
    comes back as it is.  Stub values are float32 standard normals of
    ``np.random.default_rng(seed)`` cast to the model dtype, on the
    batch's device, so a batch on the card and one on the CPU get the same
    values.
      - An encoder-decoder gets ``enc_features`` (b, encoder_seq_len, d).
      - A VLM gets ``image_embeds`` (b, P, d) in front of the text: tokens
        and labels gain P leading PAD / -100 positions, which the patches
        replace, and ``positions_3d`` (3, b, P + s) as Qwen2-VL lays them
        out: the patches at t = 0 on a square (h, w) grid of side
        ceil(sqrt(P)), the text continuing all three streams from the
        grid's largest index + 1.
    """
    P = cfg.num_stub_patches
    if not (cfg.is_encoder_decoder or P):
        return batch
    rng = np.random.default_rng(seed)
    tokens = batch["tokens"]
    dev, (b, s) = tokens.device, tokens.shape
    dt = dtype_of(cfg.dtype)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dt)

    out = dict(batch)
    if cfg.is_encoder_decoder:
        out["enc_features"] = normal(b, cfg.encoder_seq_len, cfg.d_model)
    if P:
        out["image_embeds"] = normal(b, P, cfg.d_model)
        out["tokens"] = torch.cat([tokens.new_full((b, P), PAD), tokens], 1)
        if "labels" in batch:
            out["labels"] = torch.cat(
                [batch["labels"].new_full((b, P), -100), batch["labels"]], 1)
        out["positions_3d"] = grid_positions_3d(b, P + s, P, device=dev,
                                                dtype=tokens.dtype)
    return out


def grid_positions_3d(b: int, s: int, patches: int, *,
                      side: Optional[int] = None, device: DeviceLike = "cpu",
                      dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(3, b, s) M-RoPE positions as Qwen2-VL lays out an image in front of
    text: the first ``patches`` tokens at t = 0 on a square (h, w) grid of
    ``side`` (default ceil(sqrt(patches))), row-major, then the text
    continuing all three streams from the grid's side, its largest index
    + 1."""
    side = math.isqrt(patches - 1) + 1 if side is None else side
    if side * side < patches:
        raise ValueError(f"{patches} patches do not fit a {side} x {side} "
                         "grid")
    idx = torch.arange(patches, device=device)
    pos = torch.zeros(3, b, s, dtype=dtype, device=device)
    pos[1, :, :patches], pos[2, :, :patches] = idx // side, idx % side
    pos[:, :, patches:] = side + torch.arange(s - patches, device=device)
    return pos
