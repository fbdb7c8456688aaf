"""Batching and padding: the port of ``repro/data/pipeline.py``.

Batches are built in numpy exactly as the reference builds them;
``batches`` hands them out as tensors on a given device (int32 columns as
int64, the dtype PyTorch indexes with).  ``shard_batch`` (placing a batch
on a device mesh) is not ported.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from repro_torch.data.tokenizer import PAD
from repro_torch.device import DeviceLike, resolve_device


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
