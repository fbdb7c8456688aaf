"""Stage 1: SFT via hindsight distillation (SCOPE §4.3).

The port of ``repro/training/sft.py``.  The (programmatic) teacher is
conditioned on realized outcomes (y, l) and emits a concise grounded
rationale + the structured prediction; the student LM trains with
next-token prediction on the generated suffix only.  Gradients come from
autograd through ``models.model.loss_fn`` (on the card: the flash forward
and backward kernels, one checkpoint a layer); the update is
``training.optimizer.adamw_update``, in place.

Params sharded over a device mesh (``ReasoningEstimator.shard``) train as
they are: every rank takes the whole batch, ``loss_fn`` computes the
rank's own rows, the gradients are reduce-scattered to the params' blocks
and each rank updates its blocks of params, ``mu`` and ``nu``.  Every rank
of the mesh must make the same calls.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import serialization
from repro_torch.core.fingerprint import FingerprintLibrary
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.data.datasets import ScopeData
from repro_torch.data.pipeline import batches, make_lm_batch, with_stubs
from repro_torch.distributed import collectives as coll
from repro_torch.models import model as M
from repro_torch.training.optimizer import (
    AdamWConfig, AdamWState, adamw_init, adamw_update, value_and_grad)


def build_sft_dataset(data: ScopeData, library: FingerprintLibrary,
                      retriever: AnchorRetriever, *, k: int = 5,
                      cot: bool = True, max_examples: Optional[int] = None,
                      qids: Optional[Sequence[int]] = None,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """(query, model) pairs -> serialized prompt + hindsight target."""
    world = data.world
    qids = list(qids if qids is not None else data.train_qids)
    rng = np.random.default_rng(seed)
    model_indices = {m: i for i, m in enumerate(data.models)}

    embs = np.stack([world.embed(data.queries[q]) for q in qids])
    sims, idx = retriever.retrieve(embs, k)

    prompts: List[List[int]] = []
    targets: List[List[int]] = []
    pairs = [(qi, m) for qi in range(len(qids)) for m in data.models]
    rng.shuffle(pairs)
    if max_examples is not None:
        pairs = pairs[:max_examples]
    for qi, m in pairs:
        q = data.queries[qids[qi]]
        rec = data.record(q.qid, m)
        fp = library.get(m)
        p, t = serialization.build_sft_example(
            world.models[m], model_indices[m], library.anchor_set, fp,
            sims[qi], idx[qi], q, rec.y, rec.tokens, cot=cot)
        prompts.append(p)
        targets.append(t)
    max_len = max(len(p) + len(t) for p, t in zip(prompts, targets, strict=True))
    return make_lm_batch(prompts, targets, max_len)


def sft_step(params, cfg: ModelConfig, opt_state: AdamWState,
             batch: Dict[str, torch.Tensor], opt_cfg: AdamWConfig
             ) -> Tuple[Dict, AdamWState, torch.Tensor, Dict]:
    """One AdamW step on ``batch`` (tensors on the params' device); the
    params and state are updated in place.  Returns them, the loss before
    the step and its metrics (``ce``, ``aux``, ``acc``)."""
    loss, metrics, grads = value_and_grad(
        lambda p: M.loss_fn(p, cfg, batch), params)
    params, opt_state = adamw_update(opt_cfg, grads, opt_state, params)
    return params, opt_state, loss, metrics


def train_sft(params, cfg: ModelConfig, dataset: Dict[str, np.ndarray], *,
              steps: int = 300, batch_size: int = 64,
              opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
              log_every: int = 50, verbose: bool = False):
    """``steps`` SFT steps over ``dataset``, epoch e shuffled by
    ``default_rng(seed + e)`` as in the reference; the params are trained
    in place on their own device.  A multimodal config's step i gets its
    stub inputs from ``pipeline.with_stubs(..., seed=seed + i)`` (the
    reference's trainer feeds text alone, which whisper's loss cannot
    take).  Sharded params train on every rank of their mesh, each batch
    whole on every rank (``sft_step``).  A dataset of fewer rows than
    ``batch_size`` raises ``ValueError``.  Returns (params, losses)."""
    rows = len(dataset["tokens"])
    if rows < batch_size:
        # batches(..., drop_last=True) yields nothing then, and the loop
        # below would never end
        raise ValueError(f"train_sft: {rows} examples make no batch of "
                         f"{batch_size}")
    opt_cfg = opt_cfg or AdamWConfig(lr=1e-3, warmup_steps=20,
                                     total_steps=steps)
    dev = coll.local(params["embed"]).device
    opt_state = adamw_init(params)
    losses = []
    done = 0
    epoch = 0
    while done < steps:
        for batch in batches(dataset, batch_size, seed=seed + epoch,
                             device=dev):
            batch = with_stubs(batch, cfg, seed=seed + done)
            params, opt_state, loss, _ = sft_step(params, cfg, opt_state,
                                                  batch, opt_cfg)
            losses.append(float(loss))
            done += 1
            if verbose and done % log_every == 0:
                print(f"  sft step {done}: loss {np.mean(losses[-log_every:]):.4f}")
            if done >= steps:
                break
        epoch += 1
    return params, losses
