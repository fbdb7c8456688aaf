"""Distillation of the tier-0 pre-router head (two-tier routing).

The port of ``repro/training/tier0.py``.  The teacher is the trained
reasoning estimator: for each (query, model) pair we serialize the same
prompt the serve path would, run ``predict_batch``, and distill the
*parsed* outputs — the calibrated correctness probability ``p_conf`` as a
soft BCE target and the ``len_bucket`` of ``len_hat`` as a masked
cross-entropy target (malformed teacher rows supervise only the
correctness head).  After training, the correctness logit is
temperature-scaled on a held-out split (grid-search NLL) so
``max(p, 1-p)`` is a real escalation signal, not a raw margin.  Gradients
come from autograd; the update is ``training.optimizer.adamw_update``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import serialization
from repro_torch.core.fingerprint import FingerprintLibrary
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.data import tokenizer as tok
from repro_torch.data.datasets import ScopeData
from repro_torch.data.pipeline import to_tensors
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import tier0 as T0
from repro_torch.training.optimizer import (
    AdamWConfig, AdamWState, adamw_init, adamw_update, value_and_grad)

LEN_LOSS_WEIGHT = 0.5

Tree = Dict[str, torch.Tensor]


def build_tier0_dataset(data: ScopeData, library: FingerprintLibrary,
                        retriever: AnchorRetriever, estimator, *,
                        k: int = 5, qids: Optional[Sequence[int]] = None,
                        max_pairs: Optional[int] = None,
                        rng: Optional[torch.Generator] = None,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """Teacher-labelled feature set over (train query, model) pairs.

    Returns columnar arrays: the head inputs (``qf``/``af``/``mf``/``mid``,
    see ``models.tier0.pair_features``) plus the distillation targets —
    ``q`` (teacher ``p_conf``), ``len_lb`` (teacher length bucket) and
    ``wf`` (teacher row parsed well-formed; gates the length loss).
    """
    world = data.world
    qids = list(qids if qids is not None else data.train_qids)
    shuffle = np.random.default_rng(seed)
    model_indices = {m: i for i, m in enumerate(data.models)}

    embs = np.stack([world.embed(data.queries[q]) for q in qids])
    sims, idx = retriever.retrieve(embs, k)

    pairs = [(qi, m) for qi in range(len(qids)) for m in data.models]
    shuffle.shuffle(pairs)
    if max_pairs is not None:
        pairs = pairs[:max_pairs]

    prompts, feats = [], []
    for qi, m in pairs:
        q = data.queries[qids[qi]]
        fp = library.get(m)
        args = (world.models[m], model_indices[m], library.anchor_set, fp,
                sims[qi], idx[qi], q)
        prompts.append(serialization.serialize_prompt(*args))
        feats.append(T0.pair_features(*args))

    batch = estimator.predict_batch(prompts, rng=rng)
    return {
        "qf": np.stack([f[0] for f in feats]),
        "af": np.stack([f[1] for f in feats]),
        "mf": np.stack([f[2] for f in feats]),
        "mid": np.asarray([f[3] for f in feats], np.int32),
        "q": np.asarray(batch.p_conf, np.float32),
        "len_lb": np.asarray([tok.len_bucket(t) for t in batch.len_hat],
                             np.int32),
        "wf": np.asarray(batch.well_formed, bool),
    }


def _tier0_loss(params: Tree, batch: Tree) -> torch.Tensor:
    p_logit, len_logits = T0.tier0_forward(
        params, batch["qf"], batch["af"], batch["mf"], batch["mid"])
    q = batch["q"]
    # soft-label BCE: softplus(x) - q*x == -[q log s(x) + (1-q) log(1-s(x))]
    bce = torch.mean(torch.logaddexp(p_logit, torch.zeros_like(p_logit))
                     - q * p_logit)
    logp = torch.log_softmax(len_logits, dim=-1)
    picked = torch.gather(logp, 1, batch["len_lb"][:, None])[:, 0]
    mask = batch["wf"].float()
    ce = -torch.sum(picked * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return bce + LEN_LOSS_WEIGHT * ce


def tier0_step(params: Tree, opt_state: AdamWState, batch: Tree,
               opt_cfg: AdamWConfig
               ) -> Tuple[Tree, AdamWState, torch.Tensor]:
    """One AdamW step on ``batch`` (tensors on the params' device), the
    params and state updated in place; returns them and the loss before
    the step."""
    loss, _, grads = value_and_grad(
        lambda p: (_tier0_loss(p, batch), {}), params)
    params, opt_state = adamw_update(opt_cfg, grads, opt_state, params)
    return params, opt_state, loss


def fit_temperature(p_logit: np.ndarray, q: np.ndarray,
                    temps: Optional[np.ndarray] = None) -> float:
    """Grid-search the calibration temperature minimizing held-out BCE
    NLL of ``sigmoid(p_logit / T)`` against the teacher's ``q``."""
    if len(p_logit) == 0:
        return 1.0
    if temps is None:
        temps = np.geomspace(0.25, 4.0, 25)
    x = np.asarray(p_logit, np.float64)[None, :] / \
        np.asarray(temps, np.float64)[:, None]
    qq = np.asarray(q, np.float64)[None, :]
    nll = np.mean(np.logaddexp(0.0, x) - qq * x, axis=1)
    return float(temps[int(np.argmin(nll))])


def recalibrate_tier0(head: T0.Tier0Head, p_pred: np.ndarray,
                      y_obs: np.ndarray) -> T0.Tier0Head:
    """Re-temper a trained head against *observed* outcomes (the drift
    hot-swap path: the replay buffer holds the head's served probabilities
    and what the world actually returned).

    The head's raw logit is recovered by inverting its current
    calibration, ``raw = T * logit(p)``, then ``fit_temperature`` re-fits
    on the observed labels — no weight update, parameters are shared with
    the input head (``with_temperature`` keeps the same tensors).
    """
    p = np.clip(np.asarray(p_pred, np.float64), 1e-6, 1.0 - 1e-6)
    raw = head.temperature * np.log(p / (1.0 - p))
    return head.with_temperature(
        fit_temperature(raw, np.asarray(y_obs, np.float64)))


@dataclasses.dataclass
class DistillReport:
    losses: list
    temperature: float
    n_train: int
    n_val: int


def train_tier0(dataset: Dict[str, np.ndarray], *,
                cfg: T0.Tier0Config = T0.Tier0Config(),
                steps: int = 300, batch_size: int = 256,
                opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
                val_frac: float = 0.1, device: DeviceLike = None,
                init: Optional[Tree] = None
                ) -> Tuple[T0.Tier0Head, DistillReport]:
    """Fit the head on ``dataset`` and temperature-calibrate on a held-out
    tail split.  Minibatches are sampled with replacement at a fixed
    ``batch_size`` from ``np.random.default_rng(seed)``, as in the
    reference.  ``init`` gives the starting params (default
    ``init_tier0`` from a generator seeded with ``seed``); the head trains
    on ``device``, the card unless the caller asks for the CPU."""
    n = len(dataset["q"])
    if n == 0:
        raise ValueError("empty tier-0 dataset")
    n_val = min(max(1, int(n * val_frac)), n - 1) if n > 1 else 0
    n_train = n - n_val
    dev = resolve_device(device)
    train = to_tensors({k: v[:n_train] for k, v in dataset.items()}, dev)
    val = {k: v[n_train:] for k, v in dataset.items()}

    if init is None:
        params = T0.init_tier0(torch.Generator(device=dev).manual_seed(seed),
                               cfg, dev)
    else:
        # a copy: the update writes the params in place
        params = {k: v.to(dev, copy=True) for k, v in init.items()}
    opt_cfg = opt_cfg or AdamWConfig(lr=3e-3, warmup_steps=20,
                                     total_steps=steps)
    opt_state = adamw_init(params)
    shuffle = np.random.default_rng(seed)
    bs = min(batch_size, n_train)
    losses = []
    for _ in range(steps):
        take = torch.from_numpy(shuffle.integers(0, n_train, size=bs)).to(dev)
        mb = {k: v[take] for k, v in train.items()}
        params, opt_state, loss = tier0_step(params, opt_state, mb, opt_cfg)
        losses.append(loss)
    losses = torch.stack(losses).tolist() if losses else []

    head = T0.Tier0Head(params, cfg)
    if n_val:
        logit, _ = head.forward_raw(val["qf"], val["af"], val["mf"],
                                    val["mid"])
        head = head.with_temperature(fit_temperature(logit, val["q"]))
    return head, DistillReport(losses=losses, temperature=head.temperature,
                               n_train=n_train, n_val=n_val)


def distill_tier0(data: ScopeData, library: FingerprintLibrary,
                  retriever: AnchorRetriever, estimator, *,
                  k: int = 5, qids: Optional[Sequence[int]] = None,
                  max_pairs: Optional[int] = None,
                  cfg: T0.Tier0Config = T0.Tier0Config(),
                  steps: int = 300, batch_size: int = 256,
                  opt_cfg: Optional[AdamWConfig] = None,
                  seed: int = 0, device: DeviceLike = None
                  ) -> T0.Tier0Head:
    """End-to-end: teacher labels from the reasoning estimator, head fit,
    temperature calibration — returns an engine-ready ``Tier0Head`` on
    ``device``."""
    dataset = build_tier0_dataset(
        data, library, retriever, estimator, k=k, qids=qids,
        max_pairs=max_pairs, seed=seed)
    head, _ = train_tier0(dataset, cfg=cfg, steps=steps,
                          batch_size=batch_size, opt_cfg=opt_cfg, seed=seed,
                          device=device)
    return head
