"""Stage 2: GRPO alignment (SCOPE §4.3, Eq. 6; GRPO per Shao et al. 2024).

The port of ``repro/training/grpo.py``.  Per task (query, model): sample a
group of G rollouts from the current policy, score them with the gated
composite reward (format gate x (R_corr + R_token with adaptive
tolerance)), normalize advantages within the group, and apply a
token-level PPO-clip policy gradient with a k3 KL penalty toward the SFT
reference policy.  Tasks come from ``np.random.default_rng(seed)`` as in
the reference; rollouts from ``serving.sampler`` with an explicit
``torch.Generator`` (greedy rollouts need none).  The params are trained
in place; the reference policy is a copy made when the trainer starts.

Params sharded over a device mesh (``ReasoningEstimator.shard``) train as
they are, and the reference policy is a copy of the rank's blocks.  Each
rank generates its serve rows of the rollouts (``sampler.mesh_rows``),
which are gathered, so every rank scores the same tokens; the log-probs
and the loss take the rank's training rows (``model.local_batch``), and
the loss and its metrics are the whole batch's on every rank.  Every rank
of the mesh must make the same calls.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import rewards as rw
from repro_torch.core import serialization
from repro_torch.core.fingerprint import FingerprintLibrary
from repro_torch.core.retrieval import AnchorRetriever
from repro_torch.data import tokenizer as tok
from repro_torch.data.datasets import ScopeData
from repro_torch.data.pipeline import to_tensors
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.io import tree_map
from repro_torch.models import model as M
from repro_torch.serving import sampler
from repro_torch.training.optimizer import (
    AdamWConfig, AdamWState, adamw_init, adamw_update, value_and_grad)


@dataclasses.dataclass
class GRPOConfig:
    group_size: int = 4
    tasks_per_step: int = 16
    temperature: float = 1.0
    clip_eps: float = 0.2
    kl_coef: float = 0.02
    max_new_tokens: int = 12
    inner_epochs: int = 1


# ---------------------------------------------------------------------------
# Token-level log-probs of a generated suffix
# ---------------------------------------------------------------------------
def sequence_logprobs(params, cfg: ModelConfig, tokens: torch.Tensor,
                      gen_mask: torch.Tensor, *, lay=None):
    """tokens: (B, L) prompt+generation; gen_mask marks generated positions.
    Returns per-position logp of tokens[t] for masked t (shifted), and the
    shifted mask.  ``lay`` as ``model.forward_train``'s: with
    ``model.local_batch``'s, the rows are this rank's."""
    logits, _ = M.forward_train(params, cfg, {"tokens": tokens}, lay=lay)
    logp = torch.log_softmax(logits.float(), dim=-1)
    # position t-1 predicts token t
    tgt = tokens[:, 1:]
    lp = torch.gather(logp[:, :-1], -1, tgt[..., None])[..., 0]
    mask = gen_mask[:, 1:].float()
    return lp * mask, mask


def grpo_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
              clip_eps: float, kl_coef: float):
    """The PPO-clip loss with the k3 KL penalty over ``batch``'s generated
    tokens.  On sharded params a rank computes its own rows
    (``model.local_batch``): the token count is the whole batch's, the
    rank's share of the loss is summed over ``data`` as ``loss_fn``'s
    cross-entropy is, and ``pg`` / ``kl`` are the whole batch's."""
    batch, lay = M.local_batch(params, cfg, batch)
    lp, mask = sequence_logprobs(params, cfg, batch["tokens"],
                                 batch["gen_mask"], lay=lay)
    old_lp = batch["old_logp"]
    ref_lp = batch["ref_logp"]
    adv = batch["adv"][:, None]

    ratio = torch.exp(lp - old_lp)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
    pg = -torch.minimum(unclipped, clipped)

    # k3 KL estimator toward the reference policy
    delta = ref_lp - lp
    kl = torch.exp(delta) - delta - 1.0

    count = torch.sum(mask)
    denom = torch.clamp(count if lay is None else lay.summed(count),
                        min=1.0)
    loss = torch.sum((pg + kl_coef * kl) * mask) / denom
    pg_m = torch.sum(pg * mask) / denom
    kl_m = torch.sum(kl * mask) / denom
    if lay is not None:
        loss, pg_m, kl_m = (lay.total(loss), lay.summed(pg_m),
                            lay.summed(kl_m))
    return loss, {"pg": pg_m, "kl": kl_m}


def grpo_step(params, cfg: ModelConfig, opt_state: AdamWState,
              batch: Dict[str, torch.Tensor], opt_cfg: AdamWConfig,
              clip_eps: float, kl_coef: float):
    """One AdamW step on the GRPO loss, params and state in place (each
    rank's blocks, for sharded params).  Returns them, the loss before the
    step and its metrics (``pg``, ``kl``)."""
    loss, metrics, grads = value_and_grad(
        lambda p: grpo_loss(p, cfg, batch, clip_eps, kl_coef), params)
    params, opt_state = adamw_update(opt_cfg, grads, opt_state, params)
    return params, opt_state, loss, metrics


# ---------------------------------------------------------------------------
# Rollout + training loop
# ---------------------------------------------------------------------------
class GRPOTrainer:
    """``generator`` draws the rollouts' samples; a rollout at temperature
    > 0 without one raises (``sampler.generate``'s contract)."""

    def __init__(self, cfg: ModelConfig, params, data: ScopeData,
                 library: FingerprintLibrary, retriever: AnchorRetriever, *,
                 gcfg: Optional[GRPOConfig] = None,
                 opt_cfg: Optional[AdamWConfig] = None,
                 k: int = 5, cot: bool = True, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.params = params
        self.ref_params = tree_map(torch.clone, params)
        self.data = data
        self.library = library
        self.retriever = retriever
        self.gcfg = gcfg or GRPOConfig()
        self.opt_cfg = opt_cfg or AdamWConfig(lr=2e-4, warmup_steps=10,
                                              total_steps=1000)
        self.opt_state = adamw_init(params)
        self.k = k
        self.cot = cot
        self.rng = np.random.default_rng(seed)
        self.generator = generator
        self.model_indices = {m: i for i, m in enumerate(data.models)}
        self.reward_history: List[float] = []

    # ------------------------------------------------------------------
    def _sample_tasks(self, n: int):
        qids = self.rng.choice(self.data.train_qids, size=n)
        models = self.rng.choice(self.data.models, size=n)
        return list(zip(qids.tolist(), models.tolist(), strict=True))

    def _build_prompts(self, tasks):
        world = self.data.world
        embs = np.stack([world.embed(self.data.queries[q]) for q, _ in tasks])
        sims, idx = self.retriever.retrieve(embs, self.k)
        prompts, gts = [], []
        for t, (qid, m) in enumerate(tasks):
            q = self.data.queries[qid]
            rec = self.data.record(qid, m)
            fp = self.library.get(m)
            prompts.append(serialization.serialize_prompt(
                world.models[m], self.model_indices[m],
                self.library.anchor_set, fp, sims[t], idx[t], q))
            gts.append((rec.y, rec.tokens))
        return prompts, gts

    # ------------------------------------------------------------------
    def rollout_step(self) -> Dict:
        g = self.gcfg.group_size
        tasks = self._sample_tasks(self.gcfg.tasks_per_step)
        prompts, gts = self._build_prompts(tasks)
        lp_len = len(prompts[0])

        # tile each prompt G times → one batched generation pass, this
        # rank's rows of it, gathered
        tiled = np.repeat(np.asarray(prompts, np.int32), g, axis=0)
        B = len(tiled)
        mesh = coll.mesh_of(self.params)
        rows = sampler.mesh_rows(mesh, self.cfg, B)
        gen, dec = sampler.generate_async(
            self.params, self.cfg, tiled,
            max_new_tokens=self.gcfg.max_new_tokens,
            temperature=self.gcfg.temperature, generator=self.generator,
            rows=rows)
        gen, _ = sampler.to_host(*sampler.gather_rows(mesh, rows, B, gen,
                                                      dec))

        L = lp_len + self.gcfg.max_new_tokens
        tokens = np.concatenate([tiled, gen], axis=1)
        gen_mask = np.zeros((B, L), np.float32)
        rewards = np.zeros(B, np.float32)
        well_formed = np.zeros(B, bool)
        for i in range(B):
            y_gt, len_gt = gts[i // g]
            toks = [int(t) for t in gen[i]]
            parsed = tok.parse_prediction(toks)
            well_formed[i] = bool(parsed.get("well_formed", False))
            rewards[i] = rw.grpo_reward(parsed, y_gt, len_gt)
            # mask: generated positions up to & including EOS (or all)
            upto = toks.index(tok.EOS) + 1 if tok.EOS in toks else len(toks)
            gen_mask[i, lp_len: lp_len + upto] = 1.0

        # group-normalized advantages
        r = rewards.reshape(-1, g)
        adv = (r - r.mean(axis=1, keepdims=True)) / (r.std(axis=1, keepdims=True) + 1e-6)
        adv = adv.reshape(-1)

        batch = to_tensors({"tokens": tokens, "gen_mask": gen_mask,
                            "adv": adv}, sampler.params_device(self.params))
        # the old and reference log-probs of this rank's rows, gathered
        local, lay = M.local_batch(self.params, self.cfg, batch)
        split = local["tokens"].shape[0] < B
        with torch.no_grad():
            for key, params in (("old_logp", self.params),
                                ("ref_logp", self.ref_params)):
                lp, _ = sequence_logprobs(params, self.cfg, local["tokens"],
                                          local["gen_mask"], lay=lay)
                batch[key] = shd.gather_rows(mesh, B, lp) if split else lp

        for _ in range(self.gcfg.inner_epochs):
            self.params, self.opt_state, loss, metrics = grpo_step(
                self.params, self.cfg, self.opt_state, batch, self.opt_cfg,
                self.gcfg.clip_eps, self.gcfg.kl_coef)
        mean_r = float(rewards.mean())
        self.reward_history.append(mean_r)
        # the actual gate pass rate — NOT np.mean(rewards > 0), which
        # miscounts well-formed rollouts whose composite reward is zero
        return {"reward": mean_r, "loss": float(loss),
                "kl": float(metrics["kl"]),
                "format_rate": float(np.mean(well_formed))}

    def train(self, steps: int, *, verbose: bool = False,
              log_every: int = 10) -> List[float]:
        for s in range(steps):
            info = self.rollout_step()
            if verbose and (s + 1) % log_every == 0:
                print(f"  grpo step {s+1}: reward {info['reward']:.3f} "
                      f"kl {info['kl']:.4f}")
        return self.reward_history
