"""Batched serving engine.

The port of ``repro/serving/engine.py``.  Collects requests, pads them into
fixed-size batches, runs prefill+decode via ``sampler.generate``, and
returns per-request results.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import PAD
from repro_torch.serving import sampler


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]


@dataclasses.dataclass
class Result:
    rid: int
    tokens: np.ndarray           # (T,) generated
    decision_logits: np.ndarray  # (T, 2) per-step (YES, NO) logit pair


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig, *, batch_size: int = 32,
                 max_new_tokens: int = 12, temperature: float = 0.0):
        self.params = params
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self._queue: List[Request] = []
        self._next_rid = 0

    def submit(self, prompt: Sequence[int]) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, list(prompt)))
        return rid

    def run(self, generator: Optional[torch.Generator] = None
            ) -> Dict[int, Result]:
        """Drain the queue in fixed-size batches (last batch padded).

        Stochastic decoding (temperature > 0) requires an explicit
        ``generator``, drawn from batch after batch — the sampler raises
        without one.
        """
        results: Dict[int, Result] = {}
        queue, self._queue = self._queue, []
        if not queue:
            return results
        lp = max(len(r.prompt) for r in queue)
        for i in range(0, len(queue), self.batch_size):
            chunk = queue[i: i + self.batch_size]
            prompts = np.full((self.batch_size, lp), PAD, np.int32)
            for j, r in enumerate(chunk):
                prompts[j, : len(r.prompt)] = r.prompt
            gen, lg = sampler.generate(
                self.params, self.cfg, prompts,
                max_new_tokens=self.max_new_tokens,
                temperature=self.temperature, generator=generator)
            for j, r in enumerate(chunk):
                results[r.rid] = Result(r.rid, gen[j], lg[j])
        return results
