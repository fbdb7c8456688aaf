"""The reasoning estimator (SCOPE §4.1, Eq. 5).

Wraps the port's LM: conditioned on the serialized retrieval-augmented
prompt it generates a rationale z then the structured tuple (y_hat, l_hat).
Besides the parsed binary label we expose the correctness *confidence*
p(YES)/(p(YES)+p(NO)) at the decision token — Appendix D's p_hat(x, M) in
[0, 1] used by the budget-controlled alpha search.

``Prediction``, ``ParsedBatch`` and the batched numpy parse
``parse_generations`` are those of ``repro/core/estimator.py`` unchanged;
``_parse_one`` remains as the scalar reference the parity tests pin the
batched parse against.  The batch serve path (``predict_batch`` ->
``dispatch_batch`` -> ``sampler.generate_async``) runs on the params'
device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.status import STATUS_OK
from repro_torch.data import tokenizer as tok
from repro_torch.serving import sampler


@dataclasses.dataclass
class Prediction:
    y_hat: int
    len_hat: float
    well_formed: bool
    p_conf: float               # P(correct) in [0, 1]
    pred_tokens: int            # prediction overhead (generated tokens)
    rationale_len: int


@dataclasses.dataclass
class ParsedBatch:
    """Columnar predictions for N generations (the serve-path layout).

    ``status`` (``core.status``) marks how each row was answered: OK rows
    came off a real decode, DEGRADED rows from retrieval priors, FAILED
    rows not at all.  Defaulting to all-OK keeps every existing
    constructor call (and the parser) unchanged.
    """
    y_hat: np.ndarray           # (N,) int
    len_hat: np.ndarray         # (N,) float
    well_formed: np.ndarray     # (N,) bool
    p_conf: np.ndarray          # (N,) float
    pred_tokens: np.ndarray     # (N,) int
    rationale_len: np.ndarray   # (N,) int
    status: Optional[np.ndarray] = None     # (N,) int8, None -> all OK

    def __post_init__(self):
        if self.status is None:
            self.status = np.full(len(self.y_hat), STATUS_OK, np.int8)

    def __len__(self) -> int:
        return len(self.y_hat)

    def to_predictions(self) -> List[Prediction]:
        return [Prediction(int(self.y_hat[i]), float(self.len_hat[i]),
                           bool(self.well_formed[i]), float(self.p_conf[i]),
                           int(self.pred_tokens[i]),
                           int(self.rationale_len[i]))
                for i in range(len(self))]

    @classmethod
    def from_predictions(cls, preds: Sequence[Prediction]) -> "ParsedBatch":
        return cls(
            y_hat=np.asarray([p.y_hat for p in preds], int),
            len_hat=np.asarray([p.len_hat for p in preds], np.float64),
            well_formed=np.asarray([p.well_formed for p in preds], bool),
            p_conf=np.asarray([p.p_conf for p in preds], np.float64),
            pred_tokens=np.asarray([p.pred_tokens for p in preds], int),
            rationale_len=np.asarray([p.rationale_len for p in preds], int))

    @classmethod
    def empty(cls) -> "ParsedBatch":
        return cls.from_predictions([])


def parse_generations(gen: np.ndarray, dec_logits: np.ndarray, *,
                      starts: Optional[np.ndarray] = None,
                      lens: Optional[np.ndarray] = None) -> ParsedBatch:
    """Batched parse of (N, T) generations + (N, T, 2) YES/NO logit pairs.

    Vectorizes ``_parse_one`` (decision-token location, confidence, format
    gate, rationale length) over the whole generation matrix — no per-sample
    or per-token Python loops.

    ``starts``/``lens`` (N,) select a per-row **window** of the buffer: row
    i's generation is ``gen[i, starts[i] : starts[i] + lens[i]]``.  A
    refilled decode slot's tokens start mid-buffer (at the segment boundary
    it was admitted) and stop at its own ``max_new_tokens`` budget, so the
    rows of one continuous-batching buffer are parsed at different offsets;
    positions outside a row's window read as PAD with zero logits, which is
    exactly what a standalone run of the same prompt produces past EOS.
    """
    g = np.asarray(gen)
    if g.ndim != 2:
        raise ValueError(f"gen must be (N, T), got {g.shape}")
    N, T = g.shape
    if N == 0:
        return ParsedBatch.empty()
    dec_logits = np.asarray(dec_logits, np.float64)
    if starts is not None or lens is not None:
        starts = (np.zeros(N, int) if starts is None
                  else np.asarray(starts, int).reshape(-1))
        lens = (np.full(N, T, dtype=int) if lens is None
                else np.asarray(lens, int).reshape(-1))
        if starts.shape != (N,) or lens.shape != (N,):
            raise ValueError(
                f"starts/lens must be ({N},), got {starts.shape}/{lens.shape}")
        if (starts < 0).any() or (lens < 0).any() or (starts + lens > T).any():
            raise ValueError(
                f"row windows must lie inside the (N, {T}) buffer")
        W = max(int(lens.max()), 1)
        cols_w = np.arange(W)[None, :]
        valid = cols_w < lens[:, None]
        idx = np.clip(starts[:, None] + cols_w, 0, T - 1)
        rows_w = np.arange(N)[:, None]
        g = np.where(valid, g[rows_w, idx], tok.PAD)
        dec_logits = np.where(valid[:, :, None], dec_logits[rows_w, idx], 0.0)
        T = W
    rows = np.arange(N)
    cols = np.arange(T)[None, :]

    is_think = g == tok.THINK
    is_tend = g == tok.THINK_END
    has_think = is_think.any(axis=1)
    has_tend = is_tend.any(axis=1)
    cot = has_think & has_tend
    first_think = np.argmax(is_think, axis=1)
    first_tend = np.argmax(is_tend, axis=1)

    # --- format gate (tok.parse_prediction): strip the CoT span, drop PADs,
    # require body == (YES|NO) LEN_b EOS ... -----------------------------
    body_start = np.where(cot, first_tend + 1, 0)
    body_mask = (cols >= body_start[:, None]) & (g != tok.PAD)
    n_body = body_mask.sum(axis=1)
    # stable argsort floats body positions to the front, original order kept
    order = np.argsort(~body_mask, axis=1, kind="stable")
    first3 = order[:, :3] if T >= 3 else np.zeros((N, 3), int)
    b0, b1, b2 = (g[rows, first3[:, j]] for j in range(3))
    wf = ((~has_think | has_tend) & (n_body >= 3)
          & ((b0 == tok.YES) | (b0 == tok.NO))
          & (b1 >= tok.LEN_BASE) & (b1 < tok.LEN_BASE + tok.NUM_LEN_BUCKETS)
          & (b2 == tok.EOS))
    y_hat = np.where(wf, (b0 == tok.YES).astype(int), 0)
    len_hat = np.where(
        wf, tok.LEN_CENTERS[np.clip(b1 - tok.LEN_BASE, 0,
                                    tok.NUM_LEN_BUCKETS - 1)], 0.0)

    # --- decision step: first YES/NO after THINK_END (CoT) or from 0 ----
    dec_search = ((g == tok.YES) | (g == tok.NO)) & (
        cols >= np.where(cot, first_tend + 1, 0)[:, None])
    has_dec = dec_search.any(axis=1)
    dec_pos = np.argmax(dec_search, axis=1)
    d = dec_logits[rows, dec_pos]                       # (N, 2) = (YES, NO)
    m = d.max(axis=1)
    py = np.exp(d[:, 0] - m)
    pn = np.exp(d[:, 1] - m)
    conf = np.where(has_dec, py / (py + pn), 0.5)

    return ParsedBatch(
        y_hat=y_hat, len_hat=len_hat, well_formed=wf, p_conf=conf,
        pred_tokens=(g != tok.PAD).sum(axis=1),
        rationale_len=np.where(cot, first_tend - first_think + 1, 0))


@dataclasses.dataclass
class DecodeHandle:
    """In-flight generation: device tensors dispatched, not yet parsed.

    ``parse`` copies each chunk to the host in one transfer
    (``sampler.to_host``) and runs the batched parse.
    """
    chunks: List[tuple]             # [(gen (b, T), dec (b, T, 2)), ...]

    def parse(self) -> ParsedBatch:
        if not self.chunks:
            return ParsedBatch.empty()
        host = [sampler.to_host(g, d) for g, d in self.chunks]
        return parse_generations(np.concatenate([g for g, _ in host], axis=0),
                                 np.concatenate([d for _, d in host], axis=0))


class ReasoningEstimator:
    def __init__(self, cfg: ModelConfig, params, *, cot: bool = True,
                 max_new_tokens: int = 12, batch_size: int = 256):
        self.cfg = cfg
        self.params = params
        self.cot = cot
        self.max_new_tokens = max_new_tokens
        self.batch_size = batch_size

    # ------------------------------------------------------------------
    def dispatch_batch(self, prompts, *, prompt_lens=None,
                       temperature: float = 0.0,
                       rng: Optional[torch.Generator] = None) -> DecodeHandle:
        """Launch generation for a batch and return without blocking.

        ``prompts`` may be a list of constant-length token lists or an
        already-assembled (b, L) int array; ``prompt_lens`` (b,) marks true
        per-row lengths.  Chunks of ``batch_size`` rows decode one after
        another; ``rng`` (a ``torch.Generator``) is drawn from in order.
        """
        if len(prompts) == 0:
            return DecodeHandle([])
        if prompt_lens is None:
            lens = {len(p) for p in prompts}
            if len(lens) != 1:
                raise ValueError("structured prompts must be constant-length")
        arr = np.asarray(prompts, np.int32)
        chunks = []
        for i in range(0, len(arr), self.batch_size):
            pl = (None if prompt_lens is None
                  else np.asarray(prompt_lens)[i: i + self.batch_size])
            chunks.append(sampler.generate_async(
                self.params, self.cfg, arr[i: i + self.batch_size],
                max_new_tokens=self.max_new_tokens, temperature=temperature,
                generator=rng, prompt_lens=pl))
        return DecodeHandle(chunks)

    def predict_batch(self, prompts: List[List[int]], *,
                      prompt_lens=None, temperature: float = 0.0,
                      rng: Optional[torch.Generator] = None) -> ParsedBatch:
        """Columnar predictions — the serve hot path (no per-pair objects)."""
        if len(prompts) == 0:
            return ParsedBatch.empty()
        return self.dispatch_batch(prompts, prompt_lens=prompt_lens,
                                   temperature=temperature,
                                   rng=rng).parse()

    def predict(self, prompts: List[List[int]], *,
                temperature: float = 0.0,
                rng: Optional[torch.Generator] = None) -> List[Prediction]:
        return self.predict_batch(prompts, temperature=temperature,
                                  rng=rng).to_predictions()

    # ------------------------------------------------------------------
    @staticmethod
    def _parse_one(gen: np.ndarray, dec_logits: np.ndarray) -> Prediction:
        """Scalar reference parse for one generation; ``dec_logits`` is the
        (T, 2) YES/NO logit pair per step.  Kept as the parity oracle for
        ``parse_generations``."""
        toks = [int(t) for t in gen]
        parsed = tok.parse_prediction(toks)
        # locate the decision step: first YES/NO after THINK_END (CoT) or at 0
        dec_pos = None
        start = 0
        if tok.THINK in toks and tok.THINK_END in toks:
            start = toks.index(tok.THINK_END) + 1
        for j in range(start, len(toks)):
            if toks[j] in (tok.YES, tok.NO):
                dec_pos = j
                break
        if dec_pos is not None:
            row = np.asarray(dec_logits[dec_pos], np.float64)
            m = max(row[0], row[1])
            py = np.exp(row[0] - m)
            pn = np.exp(row[1] - m)
            conf = float(py / (py + pn))
        else:
            conf = 0.5
        n_gen = int(np.sum(np.asarray(toks) != tok.PAD))
        rat = 0
        if tok.THINK in toks and tok.THINK_END in toks:
            rat = toks.index(tok.THINK_END) - toks.index(tok.THINK) + 1
        return Prediction(
            y_hat=parsed["y_hat"], len_hat=parsed["len_hat"],
            well_formed=parsed["well_formed"], p_conf=conf,
            pred_tokens=n_gen, rationale_len=rat)
