"""The reasoning estimator (SCOPE §4.1, Eq. 5).

Wraps the port's LM: conditioned on the serialized retrieval-augmented
prompt it generates a rationale z then the structured tuple (y_hat, l_hat).
Besides the parsed binary label we expose the correctness *confidence*
p(YES)/(p(YES)+p(NO)) at the decision token — Appendix D's p_hat(x, M) in
[0, 1] used by the budget-controlled alpha search.

``Prediction``, ``ParsedBatch``, the batched numpy parse
``parse_generations`` and ``FallbackEstimator`` are those of
``repro/core/estimator.py`` unchanged; ``_parse_one`` remains as the scalar
reference the parity tests pin the batched parse against.  The batch serve
path (``predict_batch`` -> ``dispatch_batch`` -> ``sampler.generate_async``)
and the continuous-batching slot state (``open_slots`` -> ``SlotRun``) run
on the params' device.

``shard(mesh)`` serves over a device mesh, one process a device: the params
become DTensors placed per ``distributed.sharding.param_specs`` (FSDP on
``data``, TP on ``model``), the model gathers each layer over ``data``
just before it runs (``distributed.collectives``) and computes its own
heads and MLP columns where ``model`` splits them, so each rank's decode
caches and page pool hold its own kv-heads; each rank prefills and decodes
its own rows of the batch (``batch_specs``), and the rows' tokens,
decision logits and done-masks are all-gathered over ``data``, so every
rank ends a call with the whole batch's results and the same host state —
what the reference's global arrays give.  A batch whose rows do not divide over ``data`` is computed whole on
every rank, and so is every batch of a MoE backbone: its routing groups
span the batch, so a rank routing only its own rows would drop other
tokens at capacity than one process does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.status import (STATUS_DEGRADED, STATUS_FAILED,
                                     STATUS_OK)
from repro_torch.data import tokenizer as tok
from repro_torch.distributed import sharding as shd
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


class FallbackEstimator:
    """Degraded-mode estimator: answers a (query, model) pair from
    retrieval priors instead of a reasoning decode.

    The prediction is the similarity-weighted outcome of the model's
    fingerprint at the query's nearest anchors — the same signal the
    serialized prompt shows the reasoning estimator, minus the reasoning:
    ``p_conf`` is the weighted anchor correctness, ``len_hat`` the
    weighted anchor completion tokens, and ``y_hat = p_conf >= 0.5``.
    Zero decode tokens are spent, rows are marked ``STATUS_DEGRADED``,
    and ``well_formed=True`` so the cost model prices the predicted
    length rather than the malformed-estimate pessimistic fallback.
    """

    def __init__(self, library):
        self.library = library

    def predict_pairs(self, sims: np.ndarray, idx: np.ndarray,
                      models: Sequence[str]) -> ParsedBatch:
        """One degraded prediction per row of (N, K) ``sims``/``idx``."""
        sims = np.atleast_2d(np.asarray(sims, np.float64))
        idx = np.atleast_2d(np.asarray(idx, int))
        n = len(models)
        p = np.zeros(n, np.float64)
        len_hat = np.zeros(n, np.float64)
        for i, model in enumerate(models):
            fp = self.library.get(model)
            w = np.clip(sims[i], 0.0, None)
            total = w.sum()
            w = w / total if total > 0 else np.full(len(w), 1.0 / len(w))
            p[i] = float(w @ np.asarray(fp.y, np.float64)[idx[i]])
            len_hat[i] = float(w @ np.asarray(fp.tokens,
                                              np.float64)[idx[i]])
        return ParsedBatch(
            y_hat=(p >= 0.5).astype(int), len_hat=len_hat,
            well_formed=np.ones(n, bool), p_conf=p,
            pred_tokens=np.zeros(n, int), rationale_len=np.zeros(n, int),
            status=np.full(n, STATUS_DEGRADED, np.int8))

    @staticmethod
    def failed_pairs(n: int) -> ParsedBatch:
        """All-FAILED rows for when degradation itself is disabled: the
        malformed-estimate shape (``well_formed=False``, ``p_conf=0``)
        so policies price these pairs at the pessimistic fallback."""
        return ParsedBatch(
            y_hat=np.zeros(n, int), len_hat=np.zeros(n, np.float64),
            well_formed=np.zeros(n, bool), p_conf=np.zeros(n, np.float64),
            pred_tokens=np.zeros(n, int), rationale_len=np.zeros(n, int),
            status=np.full(n, STATUS_FAILED, np.int8))


@dataclasses.dataclass
class DecodeHandle:
    """In-flight generation: device tensors dispatched, not yet parsed.

    ``is_ready`` polls without blocking: ``event`` is a CUDA event recorded
    on the stream right after the dispatch (None for work on the CPU, which
    is done when the call returns).  ``parse`` copies each chunk to the host
    in one transfer (``sampler.to_host``) and runs the batched parse.
    ``windows`` optionally carries one (start, length) pair per row of the
    concatenated buffer — the per-row windows of a segment-chunked decode
    whose refilled rows start mid-buffer.
    """
    chunks: List[tuple]             # [(gen (b, T), dec (b, T, 2)), ...]
    windows: Optional[List[tuple]] = None   # [(start, length)] per row
    event: Optional["torch.cuda.Event"] = None

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def parse(self) -> ParsedBatch:
        if not self.chunks:
            return ParsedBatch.empty()
        host = [sampler.to_host(g, d) for g, d in self.chunks]
        starts = lens = None
        if self.windows is not None:
            starts = np.asarray([w[0] for w in self.windows], int)
            lens = np.asarray([w[1] for w in self.windows], int)
        return parse_generations(np.concatenate([g for g, _ in host], axis=0),
                                 np.concatenate([d for _, d in host], axis=0),
                                 starts=starts, lens=lens)


def _dispatched_event(device: torch.device) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded now on ``device``'s current stream, or None
    on the CPU."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


@dataclasses.dataclass
class _Slot:
    """One live request occupying a decode slot.

    ``prompt`` keeps the row's serialized tokens so a failed row can be
    requeued into the scheduler without a reverse lookup.
    """
    tag: object
    start: int              # decode-step offset of its window in the run
    refilled: bool
    prompt: List[int] = dataclasses.field(default_factory=list)


class SlotRun:
    """One live continuous-batching decode state (the refill serve path).

    Wraps a ``sampler.DecodeState`` over a fixed (b, L) bucket and drives
    it in ``segment_len``-step decode segments: after each segment, rows that
    drained at EOS (or exhausted the per-request ``max_new_tokens`` budget)
    are parsed from their own window of the accumulated decode buffer and
    their slot freed; ``admit`` prefills freshly popped prompts into the
    free slots — one batched prefill of the slot-aligned (b, L) prompt
    matrix per boundary, however many slots drain together.  The slot
    cache is allocated ``horizon`` decode steps deep (default 4x the
    budget, rounded up to whole segments) so a slot serves several requests
    back-to-back before the state retires; ``can_admit`` turns False once
    the remaining horizon cannot fit a full budget — a request is never
    admitted into a window it could not finish, so every admitted request
    decodes exactly the window a standalone run would.
    """

    def __init__(self, estimator: "ReasoningEstimator", tokens, *,
                 lengths=None, tags=None, segment_len: int = 4,
                 horizon: Optional[int] = None,
                 rng: Optional[torch.Generator] = None,
                 kv_pool=None, kv_kernel=None):
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 2:
            raise ValueError(f"tokens must be (b, L), got {tokens.shape}")
        b, L = tokens.shape
        self.est = estimator
        self.batch = b
        self.width = L
        self.budget = int(estimator.max_new_tokens)
        self.segment_len = int(segment_len)
        if not 1 <= self.segment_len <= self.budget:
            raise ValueError(
                f"segment_len must lie in [1, {self.budget}] "
                f"(max_new_tokens), got {segment_len}")
        # a request admitted at a boundary is freed at the first boundary
        # >= budget steps later, so a row writes at most this many decode
        # slots past its prompt — the paged per-row capacity and the unit
        # the host decode buffers grow by
        self.budget_steps = -(-self.budget // self.segment_len) \
            * self.segment_len
        self.kv_pool = kv_pool
        if kv_pool is None:
            horizon = int(horizon) if horizon else 4 * self.budget
            horizon = max(horizon, self.budget)
            # whole segments only: a window admitted while can_admit()
            # holds always completes by the horizon boundary
            self.horizon = -(-horizon // self.segment_len) \
                * self.segment_len
            buf = self.horizon
        else:
            # paged mode has no shared horizon: admission is gated on free
            # pages and the host buffers grow per segment instead
            self.horizon = None
            buf = self.budget_steps
        tags = list(tags) if tags is not None else list(range(b))
        if len(tags) > b:
            raise ValueError(f"{len(tags)} tags for {b} slots")
        lens = None if lengths is None else np.asarray(lengths, int)
        # per-row true lengths only when genuinely ragged: exact-fit
        # buckets stay on the unmasked path (SSM backbones included)
        pl = lens if lens is not None and (lens != L).any() else None
        # the run binds the params it opened on (a hot swap leaves it
        # alone); this rank's rows
        self.params = estimator.params
        self.rows = estimator.local_rows(b)
        if kv_pool is None:
            self.state = sampler.prefill_state(
                self.params, estimator.cfg, tokens,
                max_new_tokens=self.horizon, prompt_lens=pl, generator=rng,
                rows=self.rows)
        else:
            # every rank keeps the whole page bookkeeping and a pool of the
            # same size, and writes only its own rows' pages
            self.state = sampler.prefill_state(
                self.params, estimator.cfg, tokens,
                max_new_tokens=self.budget_steps, prompt_lens=pl,
                generator=rng, kv_pool=kv_pool,
                kv_kernel=kv_kernel or "xla",
                kv_active=np.arange(b) < len(tags), rows=self.rows)
        # rows past the real tags are free slots from the start (a
        # partially-filled opening bucket refills instead of padding)
        true_lens = lens if lens is not None else np.full(b, L, int)
        self.slots: List[Optional[_Slot]] = [
            _Slot(tags[i], 0, False,
                  prompt=tokens[i, : int(true_lens[i])].tolist())
            if i < len(tags) else None
            for i in range(b)]
        self.steps_run = 0                  # decode steps *launched*
        self.steps_done = 0                 # decode steps synced to host
        # host copy of the decode buffer, written once per segment
        self._gen = np.full((b, buf), -1, np.int32)
        self._dec = np.zeros((b, buf, 2), np.float32)
        # slot-aligned refills admitted since the last launch; fused into
        # the next ``decode_segment(refill=...)`` call
        self._pending: Optional[tuple] = None
        self._inflight: Optional[tuple] = None  # (gen, dec, done) futures
        # decode-slot accounting (token granularity; folded into
        # SchedulerStats by ``account``)
        self.slot_steps_total = 0
        self.slot_steps_active = 0
        self.refill_steps = 0               # active steps on refilled rows

    # -- slot bookkeeping ----------------------------------------------
    @property
    def n_live(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def finished(self) -> bool:
        return self.n_live == 0

    def free_rows(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def paged(self) -> bool:
        return self.kv_pool is not None

    def can_admit(self) -> bool:
        """Whether one more request may be admitted into a free slot.

        Dense mode gates on the remaining horizon fitting a full budget;
        paged mode gates on the pool having a worst-case row's pages free
        — the ``refill_horizon`` ceiling does not exist there, so a
        queued prompt drains as soon as pages free up, however long the
        run has already decoded.
        """
        if self.paged:
            return self.state.paged.can_admit(self.width)
        return self.steps_run + self.budget <= self.horizon

    @property
    def deferral_reason(self) -> str:
        """Which resource a ``can_admit() == False`` boundary waits on
        (the stats counter the serve runtime bumps)."""
        return "pages" if self.paged else "horizon"

    def admit(self, items: Sequence[tuple]) -> None:
        """Refill free slots with ``items`` = [(tag, prompt, length)].

        Admissions are **deferred and fused**: every refill collected at a
        boundary rides the next ``decode_segment(refill=...)`` call — the
        slot-aligned prompt matrix is prefilled, merged, and decoded in
        one call, so a boundary costs one prefill however many slots
        drained.  Each refilled row's window starts at the
        current boundary (``steps_run``).
        """
        if not items:
            return
        if self._inflight is not None:
            raise RuntimeError(
                "cannot admit while a segment is in flight — sync() first")
        free = self.free_rows()
        if len(items) > len(free):
            raise ValueError(
                f"{len(items)} refills for {len(free)} free slots")
        if self._pending is None:
            self._pending = (np.zeros(self.batch, bool),
                             np.full((self.batch, self.width), tok.PAD,
                                     np.int32),
                             np.ones(self.batch, np.int64))
        mask, mat, lens = self._pending
        for (tag, prompt, length), row in zip(items, free, strict=False):
            if not self.can_admit():
                raise ValueError(
                    "cannot admit: the kv pool has no room for a "
                    "worst-case row" if self.paged else
                    "remaining horizon cannot fit a full decode budget")
            p = np.asarray(prompt, np.int32).reshape(-1)
            if not 1 <= len(p) <= self.width:
                raise ValueError(
                    f"refill prompt of {len(p)} tokens does not fit the "
                    f"slot width {self.width}")
            mask[row] = True
            mat[row] = tok.PAD
            mat[row, : len(p)] = p
            lens[row] = int(length) if length else len(p)
            if self.paged:
                # reserve the row's pages NOW so the next can_admit()
                # check sees the pool as the coming launch will leave it
                self.state.paged.pre_admit(row, int(lens[row]))
            self.slots[row] = _Slot(tag, self.steps_run, True,
                                    prompt=p.tolist())

    # -- failure surface (serve-runtime fault tolerance) ---------------
    @property
    def in_flight(self) -> bool:
        """Whether a launched segment is awaiting ``sync``."""
        return self._inflight is not None

    def live_rows(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def pick_live_row(self, k: int) -> Optional[int]:
        """The k-th live row (mod the live count) — how an injected pool
        fault selects its victim deterministically."""
        live = self.live_rows()
        return live[int(k) % len(live)] if live else None

    def starved_rows(self) -> List[int]:
        """Live rows the next segment's page allocation would starve
        (paged mode; always empty within reserved budgets)."""
        if not self.paged:
            return []
        return self.state.paged.starved_rows(self.segment_len)

    def fail_row(self, row: int) -> Optional[tuple]:
        """Row-level failure (KV pool exhaustion, injected or real):
        release the row's pages and free its slot, returning
        ``(tag, prompt)`` for requeue.  The slot decodes PAD into the
        trash page until the state retires — exactly a retired row."""
        slot = self.slots[row]
        if slot is None:
            return None
        self.slots[row] = None
        if self.paged:
            self.state.paged.retire_row(row)
        return (slot.tag, slot.prompt)

    def abort(self) -> List[tuple]:
        """Tear down a poisoned run: release every live row's pages,
        drop pending refills and in-flight futures, and return the live
        ``(tag, prompt)`` pairs for requeue.  The state is dead afterwards
        (``finished`` is True); rows already completed by ``sync`` are
        *not* returned — they parsed (or will parse) normally."""
        failed = []
        for row in self.live_rows():
            failed.append(self.fail_row(row))
        self._pending = None
        self._inflight = None
        return failed

    # -- decode --------------------------------------------------------
    def launch(self) -> None:
        """Dispatch the next decode segment without blocking, fusing any
        pending refills into the same call.  ``sync`` collects it;
        launching before the host parses the previous boundary overlaps
        host work with device decode."""
        if self._inflight is not None:
            raise RuntimeError("a segment is already in flight")
        if not self.paged and \
                self.steps_run + self.segment_len > self.horizon:
            raise RuntimeError(
                f"segment overruns the {self.horizon}-step slot horizon")
        self.state, g, d = sampler.decode_segment(
            self.params, self.est.cfg, self.state, self.segment_len,
            refill=self._pending)
        self._pending = None
        # every rank decides the next boundary on the whole batch's tokens
        # and done-mask
        self._inflight = sampler.gather_rows(self.est.mesh, self.rows,
                                             self.batch, g, d,
                                             self.state.done)
        self.steps_run += self.segment_len
        self.slot_steps_total += self.batch * self.segment_len

    def sync(self) -> List[tuple]:
        """Block on the in-flight segment (launching one first if needed)
        and free the slots whose rows completed at this boundary.

        Returns the freed ``(row, slot)`` pairs for ``parse_completed`` —
        the parse is split off so the serve runtime can launch the next
        segment *before* parsing, keeping the device busy while the host
        assembles results.
        """
        if self._inflight is None:
            self.launch()
        g, d, done = self._inflight
        self._inflight = None
        t0, t1 = self.steps_done, self.steps_done + self.segment_len
        if t1 > self._gen.shape[1]:
            # paged runs have no horizon, so the host buffers grow in
            # budget-sized chunks as the run outlives its initial window
            grow = -(-(t1 - self._gen.shape[1]) // self.budget_steps) \
                * self.budget_steps
            self._gen = np.concatenate(
                [self._gen, np.full((self.batch, grow), -1, np.int32)], 1)
            self._dec = np.concatenate(
                [self._dec,
                 np.zeros((self.batch, grow, 2), np.float32)], 1)
        # the segment's tokens, decision logits and done-mask reach the
        # host in one copy
        self._gen[:, t0:t1], self._dec[:, t0:t1], done = sampler.to_host(
            g, d, done)
        self.steps_done = t1
        completed = []
        for row, slot in enumerate(self.slots):
            if slot is None:
                continue
            if bool(done[row]) or t1 - slot.start >= self.budget:
                completed.append((row, slot))
                self.slots[row] = None
                if self.paged:
                    # hand the row's pages back the moment it drains —
                    # its table entries fall back to the trash page, so
                    # the still-running PAD decode scatters harmlessly
                    self.state.paged.retire_row(row)
        return completed

    def parse_completed(self, completed: List[tuple]):
        """(tags, ParsedBatch) for the rows ``sync`` freed: each row's
        generation is its own window of the decode buffer."""
        if not completed:
            return [], ParsedBatch.empty()
        rows = [r for r, _ in completed]
        starts = np.asarray([s.start for _, s in completed], int)
        lens = np.minimum(self.budget, self.steps_done - starts)
        batch = parse_generations(self._gen[rows, : self.steps_done],
                                  self._dec[rows, : self.steps_done],
                                  starts=starts, lens=lens)
        self.slot_steps_active += int(batch.pred_tokens.sum())
        refilled = [i for i, (_, s) in enumerate(completed) if s.refilled]
        if refilled:
            self.refill_steps += int(batch.pred_tokens[refilled].sum())
        return [s.tag for _, s in completed], batch

    def step(self):
        """``sync`` + ``parse_completed`` in one blocking call — the
        unpipelined drive (unit tests); the serve runtime interleaves a
        ``launch`` between the two to overlap host parsing with decode."""
        return self.parse_completed(self.sync())

    def account(self, stats) -> None:
        """Fold this run's decode-slot counters into ``SchedulerStats``."""
        stats.slot_steps_total += self.slot_steps_total
        stats.slot_steps_active += self.slot_steps_active
        stats.refill_steps_saved += self.refill_steps
        if self.paged:
            pool = self.kv_pool
            stats.kv_page_size = pool.page_size
            stats.pages_in_use = pool.pages_in_use
            stats.pages_peak = max(stats.pages_peak, pool.pages_peak)
            stats.kv_live_tokens = pool.live_tokens
            stats.kv_peak_tokens = max(stats.kv_peak_tokens,
                                       pool.tokens_peak)
        else:
            # dense KV is committed wholesale at prefill: every slot holds
            # max_len token positions for the whole run
            stats.kv_peak_tokens = max(
                stats.kv_peak_tokens, self.batch * self.state.max_len)


class ReasoningEstimator:
    def __init__(self, cfg: ModelConfig, params, *, cot: bool = True,
                 max_new_tokens: int = 12, batch_size: int = 256):
        self.cfg = cfg
        self.params = params
        self.cot = cot
        self.max_new_tokens = max_new_tokens
        self.batch_size = batch_size
        self.mesh = None            # set by shard(): serving over a mesh

    # ------------------------------------------------------------------
    def shard(self, mesh) -> "ReasoningEstimator":
        """Place the estimator on a ``DeviceMesh``: the params become
        DTensors per ``distributed.sharding.param_specs`` (FSDP on ``data``,
        TP axes on ``model`` where divisible), taken from the mesh's first
        rank, and every later call splits its batch's rows over ``data``
        per ``batch_specs``.  The sharded params also train as they are
        (``training.sft.train_sft``, ``training.grpo.GRPOTrainer``).  Every
        rank of the mesh must make the same calls.  Returns self."""
        self.params = shd.distribute_tree(
            mesh, self.params, shd.param_specs(mesh, self.params))
        self.mesh = mesh
        return self

    def local_rows(self, b: int) -> Optional[slice]:
        """The rows of a b-row batch this rank computes
        (``sampler.mesh_rows``): None unsharded, all of them where b does
        not divide over ``data`` or the backbone routes tokens over the
        batch (MoE)."""
        return sampler.mesh_rows(self.mesh, self.cfg, b)

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
        params = self.params
        chunks = []
        for i in range(0, len(arr), self.batch_size):
            pl = (None if prompt_lens is None
                  else np.asarray(prompt_lens)[i: i + self.batch_size])
            sub = arr[i: i + self.batch_size]
            rows = self.local_rows(len(sub))
            gen, dec = sampler.generate_async(
                params, self.cfg, sub, max_new_tokens=self.max_new_tokens,
                temperature=temperature, generator=rng, prompt_lens=pl,
                rows=rows)
            chunks.append(sampler.gather_rows(self.mesh, rows, len(sub), gen,
                                              dec))
        if self.mesh is not None and self.mesh.size() > 1:
            # ready at once on every rank: a rank's own event would let the
            # ranks' stream loops parse at different points
            return DecodeHandle(chunks)
        return DecodeHandle(chunks, event=_dispatched_event(
            sampler.params_device(params)))

    def open_slots(self, tokens, *, lengths=None, tags=None,
                   segment_len: int = 4, horizon: Optional[int] = None,
                   rng: Optional[torch.Generator] = None,
                   kv_pool=None, kv_kernel=None) -> SlotRun:
        """Open a continuous-batching decode state over one microbatch.

        The engine's segment-chunked refill path drives the returned
        ``SlotRun``: ``step`` decode segments, ``admit`` fresh prompts into
        drained slots between them.  ``tokens``/``lengths``/``tags`` are a
        scheduler ``Microbatch``'s fields; rows beyond the real tags are
        immediately-free slots.  Passing a ``kv_pool`` (``serving.kv_pool.
        KVPool``) switches the slot cache to the block-paged layout —
        ``horizon`` must then stay None (admission is page-gated).
        """
        if kv_pool is not None and horizon is not None:
            raise ValueError("horizon and kv_pool are mutually exclusive: "
                             "paged admission is gated on free pages")
        return SlotRun(self, tokens, lengths=lengths, tags=tags,
                       segment_len=segment_len, horizon=horizon, rng=rng,
                       kv_pool=kv_pool, kv_kernel=kv_kernel)

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
