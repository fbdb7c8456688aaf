"""Streaming microbatch scheduler: ragged traffic -> fixed-shape batches.

The port of ``repro/serving/scheduler.py``, host-side numpy, unchanged but
for one omission: the JAX package's ``decode_compile_counts`` (and the
``compile_counts`` block of ``SchedulerStats.as_dict``) counts XLA
executable builds, which have no counterpart in eager PyTorch.

Live traffic is ragged — per tick the number of (query, model) prompts
varies.  ``MicrobatchScheduler`` quantizes it onto a small fixed grid of
(batch, prompt-len) shapes:

  * the **batch axis** is padded up to a configured set of bucket sizes
    with all-PAD rows.  Prefill and decode are row-independent, so under
    greedy decoding the real rows match an unpadded run — pad rows are
    dropped on the way out;
  * the **prompt-len axis** is exact-fit by default (SCOPE's structured
    serialization produces constant-length prompts per pool).  A fixed
    ``prompt_lens`` grid right-pads prompts up to the bucket boundary and
    each ``Microbatch`` carries the true per-row ``lengths``, which the
    sampler threads through decode as per-row positions and valid-length
    masks.

**Continuous flushing.**  ``ready()`` pops full microbatches eagerly at the
largest batch bucket; ``tick()`` additionally applies the latency knobs —
``max_queue_age`` (emit a partial bucket rather than hold a request past its
deadline; checked against an injectable monotonic ``clock``) and
``min_fill`` (emit once a queue covers that fraction of the largest
bucket); ``flush()`` drains everything left into a greedy largest-fit
bucket decomposition at stream end.  ``SchedulerStats`` tracks bucket
occupancy, pad waste, queue-age percentiles, decode-slot occupancy, paged
KV and the fault ledger.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import (
    Any, Callable, Deque, Dict, Iterator, List, Optional, Sequence, Tuple)

import numpy as np

from repro_torch.data.tokenizer import PAD

# bounded reservoir of per-prompt queue ages (seconds) for the percentiles
MAX_QUEUE_AGE_SAMPLES = 65536


@dataclasses.dataclass(frozen=True)
class BucketConfig:
    """The fixed (batch, prompt-len) shape grid.

    ``batch_sizes`` must be sorted ascending; traffic is assembled into the
    largest size and flushed into a greedy largest-fit decomposition.
    ``prompt_lens`` empty means exact-fit: every distinct arriving length is
    its own bucket (no length padding, bit-identical results).
    """
    batch_sizes: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    prompt_lens: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.batch_sizes:
            raise ValueError("batch_sizes must be non-empty")
        bs = tuple(sorted({int(b) for b in self.batch_sizes}))
        if bs[0] <= 0:
            raise ValueError(f"batch sizes must be positive, got {bs}")
        object.__setattr__(self, "batch_sizes", bs)
        object.__setattr__(self, "prompt_lens",
                           tuple(sorted({int(x) for x in self.prompt_lens})))

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    def batch_bucket(self, n: int) -> int:
        """Smallest configured batch size >= n (n must fit the grid)."""
        for b in self.batch_sizes:
            if b >= n:
                return b
        raise ValueError(f"batch {n} exceeds the largest bucket "
                         f"{self.max_batch}")

    def len_bucket(self, length: int) -> int:
        """Smallest configured prompt-len >= length; exact-fit otherwise."""
        for ell in self.prompt_lens:
            if ell >= length:
                return ell
        return int(length)          # exact-fit (incl. overflow of the grid)


@dataclasses.dataclass
class SchedulerStats:
    submitted: int = 0              # real prompts accepted
    emitted: int = 0                # real prompts shipped in microbatches
    microbatches: int = 0
    partial_microbatches: int = 0   # emitted below the full bucket batch
    flushes: int = 0                # flush() calls that emitted something
    deadline_flushes: int = 0       # queue drains forced by max_queue_age
    fill_flushes: int = 0           # emissions triggered by min_fill
    pad_rows: int = 0               # all-PAD filler rows
    pad_tokens: int = 0             # PAD tokens added (rows + length padding)
    real_tokens: int = 0
    # decode-slot accounting (continuous batching): how many slot-steps the
    # decode segments ran, how many of them decoded a live request's
    # tokens, and how much of that came from mid-batch refills.  The engine
    # folds these in at parse/retire time for both the whole-retire and the
    # segment-chunked refill paths, so the bench occupancy comparison reads
    # one counter pair instead of recomputing.
    slots_refilled: int = 0         # requests popped into an open slot
    refill_steps_saved: int = 0     # active decode steps served by refilled
    #                                 rows — whole-retire would have idled
    #                                 those slot-steps at PAD
    slot_steps_total: int = 0       # batch x decode-steps actually run
    slot_steps_active: int = 0      # of those, steps holding a live request
    # paged-KV accounting (segment granularity, folded in by
    # SlotRun.account / SlotRuntime._admit).  pages_in_use / kv_live_tokens
    # are gauges (last retire's snapshot); the peaks are monotonic maxima.
    # kv_peak_tokens is also set on the dense path (batch x max_len per
    # run), so paged-vs-dense KV footprints compare through one counter.
    kv_page_size: int = 0
    pages_in_use: int = 0
    pages_peak: int = 0
    kv_live_tokens: int = 0
    kv_peak_tokens: int = 0
    admissions_deferred_on_pages: int = 0    # boundaries that idled a free
    #                                          slot waiting for pool pages
    admissions_deferred_on_horizon: int = 0  # dense counterpart (remaining
    #                                          horizon below one budget)
    # fault tolerance (bounded retry / quarantine / SLO deadlines /
    # degraded answers).  ``submitted`` counts each prompt once, so
    # exactly-once accounting reads: every submitted prompt ends either
    # parsed (OK) or degraded/failed — ``requeued`` re-emissions never
    # re-submit.  ``degraded``/``failed_pairs`` count *prompts* (in-flight
    # dedup keys), not the waiter fan-out behind them.
    retries: int = 0                # failure events routed into retry
    requeued: int = 0               # rows put back in the queue
    quarantined: int = 0            # prompts that exhausted max_retries
    deadline_expired: int = 0       # prompts answered past their deadline
    degraded: int = 0               # prompts answered from retrieval priors
    failed_pairs: int = 0           # prompts answered FAILED (no fallback)
    injected_faults: int = 0        # FaultInjector events that fired
    kv_exhausted_rows: int = 0      # rows failed by KV pool exhaustion
    # two-tier routing ledger (folded in by the engine per request, before
    # submission): ``tier0_answered`` pairs were served by the pre-router
    # head and never entered this scheduler; ``escalated`` pairs continued
    # into the decode path (and are the only ones counted in
    # ``submitted``).  ``tier0_fallbacks`` counts quarantined/expired
    # escalations answered from their stashed tier-0 row instead of the
    # retrieval prior; ``tier0_decode_tokens_saved`` is the decode budget
    # the answered pairs never spent.
    tier0_answered: int = 0
    escalated: int = 0
    tier0_fallbacks: int = 0
    tier0_decode_tokens_saved: int = 0
    # drift ledger (folded in by the engine from its FeedbackMonitor when
    # EngineConfig.drift_detect is on): snapshots, not increments —
    # ``drift_alarms`` is the monitor's monotonic alarm count,
    # ``models_quarantined`` the currently-drifted model count,
    # ``hot_swaps`` the engine's lifetime estimator swaps,
    # ``replay_buffer_len`` the outcome ledger's current size, and the
    # residual percentiles summarize |predicted_p - observed_y| over the
    # buffer.  All stay zero with the detector off, so detector-on and
    # detector-off stats differ only inside the ``drift`` block.
    drift_alarms: int = 0
    models_quarantined: int = 0
    hot_swaps: int = 0
    replay_buffer_len: int = 0
    drift_residual_p50: float = 0.0
    drift_residual_p95: float = 0.0
    occupancy: Dict[Tuple[int, int], int] = dataclasses.field(
        default_factory=dict)       # (batch, len) bucket -> microbatch count
    queue_ages: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=MAX_QUEUE_AGE_SAMPLES))

    @property
    def pad_fraction(self) -> float:
        total = self.real_tokens + self.pad_tokens
        return self.pad_tokens / total if total else 0.0

    @property
    def slot_occupancy(self) -> float:
        """Fraction of decode slot-steps that served a live request."""
        return (self.slot_steps_active / self.slot_steps_total
                if self.slot_steps_total else 0.0)

    @property
    def page_fragmentation(self) -> float:
        """Fraction of peak-allocated page capacity that never held a live
        token — intra-page waste from partial last pages plus reserved-but-
        unwritten budget headroom.  0.0 when no paged run has retired."""
        cap = self.pages_peak * self.kv_page_size
        return 1.0 - self.kv_peak_tokens / cap if cap else 0.0

    @property
    def degraded_fraction(self) -> float:
        """Fraction of submitted prompts answered without a full estimator
        decode (degraded from retrieval priors or failed outright)."""
        if not self.submitted:
            return 0.0
        return (self.degraded + self.failed_pairs) / self.submitted

    @property
    def escalation_rate(self) -> float:
        """Fraction of tier-0-gated pairs that escalated to the reasoning
        decode.  1.0 when no tier-0 head gated anything (every pair paid
        the decode)."""
        gated = self.tier0_answered + self.escalated
        return self.escalated / gated if gated else 1.0

    def queue_age_percentiles(self) -> Dict[str, float]:
        """Seconds spent queued, per emitted prompt (p50/p95/max)."""
        if not self.queue_ages:
            return {"p50": 0.0, "p95": 0.0, "max": 0.0}
        a = np.asarray(self.queue_ages, np.float64)
        return {"p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)),
                "max": float(a.max())}

    def as_dict(self) -> Dict[str, Any]:
        ages = self.queue_age_percentiles()
        return {"submitted": self.submitted, "emitted": self.emitted,
                "microbatches": self.microbatches,
                "partial_microbatches": self.partial_microbatches,
                "flushes": self.flushes,
                "deadline_flushes": self.deadline_flushes,
                "fill_flushes": self.fill_flushes,
                "pad_rows": self.pad_rows,
                "pad_fraction": round(self.pad_fraction, 4),
                "slots_refilled": self.slots_refilled,
                "refill_steps_saved": self.refill_steps_saved,
                "slot_steps": {"total": self.slot_steps_total,
                               "active": self.slot_steps_active},
                "slot_occupancy": round(self.slot_occupancy, 4),
                "kv_pages": {"page_size": self.kv_page_size,
                             "in_use": self.pages_in_use,
                             "peak": self.pages_peak,
                             "live_tokens": self.kv_live_tokens,
                             "peak_tokens": self.kv_peak_tokens,
                             "fragmentation":
                                 round(self.page_fragmentation, 4),
                             "deferred_on_pages":
                                 self.admissions_deferred_on_pages,
                             "deferred_on_horizon":
                                 self.admissions_deferred_on_horizon},
                "faults": {"retries": self.retries,
                           "requeued": self.requeued,
                           "quarantined": self.quarantined,
                           "deadline_expired": self.deadline_expired,
                           "degraded": self.degraded,
                           "failed": self.failed_pairs,
                           "injected": self.injected_faults,
                           "kv_exhausted_rows": self.kv_exhausted_rows,
                           "degraded_fraction":
                               round(self.degraded_fraction, 4)},
                "tiers": {"tier0_answered": self.tier0_answered,
                          "escalated": self.escalated,
                          "escalation_rate": round(self.escalation_rate, 4),
                          "tier0_fallbacks": self.tier0_fallbacks,
                          "decode_tokens_saved":
                              self.tier0_decode_tokens_saved},
                "drift": {"alarms": self.drift_alarms,
                          "models_quarantined": self.models_quarantined,
                          "hot_swaps": self.hot_swaps,
                          "replay_buffer_len": self.replay_buffer_len,
                          "residual_p50":
                              round(self.drift_residual_p50, 4),
                          "residual_p95":
                              round(self.drift_residual_p95, 4)},
                "queue_age_ms": {k: round(v * 1e3, 3)
                                 for k, v in ages.items()},
                "buckets": {f"{b}x{l}": c
                            for (b, l), c in sorted(self.occupancy.items())}}


@dataclasses.dataclass
class Microbatch:
    """One fixed-shape unit of work: (bucket_batch, bucket_len) tokens.

    Rows [0, n_real) carry real prompts (right-padded to ``bucket[1]`` when
    a length grid is configured); rows [n_real, bucket[0]) are all-PAD
    filler.  ``tags`` parallels the real rows; ``lengths`` gives every
    row's true prompt length (pad rows report the full bucket length), for
    the sampler's per-row positions / valid-length masks.
    """
    tokens: np.ndarray              # (bucket_batch, bucket_len) int32
    tags: List[Any]
    lengths: np.ndarray             # (bucket_batch,) int32 true lengths
    bucket: Tuple[int, int]

    @property
    def n_real(self) -> int:
        return len(self.tags)


@dataclasses.dataclass
class _Pending:
    tag: Any
    prompt: List[int]
    t_submit: float


class MicrobatchScheduler:
    """Request queue + microbatch assembler over a ``BucketConfig`` grid.

    ``submit`` enqueues one prompt under an opaque tag; ``ready`` pops
    full largest-bucket microbatches; ``tick`` adds deadline/occupancy
    flushing (``max_queue_age`` seconds / ``min_fill`` fraction of the
    largest bucket, on the injectable monotonic ``clock``); ``flush``
    drains everything left.  The scheduler is shape bookkeeping only —
    executing a ``Microbatch`` (and discarding its pad rows) is the
    caller's job.
    """

    def __init__(self, config: Optional[BucketConfig] = None, *,
                 max_queue_age: Optional[float] = None,
                 min_fill: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        if max_queue_age is not None and max_queue_age < 0:
            raise ValueError(f"max_queue_age must be >= 0, "
                             f"got {max_queue_age}")
        if not 0.0 <= min_fill <= 1.0:
            raise ValueError(f"min_fill must be in [0, 1], got {min_fill}")
        self.config = config or BucketConfig()
        self.max_queue_age = max_queue_age
        self.min_fill = float(min_fill)
        self.stats = SchedulerStats()
        self._clock = clock
        # per len-bucket FIFO; OrderedDict keeps drain order deterministic
        self._queues: "OrderedDict[int, List[_Pending]]" = OrderedDict()

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def oldest_age(self) -> float:
        """Age (s) of the oldest queued prompt; 0.0 when empty."""
        oldest = min((q[0].t_submit for q in self._queues.values() if q),
                     default=None)
        return 0.0 if oldest is None else self._clock() - oldest

    def now(self) -> float:
        """The scheduler's monotonic clock — the time base for queue ages
        and (in the engine) SLO deadlines, so tests inject one clock."""
        return self._clock()

    def submit(self, tag: Any, prompt: Sequence[int]) -> None:
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        ell = self.config.len_bucket(len(prompt))
        self._queues.setdefault(ell, []).append(
            _Pending(tag, prompt, self._clock()))
        self.stats.submitted += 1

    def requeue(self, tag: Any, prompt: Sequence[int]) -> None:
        """Re-enqueue a failed row at the back of its length class.

        Accounted under ``requeued``, never ``submitted`` — the prompt was
        already counted once at ``submit``, so exactly-once accounting
        (every submitted prompt is answered exactly once) survives any
        number of retries.  Re-enqueueing at the back keeps per-class FIFO
        exact for rows that never fail; a retried row re-enters behind
        the prompts that arrived while it was in flight.
        """
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        ell = self.config.len_bucket(len(prompt))
        self._queues.setdefault(ell, []).append(
            _Pending(tag, prompt, self._clock()))
        self.stats.requeued += 1

    def cancel(self, tag: Any) -> Optional[List[int]]:
        """Remove one queued prompt by tag (SLO expiry of a row that never
        reached the device); returns its prompt, or ``None`` if the tag is
        not queued (already emitted, or unknown)."""
        for q in self._queues.values():
            for i, it in enumerate(q):
                if it.tag == tag:
                    del q[i]
                    return it.prompt
        return None

    # -- assembly ------------------------------------------------------
    def _emit(self, ell: int, items: List[_Pending]) -> Microbatch:
        bb = self.config.batch_bucket(len(items))
        tokens = np.full((bb, ell), PAD, np.int32)
        lengths = np.full((bb,), ell, np.int32)
        for i, it in enumerate(items):
            tokens[i, : len(it.prompt)] = it.prompt
            lengths[i] = len(it.prompt)
        now = self._clock()
        st = self.stats
        st.emitted += len(items)
        st.microbatches += 1
        st.partial_microbatches += int(len(items) < bb)
        st.pad_rows += bb - len(items)
        real = sum(len(it.prompt) for it in items)
        st.real_tokens += real
        st.pad_tokens += bb * ell - real
        st.queue_ages.extend(now - it.t_submit for it in items)
        key = (bb, ell)
        st.occupancy[key] = st.occupancy.get(key, 0) + 1
        return Microbatch(tokens, [it.tag for it in items], lengths, key)

    def _largest_fit(self, n: int) -> int:
        """Largest configured batch size <= n, else n (padded up on emit)."""
        for b in reversed(self.config.batch_sizes):
            if b <= n:
                return b
        return n

    def pop_one(self, width: Optional[int] = None
                ) -> Optional[Tuple[Any, List[int], int]]:
        """Pop the single oldest queued prompt that fits an open decode
        slot of ``width`` tokens; ``None`` when nothing fits.

        This is the scheduler's unit of **mid-batch refill**: between
        decode segments the engine pulls one request per drained slot
        instead of waiting for a whole bucket.  Only queue fronts are
        taken, so per-length-class FIFO order is preserved, and the
        globally oldest fitting prompt wins across classes.  Returns
        ``(tag, prompt, length)``; emission stats (queue age, real/pad
        tokens, ``slots_refilled``) are accounted as a one-row emission.
        """
        best_ell = None
        for ell, q in self._queues.items():
            if not q or (width is not None and len(q[0].prompt) > width):
                continue
            if (best_ell is None
                    or q[0].t_submit < self._queues[best_ell][0].t_submit):
                best_ell = ell
        if best_ell is None:
            return None
        it = self._queues[best_ell].pop(0)
        st = self.stats
        st.emitted += 1
        st.slots_refilled += 1
        st.real_tokens += len(it.prompt)
        if width is not None:
            st.pad_tokens += width - len(it.prompt)
        st.queue_ages.append(self._clock() - it.t_submit)
        return it.tag, it.prompt, len(it.prompt)

    def peek_one(self, width: Optional[int] = None) -> bool:
        """Whether ``pop_one(width)`` would return a prompt — a
        non-destructive probe so the serve runtime can tell an idle queue
        apart from an admission deferred on capacity (and count only the
        latter)."""
        return any(q and (width is None or len(q[0].prompt) <= width)
                   for q in self._queues.values())

    def ready(self) -> List[Microbatch]:
        """Pop every full largest-bucket microbatch currently assembled."""
        out = []
        full = self.config.max_batch
        for ell, q in self._queues.items():
            while len(q) >= full:
                out.append(self._emit(ell, q[:full]))
                del q[:full]
        return out

    def tick(self) -> List[Microbatch]:
        """``ready()`` plus deadline/occupancy flushing.

        A queue whose **oldest** prompt has waited ``max_queue_age`` is
        drained front-first until the remainder is younger than the
        deadline (partially-filled buckets allowed); a queue holding at
        least ``min_fill * max_batch`` prompts emits largest-fit
        microbatches down to that threshold.  With both knobs unset this
        is exactly ``ready()``.

        The deadline is **tick-granular**: it is only checked when
        ``tick()`` runs (the engine calls it per request arrival), so the
        realized age bound is ``max_queue_age`` plus the caller's
        inter-tick time — including any microbatch execution its drain
        loop blocks on.
        """
        out = self.ready()
        if self.max_queue_age is None and self.min_fill <= 0.0:
            return out
        now = self._clock()
        fill_n = self.min_fill * self.config.max_batch
        for ell, q in self._queues.items():
            while q:
                expired = (self.max_queue_age is not None
                           and now - q[0].t_submit >= self.max_queue_age)
                filled = self.min_fill > 0.0 and len(q) >= fill_n
                if not (expired or filled):
                    break
                take = self._largest_fit(len(q))
                out.append(self._emit(ell, q[:take]))
                del q[:take]
                st = self.stats
                st.deadline_flushes += int(expired)
                st.fill_flushes += int(filled and not expired)
        return out

    def flush(self) -> List[Microbatch]:
        """Drain the remainder: greedy largest-fit bucket decomposition."""
        out = self.ready()
        for ell, q in self._queues.items():
            while q:
                take = self._largest_fit(len(q))
                out.append(self._emit(ell, q[:take]))
                del q[:take]
        self._queues.clear()
        if out:
            self.stats.flushes += 1
        return out

    def drain(self) -> Iterator[Microbatch]:
        """ready() + flush() as one iterator (single-shot workloads)."""
        yield from self.flush()
