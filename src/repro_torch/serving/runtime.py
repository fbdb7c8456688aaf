"""Microbatch execution runtimes for the streaming serve path.

The port of ``repro/serving/runtime.py``, unchanged but for its imports.

``ServeRuntime`` separates *dispatch* (launch a microbatch's device work)
from *parse* (block on the results and hand them to the consumer), so host
assembly of microbatch N+1 — cache probes, prompt serialization, scheduler
packing — runs while N's prefill + decode is still in flight on the
device.  CUDA launches are asynchronous; the only forced host sync is the
device-to-host copy at parse time, which the runtime defers until either

  * capacity: ``max_pending`` batches are already in flight (the oldest is
    parsed to make room — ``max_pending=1`` is classic double buffering,
    ``max_pending=0`` is the synchronous pre-runtime behavior, and depths
    > 1 interleave batch N+1's prefill with batch N's decode, which pays
    on devices where the two phases occupy different units), or
  * opportunity: ``poll()`` parses any batch whose device buffers report
    ready (a CUDA event recorded after dispatch), keeping time-to-first-decision low, or
  * shutdown: ``finish()`` drains everything.

Parses always happen in dispatch (FIFO) order, so consumers observe the
exact event order of the synchronous loop — overlap changes *when* the
host blocks, never *what* it sees.

The runtime is estimator-agnostic: a dispatch function returning an object
with ``is_ready()``/``parse()`` (e.g. ``ReasoningEstimator.dispatch_batch``
handles) runs overlapped; one returning a finished ``ParsedBatch`` directly
(duck-typed test estimators) degrades to the synchronous path.

``SlotRuntime`` is the segment-chunked counterpart: instead of retiring
microbatches whole, it drives a live decode-slot state
(``ReasoningEstimator.open_slots`` -> ``SlotRun``) in fixed decode segments
and refills drained-at-EOS slots mid-batch from the scheduler queue.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Deque, Iterable, Optional, Tuple

from repro_torch.serving.scheduler import Microbatch


def _is_ready(handle: Any) -> bool:
    probe = getattr(handle, "is_ready", None)
    return True if probe is None else bool(probe())


def _parse(handle: Any) -> Any:
    parse = getattr(handle, "parse", None)
    return handle if parse is None else parse()


@dataclasses.dataclass
class RuntimeStats:
    dispatched: int = 0
    parsed: int = 0
    overlapped: int = 0      # parses that found the device already done
    max_in_flight: int = 0
    failed: int = 0          # microbatches routed to on_failed

    def as_dict(self):
        return dataclasses.asdict(self)


class ServeRuntime:
    """FIFO dispatch/parse pipeline over microbatches.

    ``dispatch_fn(mb)`` launches one microbatch and returns a handle (or a
    finished result); ``on_parsed(mb, result)`` consumes each parsed batch
    in dispatch order.

    ``on_failed(mb, exc)``, when given, receives any microbatch whose
    dispatch or parse raised instead of the exception propagating — the
    engine's retry path requeues the batch's rows.  Without it every
    exception stays loud (the pre-fault-tolerance behavior).  The runtime
    is also a context manager: on clean exit it drains (``finish``), on
    error it ``abort``s, so an exception mid-stream can never leak an
    in-flight launch into the next stream.
    """

    def __init__(self, dispatch_fn: Callable[[Microbatch], Any], *,
                 on_parsed: Callable[[Microbatch, Any], None],
                 max_pending: int = 1,
                 on_failed: Optional[Callable[[Microbatch, Exception],
                                              None]] = None):
        if max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        self._dispatch_fn = dispatch_fn
        self._on_parsed = on_parsed
        self._on_failed = on_failed
        self.max_pending = max_pending
        self._inflight: Deque[Tuple[Microbatch, Any]] = deque()
        self.stats = RuntimeStats()

    def __len__(self) -> int:
        return len(self._inflight)

    def _parse_oldest(self) -> None:
        mb, handle = self._inflight.popleft()
        ready = _is_ready(handle)
        try:
            result = _parse(handle)
        except Exception as exc:
            if self._on_failed is None:
                raise
            self.stats.failed += 1
            self._on_failed(mb, exc)
            return
        self.stats.overlapped += int(ready)
        self.stats.parsed += 1
        self._on_parsed(mb, result)

    def dispatch(self, batches: Iterable[Microbatch]) -> None:
        """Launch each microbatch, blocking only when over capacity.

        Capacity is enforced **before** the new launch: with
        ``max_pending=1`` the oldest batch is parsed (blocking until its
        device work retires) and only then is the next one dispatched, so
        at most one microbatch runs at a time — the overlap is host
        assembly vs device decode, never two microbatches contending for
        the same compute.  ``max_pending=0`` parses immediately after
        dispatch (fully synchronous).
        """
        for mb in batches:
            while self._inflight and len(self._inflight) >= self.max_pending:
                self._parse_oldest()
            try:
                handle = self._dispatch_fn(mb)
            except Exception as exc:
                if self._on_failed is None:
                    raise
                self.stats.failed += 1
                self._on_failed(mb, exc)
                continue
            self._inflight.append((mb, handle))
            self.stats.dispatched += 1
            self.stats.max_in_flight = max(self.stats.max_in_flight,
                                           len(self._inflight))
            while len(self._inflight) > self.max_pending:
                self._parse_oldest()

    def poll(self) -> int:
        """Parse every leading in-flight batch whose device work is done
        (non-blocking); returns the number parsed."""
        n = 0
        while self._inflight and _is_ready(self._inflight[0][1]):
            self._parse_oldest()
            n += 1
        return n

    def finish(self) -> None:
        """Block-parse everything still in flight (stream shutdown)."""
        while self._inflight:
            self._parse_oldest()

    def abort(self) -> int:
        """Drop every in-flight handle without parsing (error shutdown);
        returns how many were dropped.  The device work completes on its
        own and its buffers are released — nothing double-buffered
        survives into the caller's next stream."""
        n = len(self._inflight)
        self._inflight.clear()
        return n

    def close(self, *, drain: bool = True) -> None:
        """Shut the pipeline down: drain (parse) what is in flight, or
        abort it.  If draining itself raises, the remainder is aborted
        before the exception propagates, so close() never leaks handles."""
        if not drain:
            self.abort()
            return
        try:
            self.finish()
        except Exception:
            self.abort()
            raise

    def __enter__(self) -> "ServeRuntime":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close(drain=exc_type is None)
        return False


class SlotRuntime:
    """Segment-chunked continuous batching over decode slots.

    The refill counterpart of ``ServeRuntime``: one live slot state at a
    time (device work is serialized on one stream anyway).  Whole
    scheduler microbatches *open* a state via ``open_slots``; between decode
    segments, rows that drained at EOS (or exhausted their budget) hand
    their parse group to ``on_parsed`` and their slot admits the oldest
    queued prompt (``scheduler.pop_one``) — a row that finishes early
    serves the next request instead of idling until the batch retires.

    ``pump(final=False)`` advances **at most one segment** — the engine
    calls it per request arrival, so admission interleaves with traffic;
    ``pump(final=True)`` flushes the scheduler and drains until every slot
    retires.  A queued prompt wider than the live state's slots is never
    force-fit: it waits for that state to retire and then opens (or joins)
    its own microbatch.  Retired runs fold their decode-slot occupancy
    counters into ``scheduler.stats``.
    """

    def __init__(self, open_slots: Callable[..., Any], scheduler, *,
                 segment_len: int, on_parsed: Callable[[list, Any], None],
                 horizon: Optional[int] = None, rng: Any = None,
                 kv_pool: Any = None, kv_kernel: Any = None,
                 injector: Any = None,
                 on_failed: Optional[Callable[[list, Optional[Exception]],
                                              None]] = None):
        self._open_slots = open_slots
        self._sched = scheduler
        self._segment_len = int(segment_len)
        self._on_parsed = on_parsed
        self._horizon = horizon
        self._rng = rng
        self._kv_pool = kv_pool
        self._kv_kernel = kv_kernel
        self._injector = injector
        self._on_failed = on_failed
        self._open_queue: Deque[Microbatch] = deque()
        self._run: Any = None

    def __len__(self) -> int:
        """Requests currently occupying slots or awaiting a free state."""
        live = self._run.n_live if self._run is not None else 0
        return live + sum(mb.n_real for mb in self._open_queue)

    def _admit(self, run) -> None:
        """Pop queued prompts into the run's free slots (as many as fit).

        ``can_admit`` is re-checked per item — each paged admission draws
        down the pool, so the first one can succeed and the next defer.  A
        boundary that leaves a free slot idle while the queue holds work is
        *counted*, not silently swallowed: the deferral shows up in
        ``SchedulerStats`` under the resource it waited on (pool pages in
        paged mode, the slot horizon in dense mode).
        """
        items = []
        for _ in run.free_rows():
            if not run.can_admit():
                if self._sched.peek_one(run.width):
                    stats = self._sched.stats
                    if run.deferral_reason == "pages":
                        stats.admissions_deferred_on_pages += 1
                    else:
                        stats.admissions_deferred_on_horizon += 1
                break
            item = self._sched.pop_one(run.width)
            if item is None:
                break
            items.append(item)
        run.admit(items)

    def _fail_row(self, run, row: Optional[int]) -> None:
        """Row-level failure (KV pool exhaustion, real or injected): fail
        the row out of the state and route it to the retry path.  Without
        an ``on_failed`` route the loud pre-fault behavior is preserved —
        the stream still dies rather than silently dropping a request."""
        if row is None:
            return
        if self._on_failed is None:
            raise RuntimeError(
                f"kv pool exhausted for slot row {row} and no failure "
                "route is configured")
        failed = run.fail_row(row)
        if failed is not None:
            self._sched.stats.kv_exhausted_rows += 1
            self._on_failed([failed], None)

    def _launch(self, run) -> None:
        """Launch the next segment, first applying the boundary's fault
        checks: injected pool/segment faults and real page starvation
        (rows decoding past their reserved budget under a drained pool)
        fail at row or state granularity instead of inside the sampler."""
        inj = self._injector
        if inj is not None:
            inj.tick("stall")
            spec = inj.tick("pool")
            if spec is not None and run.paged:
                self._fail_row(run, run.pick_live_row(int(spec.arg)))
            spec = inj.tick("segment")
            if spec is not None:
                from repro_torch.serving.faults import InjectedFault
                raise InjectedFault(
                    f"injected segment fault (event {spec.index})")
        for row in run.starved_rows():
            self._fail_row(run, row)
        if not run.finished:
            run.launch()

    def _recover(self, run, completed, exc: Exception) -> None:
        """Segment failure: deliver what completed before the fault, tear
        the state down, and hand the live rows to the retry path."""
        if self._on_failed is None:
            raise exc
        if completed:
            # rows sync() freed before the fault decoded fully — they
            # parse and deliver normally (exactly-once: they are not in
            # the abort set)
            self._on_parsed(*run.parse_completed(completed))
        failed = run.abort()
        run.account(self._sched.stats)
        self._run = None
        self._on_failed(failed, exc)

    def pump(self, final: bool = False) -> None:
        while True:
            if self._run is None:
                self._open_queue.extend(
                    self._sched.flush() if final else self._sched.tick())
                if not self._open_queue:
                    return
                mb = self._open_queue.popleft()
                kw = {}
                if self._kv_pool is not None:
                    kw = {"kv_pool": self._kv_pool,
                          "kv_kernel": self._kv_kernel}
                self._run = self._open_slots(
                    mb.tokens, lengths=mb.lengths, tags=mb.tags,
                    segment_len=self._segment_len, horizon=self._horizon,
                    rng=self._rng, **kw)
                # a partially-filled opening bucket's pad rows are free
                # slots: refill them before the first segment launches
                self._admit(self._run)
            run = self._run
            # launch the first segment of a fresh state, sync the
            # in-flight one, refill the slots it drained, and launch the
            # next segment BEFORE parsing — the host assembles results
            # (window parse, cache writes, request completion) while the
            # device decodes ahead
            completed = []
            try:
                if not run.in_flight:
                    self._launch(run)
                if run.in_flight:
                    completed = run.sync()
            except Exception as exc:
                self._recover(run, completed, exc)
                continue
            self._admit(run)
            try:
                if not run.finished:
                    self._launch(run)
            except Exception as exc:
                self._recover(run, completed, exc)
                continue
            if completed:
                self._on_parsed(*run.parse_completed(completed))
            if run.finished:
                run.account(self._sched.stats)
                self._run = None
                continue                # maybe open the next state
            if not final:
                return                  # one segment per arrival
