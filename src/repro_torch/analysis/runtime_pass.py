"""Runtime pass: run the registered serve segments and record what they ask
of the device.

The counterpart of ``repro/analysis/jaxpr_pass.py``.  The AST rules see
what the *source* says; this pass sees what the *card* is asked to do.
Eager PyTorch has no jaxpr to walk, so each registered unit is run once,
and its window — the call a serve loop makes per segment — is recorded by a
``TorchDispatchMode`` that sees every aten op, flagging:

- **host reads of device values**: ``aten._local_scalar_dense`` (``.item()``,
  ``float()``, ``if t:``), ``is_nonzero``, ``nonzero``, ``masked_select``,
  ``unique*``, ``equal`` — each waits for the stream;
- **float64 / complex128 outputs**: a promotion that doubles the bytes and
  leaves the tensor cores;
- **device->host copies**: a copy whose destination is the CPU and whose
  source is not (the segment's one copy, ``sampler.to_host``, lies after
  the window).

On a CUDA device the window also runs under
``torch.cuda.set_sync_debug_mode("warn")``, and every synchronizing call is
recorded with the index of the dispatched op at which it came.  The sampler
makes every host->device copy of a segment before its first launch (a copy
from pageable memory waits for the stream, which is empty then), so a unit
may sync only before the window's first kernel launch, and exactly as often
as its registry entry states, with its reason.  Any other sync is a
finding.

Registry: ``register(name, syncs=, why=)(make)`` where
``make(setting) -> (setup, call)``: ``setup()`` builds the state outside
the window, ``call(state)`` is the window.  The default registry holds the
serve path's five segment kinds, the reference's six executables less the
Pallas twin (the port runs one paged kernel per device): ``dense_segment``
(``sampler.decode_segment``), ``dense_refill_segment`` (the same with
``refill=``), ``paged_segment``, ``paged_refill_segment`` and
``tier0_forward``.  They run on ``scope-tiny`` unless the caller passes a
config and params.  A unit that raises is itself a finding ("serve segment
failed to run"), as an executable that fails to trace is in the
reference.

On the CPU the plain kernel versions run in the window.  A CPU finding that
comes from a plain version alone (the card's run shows none) is listed in
its unit's ``plain_only`` with the reason, and reported as suppressed; an
entry that matches nothing is a finding, so the list cannot go stale.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.findings import Finding

RULE_ID = "runtime-forbidden-op"
SYNC_WARNING = "called a synchronizing CUDA operation"

_HOST_READS = frozenset({"aten::_local_scalar_dense", "aten::is_nonzero",
                         "aten::nonzero", "aten::nonzero_static",
                         "aten::masked_select", "aten::equal"})
_WIDE_DTYPES = (torch.float64, torch.complex128)
_COPIES = frozenset({"aten::_to_copy", "aten::copy_"})
# ops that enqueue no kernel: allocation, aliasing, lifting a host value
_NO_KERNEL = frozenset({"aten::empty", "aten::empty_strided",
                        "aten::empty_like", "aten::new_empty",
                        "aten::new_empty_strided", "aten::lift_fresh",
                        "aten::detach", "aten::alias", "aten::set_",
                        "aten::resize_"})


_LIFTS = frozenset({"aten::lift_fresh", "aten::lift_fresh_copy"})
_HERE = __file__


def _device_of(t) -> Optional[str]:
    return t.device.type if isinstance(t, torch.Tensor) else None


def _caller() -> str:
    """``file.py:line`` of the innermost frame outside torch and this
    module: the line of the program that asked for the op."""
    frame = sys._getframe(1)
    while frame is not None:
        name = frame.f_code.co_filename
        if name != _HERE and f"{os.sep}torch{os.sep}" not in name:
            return f"{os.path.basename(name)}:{frame.f_lineno}"
        frame = frame.f_back
    return "?"


def tensors(obj) -> list:
    """The tensors in ``obj``: nested dataclasses, dicts, lists, tuples."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in tensors(o)]
    return []


class Recorder(TorchDispatchMode):
    """Records one window's aten ops: host reads, wide outputs, copies to
    the CPU, host values lifted into tensors, the index of the first
    kernel launch, and (with CUDA's sync debug mode on) where each sync
    came.  ``caught`` is the list ``warnings.catch_warnings(record=True)``
    fills.

    The first launch is the first op that is not an upload, an allocation
    or a view and computes on the card; on the CPU, where host values and
    device values share a device, the first such op that reads one of the
    window's ``inputs`` (its params and state) or a view of one."""

    def __init__(self, caught: list, device_type: str, inputs=()):
        super().__init__()
        self.caught = caught
        self.device_type = device_type
        self._inputs = {id(t) for t in tensors(inputs)}
        self._seen = 0
        self.ops = 0
        self.first_launch: Optional[int] = None
        self.messages: List[str] = []
        self.syncs: List[Tuple[int, bool, str]] = []   # (op, during, where)
        self.lifts: List[Tuple[int, str]] = []          # (op, where)

    def _emit(self, msg: str) -> None:
        if msg not in self.messages:
            self.messages.append(msg)

    def _take_syncs(self, during: bool, name: str) -> None:
        new = self.caught[self._seen:]
        self._seen = len(self.caught)
        for w in new:
            if SYNC_WARNING in str(w.message):
                where = name if during else \
                    f"{os.path.basename(w.filename)}:{w.lineno}"
                self.syncs.append((self.ops, during, where))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.name().split(".")[0]
        self._take_syncs(False, name)           # between the ops
        out = func(*args, **kwargs)
        self._take_syncs(True, name)            # in this op
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        on_device = self.device_type == "cpu" or \
            any(t.device.type == "cuda" for t in ins)
        if on_device and (name in _HOST_READS or name.startswith(
                ("aten::unique", "aten::_unique"))):
            self._emit(f"host read of a device value: {name} at "
                       f"{_caller()}")
        for t in outs:
            if t.dtype in _WIDE_DTYPES:
                self._emit(f"{t.dtype} output of {name} at {_caller()}")
        upload = name in _LIFTS
        if upload:
            self.lifts.append((self.ops, _caller()))
        if name in _COPIES and ins:
            src = args[1] if name == "aten::copy_" else args[0]
            dst = args[0] if name == "aten::copy_" else (outs or [None])[0]
            s, d = _device_of(src), _device_of(dst)
            if d == "cpu" and s not in (None, "cpu"):
                self._emit(f"device->host copy ({name}) at {_caller()}")
            upload = s == "cpu" and d not in (None, "cpu")
        if func.is_view and any(id(t) in self._inputs for t in ins):
            self._inputs.update(id(t) for t in outs)   # views of inputs
        if self.first_launch is None and not upload and \
                name not in _NO_KERNEL and not func.is_view and (
                    any(id(t) in self._inputs for t in ins)
                    if self.device_type == "cpu" else
                    any(t.device.type == "cuda" for t in ins + outs)):
            self.first_launch = self.ops
        self.ops += 1
        return out

    def after_launch(self, events: list) -> list:
        """The ``events`` ((op, during, ...) or (op, ...)) at or after the
        window's first launch: a between-op event at the launch's own index
        came before it."""
        first = self.first_launch
        if first is None:
            return []
        return [e for e in events
                if e[0] > first or (e[0] == first and len(e) > 2 and e[1])]


@dataclasses.dataclass
class UnitReport:
    """One unit's window: what it dispatched and what it was flagged for."""
    name: str
    device: str
    ops: int = 0
    first_launch: Optional[int] = None
    syncs_before: int = 0
    syncs_after: int = 0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    findings: List[Finding] = dataclasses.field(default_factory=list)


def record(fn: Callable[[], Any], device: torch.device, inputs=()
           ) -> Tuple[Any, Recorder, float]:
    """Run ``fn`` in a recorded window: (its result, the recorder, wall
    seconds, the card synchronised after the window on CUDA).  ``inputs``
    holds the tensors the window is given (``Recorder``)."""
    cuda = device.type == "cuda"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rec = Recorder(caught, device.type, inputs)
        mode = torch.cuda.get_sync_debug_mode() if cuda else 0
        t0 = time.perf_counter()
        try:
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            with rec:
                out = fn()
            rec._take_syncs(False, "<end of window>")
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
        if cuda:
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    return out, rec, seconds


def check_window(name: str, fn: Callable[[], Any],
                 device: torch.device) -> List[Finding]:
    """Findings of one recorded call of ``fn`` (no registry: every sync
    counts)."""
    _, rec, _ = record(fn, device)
    msgs = list(rec.messages)
    msgs += [f"sync at {where} (op #{i})" for i, _, where in rec.syncs]
    return [Finding(RULE_ID, f"<runtime:{name}>", 0, m) for m in msgs]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Setting:
    """What a unit is made from: the model, its params, the device and
    the segment's shape."""
    cfg: Any
    params: Any
    device: torch.device
    rows: int = 4
    prompt_len: int = 8
    steps: int = 4
    page_size: int = 4


@dataclasses.dataclass(frozen=True)
class Unit:
    make: Callable[[Setting], Tuple[Callable[[], Any],
                                       Callable[[Any], Any]]]
    syncs: int              # host->device copies before the first launch
    why: str
    plain_only: Dict[str, str]      # CPU finding -> why only a plain version


_REGISTRY: Dict[str, Unit] = {}


def register(name: str, *, syncs: int = 0, why: str = "",
             plain_only: Optional[Dict[str, str]] = None):
    """Register a serve unit's factory for the runtime pass."""
    def deco(make):
        _REGISTRY[name] = Unit(make, syncs, why, dict(plain_only or {}))
        return make
    return deco


def registered() -> Dict[str, Unit]:
    _ensure_defaults()
    return dict(_REGISTRY)


def run_unit(name: str, unit: Unit, setting: Setting) -> UnitReport:
    """Build, run and judge one unit."""
    from repro_torch import kernels

    dev = setting.device
    rep = UnitReport(name, str(dev))
    path = f"<runtime:{name}>"
    try:
        setup, call = unit.make(setting)
        state = setup()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        kernels.reset_launch_counts()
        _, rec, rep.seconds = record(lambda: call(state), dev,
                                     (setting.params, state))
        rep.launches = {k: v for k, v in kernels.launch_counts().items()
                        if v}
    except Exception as exc:                # noqa: BLE001 - report, not die
        rep.findings.append(Finding(
            RULE_ID, path, 0, f"serve segment failed to run: {exc!r}"))
        return rep
    rep.ops, rep.first_launch = rec.ops, rec.first_launch
    after = rec.after_launch(rec.syncs)
    rep.syncs_after = len(after)
    rep.syncs_before = len(rec.syncs) - rep.syncs_after
    msgs = list(rec.messages)
    msgs += [f"sync after the window's first launch (op #{rec.first_launch})"
             f": at {where} (op #{i})" for i, _, where in after]
    if dev.type == "cuda" and rep.syncs_before != unit.syncs:
        msgs.append(f"{rep.syncs_before} syncs before the first launch; the "
                    f"registry states {unit.syncs} ({unit.why})")
    if dev.type == "cpu":
        # no sync shows on the CPU: a host value lifted into a tensor after
        # the first launch is the copy that would wait on the card
        msgs += [f"host value made a tensor after the window's first launch "
                 f"(op #{rec.first_launch}): at {where} (op #{i}) — on the "
                 "card a host->device copy that waits for the stream"
                 for i, where in rec.after_launch(rec.lifts)]
    for msg in msgs:
        reason = unit.plain_only.get(msg) if dev.type == "cpu" else None
        rep.findings.append(Finding(RULE_ID, path, 0, msg,
                                    suppressed=reason is not None,
                                    suppress_reason=reason or ""))
    if dev.type == "cpu":
        rep.findings += [
            Finding(RULE_ID, path, 0, f"plain_only entry {m!r} matched no "
                    "finding — remove it") for m in unit.plain_only
            if m not in msgs]
    return rep


def run_runtime_pass(cfg=None, params=None, device=None,
                     only: Optional[List[str]] = None,
                     **shape) -> List[UnitReport]:
    """Run every registered unit (or ``only`` those) and return their
    reports.  ``cfg`` / ``params`` default to ``scope-tiny`` with seeded
    weights; ``device`` to the card (``device="cpu"`` runs the plain
    versions); ``shape`` sets ``Setting``'s rows, prompt_len, steps and
    page_size."""
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_params

    if cfg is None:
        from repro_torch.configs.scope_estimator import TINY
        cfg = TINY
    dev = params["embed"].device if params is not None and device is None \
        else resolve_device(device)
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    setting = Setting(cfg, params, dev, **shape)
    return [run_unit(name, unit, setting)
            for name, unit in sorted(registered().items())
            if only is None or name in only]


# ---------------------------------------------------------------------------
# default registry: the serve path's segment kinds
# ---------------------------------------------------------------------------
_DEFAULTS_DONE = False


def _ensure_defaults() -> None:
    global _DEFAULTS_DONE
    if _DEFAULTS_DONE:
        return
    _DEFAULTS_DONE = True
    _register_defaults()


def _prompts(s: Setting, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(16, s.cfg.vocab_size, (s.rows, s.prompt_len),
                        dtype=np.int32)


def _refill(s: Setting):
    """(mask, prompts, lens): every other row refills, ragged lengths."""
    rng = np.random.default_rng(2)
    mask = np.arange(s.rows) % 2 == 0
    lens = rng.integers(max(1, s.prompt_len // 2), s.prompt_len + 1,
                        s.rows)
    return mask, _prompts(s, 1), lens


def _segment_unit(paged: bool, refill: bool):
    def build(s: Setting):
        from repro_torch.serving import sampler
        from repro_torch.serving.kv_pool import KVPool, _ceil_div

        def setup():
            pool = None
            if paged:
                width = _ceil_div(s.prompt_len + s.steps, s.page_size)
                pool = KVPool(s.rows * width, s.page_size)
            state = sampler.prefill_state(
                s.params, s.cfg, _prompts(s, 0),
                max_new_tokens=s.steps, kv_pool=pool)
            return state, (_refill(s) if refill else None)

        def call(args):
            state, fill = args
            return sampler.decode_segment(s.params, s.cfg, state, s.steps,
                                          refill=fill)
        return setup, call
    return build


def _tier0_unit(s: Setting):
    from repro_torch.models import tier0 as T0

    def setup():
        # drawn on the host from a seeded generator, then moved
        gen = torch.Generator().manual_seed(0)
        params = T0.init_tier0(gen, device="cpu")
        n, K = T0.PAIR_BUCKETS[0], 5
        feats = (torch.randn(n, T0.QUERY_FEATS, generator=gen),
                 torch.randn(n, K, T0.ANCHOR_FEATS, generator=gen),
                 torch.randn(n, T0.MODEL_FEATS, generator=gen),
                 torch.randint(0, T0.N_MODEL_SLOTS, (n,), generator=gen))
        return ({k: v.to(s.device) for k, v in params.items()},
                [t.to(s.device) for t in feats])

    def call(args):
        params, feats = args
        with torch.no_grad():
            return T0.tier0_forward(params, *feats)
    return setup, call


_REFILL_UPLOADS = ("a refill's prompts, mask, true lengths and cache-row "
                   "destinations")


def _register_defaults() -> None:
    register("dense_segment", syncs=1,
             why="DECISION_TOKENS")(_segment_unit(False, False))
    register("dense_refill_segment", syncs=5,
             why=f"DECISION_TOKENS and {_REFILL_UPLOADS}")(
        _segment_unit(False, True))
    register("paged_segment", syncs=2,
             why="the page table and DECISION_TOKENS")(
        _segment_unit(True, False))
    register("paged_refill_segment", syncs=6,
             why=f"the page table, DECISION_TOKENS and {_REFILL_UPLOADS}")(
        _segment_unit(True, True))
    register("tier0_forward", syncs=0,
             why="its inputs arrive on the card")(_tier0_unit)
