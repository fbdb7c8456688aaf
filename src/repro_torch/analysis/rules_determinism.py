"""Rule: serve-time-nondeterminism.

The port of ``repro/analysis/rules_determinism.py``.  Replayability is the
fault-tolerance contract: a serve stream re-run with the same FaultPlan must
be bit-identical, which is only true if serving code never reads a wall
clock or draws fresh entropy.  Clocks are *injected*
(``MicrobatchScheduler(clock=...)``), the sampling generator is *carried* in
``DecodeState`` (as the reference carries its key), and
``FaultPlan.seeded`` draws its plan once at build time.

Flags **calls** (never bare references — ``clock: Callable =
time.monotonic`` as an injectable default is the approved idiom) to:

- ``time.time/monotonic/perf_counter/...`` and ``datetime.now/utcnow``;
- stdlib ``random.*`` and ``np.random.*``;
- torch draws from the global generator: ``torch.rand*`` / ``randn*`` /
  ``randint`` / ``randperm`` / ``multinomial`` / ``bernoulli`` /
  ``normal`` (and the in-place ``.uniform_()`` family) without a
  ``generator=``;
- re-seeding: ``torch.manual_seed``, ``torch.seed``,
  ``torch.cuda.manual_seed*``, and a fresh ``torch.Generator(...)``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.astpass import ModuleContext, Rule, dotted, kwarg
from repro_torch.analysis.findings import Finding

_CLOCKS = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "time.clock_gettime",
})
_DATETIME = frozenset({
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "date.today", "datetime.date.today",
})
# stdlib random API
_STDLIB_RANDOM = frozenset({
    "seed", "random", "randint", "randrange", "choice", "choices",
    "shuffle", "sample", "uniform", "gauss", "normalvariate",
    "expovariate", "betavariate", "getrandbits", "randbytes", "triangular",
})
# torch functions and tensor methods that draw from a generator
_TORCH_DRAWS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "multinomial", "bernoulli", "normal", "poisson",
})
_INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_", "multinomial", "bernoulli",
})
_RESEEDS = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
    "torch.Generator",
})


class NondeterminismRule(Rule):
    id = "serve-time-nondeterminism"
    description = ("wall-clock reads, RNG draws without a carried "
                   "generator, or re-seeding in serving modules — clocks "
                   "must be injected, generators carried")
    hot_path_only = True

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            if fname in _CLOCKS or fname in _DATETIME:
                yield ctx.finding(
                    self.id, node,
                    f"{fname}() reads the wall clock in a serving module — "
                    "inject it (clock=... parameter) so replays and tests "
                    "can control time")
            elif fname in _RESEEDS:
                yield ctx.finding(
                    self.id, node,
                    f"{fname}() seeds fresh state in serving code — the "
                    "generator is carried through DecodeState, never "
                    "re-seeded mid-stream")
            elif self._global_draw(node, fname):
                yield ctx.finding(
                    self.id, node,
                    f"{fname or node.func.attr}() draws from the global "
                    "generator — pass the carried generator=")
            elif fname is None:
                continue
            elif fname.split(".", 1)[0] == "random" and \
                    fname.split(".")[-1] in _STDLIB_RANDOM:
                yield ctx.finding(
                    self.id, node,
                    f"{fname}() draws serve-time entropy — carry explicit "
                    "seeded state instead")
            elif fname.startswith(("np.random.", "numpy.random.")):
                yield ctx.finding(
                    self.id, node,
                    f"{fname}() draws serve-time entropy — draw plans at "
                    "build time (FaultPlan.seeded) and replay them")

    @staticmethod
    def _global_draw(node: ast.Call, fname) -> bool:
        if kwarg(node, "generator") is not None:
            return False
        if fname is not None and fname.startswith("torch.") and \
                fname.split(".")[-1] in _TORCH_DRAWS and fname.count(".") == 1:
            return True
        return isinstance(node.func, ast.Attribute) and \
            not (fname or "").startswith("torch.") and \
            node.func.attr in _INPLACE_DRAWS

    triggers = (
        """\
import time
import numpy as np
import torch

def serve_tick(reqs, probs):
    t0 = time.monotonic()
    noise = np.random.rand()
    pick = torch.multinomial(probs, 1)
    gen = torch.Generator(device="cuda")
    return t0, noise, pick, gen, probs.uniform_()
""",
        """\
import random
import torch

def pick_slot(slots):
    torch.manual_seed(0)
    return random.choice(slots), torch.randn(3)
""",
    )
    non_triggers = (
        """\
import time
from typing import Callable

import torch

def make_scheduler(clock: Callable[[], float] = time.monotonic):
    return clock

def sample(probs, state):
    pick = torch.multinomial(probs, 1, generator=state.generator)
    noise = torch.rand(3, generator=state.generator)
    return pick, noise, probs.uniform_(generator=state.generator)
""",
    )
