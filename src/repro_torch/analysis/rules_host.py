"""Rule: host-sync-in-hot-path.

The serve path's latency rests on the host never waiting for the card mid
segment: the sampler makes every host->device copy before its first launch
and leaves the device in one copy a segment (``serving/sampler.to_host``).
This rule flags the idioms that read a device value on the host, in
hot-path modules:

- ``.item()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")`` and
  ``.synchronize()`` (``torch.cuda.synchronize()``, an event's, a stream's)
  anywhere in the module: each exists to wait for the device or to copy
  from it;
- inside a device body (``astpass``), on a tainted value: ``.tolist()``,
  ``float()`` / ``int()`` / ``bool()``, ``np.asarray`` / ``np.array`` and
  implicit ``__bool__`` (``if x:`` / ``while x:`` / ``assert x`` /
  ``not x``), each of which blocks on the card and would be baked into a
  captured graph as a constant.

Calls in a ``raise`` statement are exempt: the error path is off the hot
path.  Metadata reads (``x.shape[0]``, ``x.stride(1)``, ``len(x)``) never
touch the device and are never flagged.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.astpass import ModuleContext, Rule, dotted
from repro_torch.analysis.findings import Finding

_SYNC_METHODS = frozenset({"item", "cpu", "numpy", "synchronize"})
_DEVICE_SYNC_METHODS = frozenset({"tolist"})
_CONVERSIONS = frozenset({"float", "int", "bool", "complex"})
_NP_PULLS = frozenset({"np.asarray", "np.array", "numpy.asarray",
                       "numpy.array"})


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")``, ``x.to(device="cpu")``, ``x.to(torch.device("cpu"))``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    for arg in list(node.args[:1]) + [kw.value for kw in node.keywords
                                      if kw.arg == "device"]:
        if isinstance(arg, ast.Call) and \
                dotted(arg.func) in ("torch.device", "device") and arg.args:
            arg = arg.args[0]
        if isinstance(arg, ast.Constant) and arg.value == "cpu":
            return True
    return False


class HostSyncRule(Rule):
    id = "host-sync-in-hot-path"
    description = ("device->host synchronisation (.item(), .cpu(), "
                   ".numpy(), synchronize(); float()/.tolist()/implicit "
                   "__bool__ of device values in device bodies) in hot-path "
                   "modules")
    hot_path_only = True

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                if not ctx.in_raise(node):
                    yield from self._check_call(ctx, node)
            elif isinstance(node, (ast.If, ast.While, ast.Assert,
                                   ast.IfExp)):
                yield from self._check_bool(ctx, node, node.test)
            elif isinstance(node, ast.BoolOp):
                for v in node.values:
                    yield from self._check_bool(ctx, node, v)
            elif isinstance(node, ast.UnaryOp) and \
                    isinstance(node.op, ast.Not):
                yield from self._check_bool(ctx, node, node.operand)

    def _check_call(self, ctx: ModuleContext,
                    node: ast.Call) -> Iterator[Finding]:
        fname = dotted(node.func)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_METHODS or _to_cpu(node):
            what = "to(\"cpu\")" if _to_cpu(node) else node.func.attr + "()"
            yield ctx.finding(
                self.id, node,
                f".{what} waits for the device — keep values on the card "
                "and copy once, at the segment's end")
            return
        fn = ctx.device_fn(node)
        if fn is None:
            return
        taint = ctx.tainted_names(fn.node)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _DEVICE_SYNC_METHODS and \
                ctx.tainted(node.func.value, taint):
            yield ctx.finding(
                self.id, node,
                f".{node.func.attr}() of a device value inside a device "
                "body copies it to the host and waits")
        elif (fname in _CONVERSIONS or fname in _NP_PULLS) and node.args \
                and not isinstance(node.args[0], ast.Constant) and \
                ctx.tainted(node.args[0], taint):
            yield ctx.finding(
                self.id, node,
                f"{fname}() of a device value inside a device body forces "
                "a host sync (and a capture would freeze its value)")

    def _check_bool(self, ctx: ModuleContext, node: ast.AST,
                    test: ast.AST) -> Iterator[Finding]:
        # bare tainted name (or `not name`): implicit __bool__ of a device
        # tensor; comparisons on device values are graph-capture-hazard's
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test = test.operand
        if not isinstance(test, ast.Name):
            return
        if test.id in ctx.taint_at(node):
            yield ctx.finding(
                self.id, node,
                f"truthiness of device value '{test.id}' calls __bool__, "
                "which waits for the card — use torch.where")

    triggers = (
        """\
import torch

def step_cuda(x):
    if x:
        x = x + 1
    return float(x)

def serve(y):
    return y.item()
""",
        """\
import numpy as np
import torch

def step_cuda(x, lens):
    torch.cuda.synchronize()
    n = np.asarray(lens)
    return x[: n[0]], lens.tolist()

def gather(out):
    return out.cpu().numpy(), out.to("cpu")
""",
    )
    non_triggers = (
        """\
import torch

def step_cuda(x, n: int, *, window: int = 0, softcap: float = 0.0):
    if n > 0:
        x = x + int(n)
    if window > 0 and softcap:
        x = x * float(softcap)
    b = x.shape[0]
    if x.stride(0) != b or x is None:
        raise ValueError(f"rows {x.tolist()} {x.item()}")
    return x * b
""",
        """\
import numpy as np

def host_side_parse(rows):
    lens = np.asarray(rows)
    return lens.tolist(), int(lens[0])
""",
    )
