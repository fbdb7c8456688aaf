"""Rule: cuda-kernel-contract.

Stands where the reference's ``pallas-kernel-contract`` stands.  The port's
kernels are plain C entry points in ``csrc/*.cu``, loaded with ctypes by
``kernels/build.load(name, symbol, argtypes)``; a count or a kind that
drifts between the Python ``argtypes`` and the C signature does not raise,
it corrupts the launch.  In every function that calls a symbol from
``build.load``:

(a) the kernel's ``check_*`` runs before the call;
(b) the last argument is ``torch.cuda.current_stream(...).cuda_stream``;
(c) the returned ``cudaError_t`` goes through ``build.check``;
(d) the call is not inside a ``for`` / ``while`` loop (one launch a call);
(e) it is not inside a ``try`` whose handler falls back instead of
    raising (there is no fallback: a CUDA tensor runs the kernel or
    raises);
(f) the argtypes, read statically (``[ctypes.c_void_p] * 5 +
    [ctypes.c_int] * 7 + ...``), match the ``extern "C" int <symbol>(...)``
    signature in ``csrc/*.cu`` in count and kind: a pointer (or
    ``cudaStream_t``) to ``c_void_p``, ``int`` to ``c_int``, ``long long``
    to ``c_longlong``, ``float`` to ``c_float`` — and the call passes as
    many arguments.

Check (f) is the counterpart of the reference's check that an index map's
arity equals the grid's rank.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import Dict, Iterator, List, Optional

from repro_torch.analysis.astpass import (ModuleContext, Rule, _FunctionNode,
                                          dotted, in_loop)
from repro_torch.analysis.findings import Finding

_LOADS = frozenset({"build.load", "load"})
_CHECKS = frozenset({"build.check", "check"})
_STREAM = "torch.cuda.current_stream"
_CTYPES = {"c_void_p": "pointer", "c_char_p": "pointer", "c_int": "int",
           "c_int32": "int", "c_longlong": "long long",
           "c_int64": "long long", "c_float": "float", "c_double": "double"}
_C_TYPES = {"int": "int", "int32_t": "int", "long long": "long long",
            "int64_t": "long long", "float": "float", "double": "double"}
_EXTERN_RX = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def c_signatures(source: str) -> Dict[str, List[str]]:
    """``symbol -> [kind of each parameter]`` of every ``extern "C" int``
    function in ``source``."""
    source = re.sub(r"/\*.*?\*/", " ", source, flags=re.S)
    source = re.sub(r"//[^\n]*", " ", source)
    out: Dict[str, List[str]] = {}
    for m in _EXTERN_RX.finditer(source):
        kinds = []
        for param in m.group(2).split(","):
            param = param.strip()
            if not param or param == "void":
                continue
            if "*" in param or "cudaStream_t" in param:
                kinds.append("pointer")
                continue
            words = [w for w in param.split() if w != "const"][:-1]
            kinds.append(_C_TYPES.get(" ".join(words), " ".join(words)))
        out[m.group(1)] = kinds
    return out


def package_csrc(path: str) -> Optional[str]:
    """The text of ``csrc/*.cu`` of the package ``path`` lies in."""
    for parent in pathlib.Path(path).resolve().parents:
        csrc = parent / "csrc"
        if csrc.is_dir():
            return "\n".join(p.read_text() for p in sorted(csrc.glob("*.cu")))
        if parent.name == "repro_torch":
            break
    return None


def argtype_kinds(node: ast.AST, assigns: Dict[str, ast.AST]
                  ) -> Optional[List[str]]:
    """The ctypes kinds of an argtypes expression, or None if it cannot be
    read statically."""
    if isinstance(node, ast.Name) and node.id in assigns:
        return argtype_kinds(assigns[node.id], assigns)
    if isinstance(node, (ast.List, ast.Tuple)):
        kinds = [_CTYPES.get((dotted(e) or "").split(".")[-1])
                 for e in node.elts]
        return None if None in kinds else kinds
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = argtype_kinds(node.left, assigns), \
            argtype_kinds(node.right, assigns)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, n in ((node.left, node.right), (node.right, node.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                kinds = argtype_kinds(seq, assigns)
                return None if kinds is None else kinds * n.value
    if isinstance(node, ast.Call) and dotted(node.func) in ("list", "tuple") \
            and len(node.args) == 1:
        return argtype_kinds(node.args[0], assigns)
    return None


def _literal_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class KernelContractRule(Rule):
    id = "cuda-kernel-contract"
    description = ("ctypes kernel launches: check_* first, the current "
                   "stream last, build.check on the result, one launch a "
                   "call, no fallback, argtypes equal to the extern \"C\" "
                   "signature in csrc/")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        assigns = {t.id: node.value for node in ctx.tree.body
                   if isinstance(node, ast.Assign) for t in node.targets
                   if isinstance(t, ast.Name)}
        sigs = None
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, _FunctionNode):
                continue
            loads = self._loads(ctx, fn)
            for call, load in self._kernel_calls(ctx, fn, loads):
                if sigs is None:
                    src = ctx.csrc if ctx.csrc is not None else \
                        package_csrc(ctx.path)
                    sigs = c_signatures(src or "")
                yield from self._check_launch(ctx, fn, call)
                yield from self._check_argtypes(ctx, call, load, assigns,
                                                sigs)

    @staticmethod
    def _loads(ctx: ModuleContext, fn: ast.AST) -> Dict[str, ast.Call]:
        """Names ``fn`` binds to ``build.load(...)``."""
        out = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    dotted(node.value.func) in _LOADS and \
                    ctx.enclosing_function(node) is fn:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = node.value
        return out

    @staticmethod
    def _kernel_calls(ctx: ModuleContext, fn: ast.AST,
                      loads: Dict[str, ast.Call]):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or \
                    ctx.enclosing_function(node) is not fn:
                continue
            if isinstance(node.func, ast.Name) and node.func.id in loads:
                yield node, loads[node.func.id]
            elif isinstance(node.func, ast.Call) and \
                    dotted(node.func.func) in _LOADS:
                yield node, node.func

    def _check_launch(self, ctx: ModuleContext, fn: ast.AST,
                      call: ast.Call) -> Iterator[Finding]:
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
        checked = any(
            (dotted(n.func) or "").split(".")[-1].startswith("check_")
            and n.lineno < call.lineno for n in calls)
        if not checked:
            yield ctx.finding(
                self.id, call,
                "kernel launched without its check_* before it — the C "
                "side trusts every shape and stride it is given")
        last = call.args[-1] if call.args else None
        if not (isinstance(last, ast.Attribute)
                and last.attr == "cuda_stream"
                and isinstance(last.value, ast.Call)
                and dotted(last.value.func) == _STREAM):
            yield ctx.finding(
                self.id, call,
                "the last argument is not torch.cuda.current_stream(...)"
                ".cuda_stream — the kernel would run outside PyTorch's "
                "stream order")
        if not self._result_checked(ctx, fn, call, calls):
            yield ctx.finding(
                self.id, call,
                "the returned cudaError_t does not go through build.check "
                "— a failed launch would pass silently")
        if in_loop(ctx, call):
            yield ctx.finding(
                self.id, call,
                "kernel launched inside a loop — one launch a call, so the "
                "launch counts and the bound hold")
        if self._falls_back(ctx, call):
            yield ctx.finding(
                self.id, call,
                "kernel launched inside a try whose handler does not "
                "re-raise — a CUDA tensor runs the kernel or raises, with "
                "no fallback")

    @staticmethod
    def _result_checked(ctx: ModuleContext, fn: ast.AST, call: ast.Call,
                        calls: List[ast.Call]) -> bool:
        parent = ctx.parents.get(call)
        if isinstance(parent, ast.Call) and dotted(parent.func) in _CHECKS:
            return True
        if not (isinstance(parent, ast.Assign) and len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)):
            return False
        err = parent.targets[0].id
        return any(dotted(n.func) in _CHECKS and n.args
                   and isinstance(n.args[0], ast.Name)
                   and n.args[0].id == err and n.lineno >= call.lineno
                   for n in calls)

    @staticmethod
    def _falls_back(ctx: ModuleContext, call: ast.Call) -> bool:
        child, cur = call, ctx.parents.get(call)
        while cur is not None and not isinstance(cur, _FunctionNode):
            if isinstance(cur, ast.Try) and child in cur.body and any(
                    not (h.body and isinstance(h.body[-1], ast.Raise))
                    for h in cur.handlers):
                return True
            child, cur = cur, ctx.parents.get(cur)
        return False

    def _check_argtypes(self, ctx: ModuleContext, call: ast.Call,
                        load: ast.Call, assigns: Dict[str, ast.AST],
                        sigs: Dict[str, List[str]]) -> Iterator[Finding]:
        symbol = _literal_str(load.args[1] if len(load.args) > 1 else None)
        spec = load.args[2] if len(load.args) > 2 else None
        kinds = None if spec is None else argtype_kinds(spec, assigns)
        if symbol is None or kinds is None:
            yield ctx.finding(
                self.id, load,
                "build.load's symbol or argtypes cannot be read statically "
                "— pass a string and a list of ctypes types")
            return
        want = sigs.get(symbol)
        if want is None:
            yield ctx.finding(
                self.id, load,
                f"no extern \"C\" int {symbol}(...) in csrc/*.cu")
            return
        if kinds != want:
            if len(kinds) != len(want):
                msg = f"{len(kinds)} argtypes for {len(want)} C parameters"
            else:
                i = next(i for i, (a, b) in enumerate(zip(kinds, want))
                         if a != b)
                msg = (f"argument {i} is {kinds[i]} in argtypes, "
                       f"{want[i]} in C")
            yield ctx.finding(
                self.id, load,
                f"argtypes do not match {symbol}'s C signature: {msg}")
        elif not any(isinstance(a, ast.Starred) for a in call.args) and \
                len(call.args) != len(want):
            yield ctx.finding(
                self.id, call,
                f"{len(call.args)} arguments passed to {symbol}, which "
                f"takes {len(want)}")

    corpus_csrc = """\
// a toy kernel's entry point
extern "C" int repro_toy(const void* x, void* y, int n, long long stride,
                         float scale, void* stream) {
  return 0;
}
"""
    triggers = (
        """\
import ctypes
from repro_torch.kernels import build

# c_int where the C side takes long long
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                            ctypes.c_void_p]

def toy_cuda(x, y):
    fn = build.load("toy", "repro_toy", _ARGTYPES)
    for _ in range(2):
        fn(x.data_ptr(), y.data_ptr(), x.numel(), x.stride(0), 1.0, 0)
    return y
""",
        """\
import ctypes
import torch
from repro_torch.kernels import build

# one short
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_void_p])

def toy_cuda(x, y):
    check_args(x, y)
    fn = build.load("toy", "repro_toy", _ARGTYPES)
    try:
        err = fn(x.data_ptr(), y.data_ptr(), x.numel(), x.stride(0),
                 torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "toy")
    except RuntimeError:
        y = x * 2.0
    return y
""",
    )
    non_triggers = (
        """\
import ctypes
import torch
from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_float, ctypes.c_void_p])

def toy_cuda(x, y, *, scale: float = 1.0):
    check_args(x, y)
    fn = build.load("toy", "repro_toy", _ARGTYPES)
    err = fn(x.data_ptr(), y.data_ptr(), x.numel(), x.stride(0),
             float(scale), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "toy")
    return y
""",
    )
