"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Libraries
land in ``build/repro_torch_kernels/`` at the repository root, named by a
hash of the sources and flags, so a library is built at first use and again
only when its sources change.  ``build()`` starts one ``nvcc`` per source,
all at once, and waits for them, holding a file lock in the build directory
so that processes started together (one a rank) compile each library once:
the first takes the lock and builds, the others wait for it and find the
libraries built.  Nothing is compiled at import time: the CPU tests import
every module, and there is no ``nvcc`` there.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("topk_retrieval", "flash_attention", "flash_attention_bwd",
           "decode_attention", "paged_decode_attention", "ssd_scan",
           "ssd_scan_bwd", "ssd_decode_step")
NVCC_PATHS = ("nvcc", "/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# every attention library takes any (d, dv) pair of these; a library may
# also take d = dv of dims of its own (``dispatch_head_dims<...>`` in
# ``csrc/attention_common.cuh``) and (d, dv) pairs of its own
# (``dispatch_head_pairs<HeadPair<d, dv>...>``)
PAIR_HEAD_DIMS = (32, 64, 128, 256)

_FNS: Dict[str, "ctypes._CFuncPtr"] = {}      # C entry point by symbol


def _nvcc() -> str:
    for cand in NVCC_PATHS:
        found = shutil.which(cand)
        if found:
            return found
    raise RuntimeError(f"nvcc not found (tried {NVCC_PATHS}): the CUDA "
                       "kernels build only where the CUDA toolkit is")


def lib_path(name: str) -> Path:
    """Where ``name``'s library lives for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _locked():
    """The build directory's lock, held exclusively (blocks until free)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every library in ``names`` that is missing, in parallel.

    The compiler's output (``-Xptxas=-v``: registers, shared memory, spills
    per kernel) is kept beside each library as ``<lib>.log``.
    """
    paths = {n: lib_path(n) for n in names}
    if all(path.exists() for path in paths.values()):
        return paths
    nvcc = _nvcc()                  # no compiler: raise, leaving no file
    with _locked():
        _compile(nvcc, [n for n, path in paths.items() if not path.exists()],
                 paths)
    return paths


def _compile(nvcc: str, todo, paths: Dict[str, Path]) -> None:
    procs = {}
    for name in todo:
        path = paths[name]
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (rc {rc}): "
                          + paths[name].with_suffix(".log").read_text()[-4000:])
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel library ``name``, building the
    library first if needed.  Every pointer and the stream are
    ``ctypes.c_void_p`` in ``argtypes`` (ctypes would cut them to 32 bits
    otherwise); every entry point returns a ``cudaError_t``."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(ctypes.CDLL(str(build([name])[name])), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_head_dims(d: int, dv: int, dims: Sequence[int], what: str,
                    pairs: Sequence = ()) -> None:
    """Raise ``ValueError`` unless ``what``, instantiated for ``dims`` and
    the (d, dv) ``pairs``, takes (d, dv): any pair of ``PAIR_HEAD_DIMS``,
    d = dv of its other dims, and each of ``pairs``."""
    if (d, dv) in pairs or d in dims and dv in dims and (
            d == dv or (d in PAIR_HEAD_DIMS and dv in PAIR_HEAD_DIMS)):
        return
    extra = tuple(x for x in dims if x not in PAIR_HEAD_DIMS)
    raise ValueError(
        f"head dims d={d}, dv={dv}: {what} takes any (d, dv) pair of "
        f"{PAIR_HEAD_DIMS}" + (f", d = dv in {extra}" if extra else "")
        + (f" and (d, dv) in {tuple(pairs)}" if pairs else ""))
