"""Mamba2 SSD chunk scan: the CUDA kernel ``csrc/ssd_scan.cu`` and its plain
PyTorch version.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (Pallas TPU): the chunked
scan from a zero state, y (b, l, h, p) in x's dtype and the final state
(b, h, p, n) in float32.  On the H100 the prefill shape is bound by its
float32 arithmetic on CUDA cores; the kernel gives one block per row and
group of ``GROUP`` heads, computes the causal scores C.B^T of a chunk once
for the group, sums a_cum in float64, and runs every product as
register-tiled f32 FFMAs: y as (T x T)(T x p) tiles, each head's (p, n)
state held in registers as 4 x 4 tiles while a rank-T product updates it,
and written to device memory once.  A chunk longer than ``MAX_PIECE`` is
walked in pieces of at most ``MAX_PIECE`` positions.  x, dt, B and C are
read in their model layouts through strides, so the model passes its
projection slices without a copy.  See the source for the design.

``ssd_scan`` (``ops.ssd``) dispatches on the tensor's device: a CPU tensor
goes to the plain version ``ref.ssd``, a CUDA tensor launches the kernel
(or raises on what the kernel does not take, an initial state included).
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

MAX_CHUNK = 128
MAX_PIECE = 64          # positions of a chunk staged at once
GROUP = 4               # heads a block
# dynamic shared memory a block may use on the H100 (227 KB)
MAX_SMEM_BYTES = 232448
THREADS = 256
STATE_TILES = 2         # 4 x 4 state tiles a thread holds in registers
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def piece_len(chunk: int) -> int:
    """Positions a chunk is staged in at once: ``chunk`` split into
    ceil(chunk / MAX_PIECE) pieces of ceil(chunk / pieces), the last one
    shorter (``piece_len`` in the source)."""
    pieces = -(-chunk // MAX_PIECE)
    return -(-chunk // pieces)


def smem_bytes(l: int, chunk: int, p: int, n: int) -> int:
    """Dynamic shared memory of one block (mirrors ``set_layout`` in the
    source), in rows of a piece: B and C (n rounded up to 4, + 4 of
    padding) each, the scores and one head's weights (the piece rounded up
    to 4, squared) each, x dt and X' (p rounded up to 4) each, dt, a_cum (in
    float64, two floats each) and the decays; and where the sequence has
    more than one piece, the entering state (p, n + 4) staged for y."""
    tp = piece_len(chunk)
    t4, p4, ns = _round4(tp), _round4(p), _round4(n) + 4
    floats = (2 * t4 * ns + 2 * t4 * t4 + 2 * t4 * p4 + 4 * t4
              + (p4 * ns if l > tp else 0))
    return 4 * floats


def state_fits(p: int, n: int) -> bool:
    """Whether the (p, n) state fits the threads' register tiles: n / 4
    column quads at most ``THREADS``, and the p / 4 row quads within the
    ``STATE_TILES`` bands of ``THREADS // (n / 4)`` threads."""
    cq, rq = _round4(n) // 4, _round4(p) // 4
    return cq <= THREADS and rq <= (THREADS // cq) * STATE_TILES


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, l, h, p), dt (b, l, h), A (h,), B, C (b, l, n) -> (y (b, l,
    h, p) in x's dtype, final state (b, h, p, n) f32).

    On the card the kernel starts from a zero state, as the Pallas kernel
    does: an ``init_state`` there raises (the reference's ``ops.ssd`` raises
    on it for Pallas too) instead of sliding onto the plain version."""
    if x.device.type == "cpu":
        return ref.ssd(x, dt, A, B, C, chunk=chunk, init_state=init_state)
    if init_state is not None:
        raise NotImplementedError("the ssd_scan kernel starts from a zero "
                                  "state")
    return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk)


def check_args(x, dt, A, B, C, chunk: int) -> None:
    """Raise ``ValueError`` on any input the kernel does not take."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 \
            or C.dim() != 3:
        raise ValueError("x, dt, A, B, C must be (b, l, h, p), (b, l, h), "
                         "(h,), (b, l, n), (b, l, n)")
    b, l, h, p = x.shape
    n = B.shape[2]
    if tuple(dt.shape) != (b, l, h) or tuple(A.shape) != (h,) \
            or tuple(B.shape) != (b, l, n) or tuple(C.shape) != (b, l, n):
        raise ValueError(f"shape mismatch x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)}")
    if x.dtype not in DTYPES or A.dtype not in DTYPES:
        raise ValueError(f"x {x.dtype} / A {A.dtype}: the kernel takes "
                         "float32 or bfloat16")
    if dt.dtype != torch.float32 or B.dtype != torch.float32 \
            or C.dtype != torch.float32:
        raise ValueError(f"dt {dt.dtype}, B {B.dtype}, C {C.dtype}: the "
                         "kernel takes float32")
    if b == 0 or l == 0 or h == 0 or p == 0 or n == 0:
        raise ValueError("empty batch, sequence, heads, head dim or state")
    if not 1 <= chunk <= MAX_CHUNK or l % chunk:
        raise ValueError(f"chunk {chunk}: the kernel takes 1 <= chunk <= "
                         f"{MAX_CHUNK} dividing the sequence {l}")
    if smem_bytes(l, chunk, p, n) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk}, head dim {p}, state {n} need "
                         f"{smem_bytes(l, chunk, p, n)} bytes of shared "
                         f"memory, more than the {MAX_SMEM_BYTES} a block "
                         "has")
    if not state_fits(p, n):
        raise ValueError(f"a ({p}, {n}) state does not fit the register "
                         f"tiles of {THREADS} threads ({STATE_TILES} 4 x 4 "
                         "tiles a thread)")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")


def ssd_scan_cuda(x, dt, A, B, C, *, chunk: int):
    global launches
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (dt, A, B, C)):
        raise ValueError(f"ssd_scan kernel needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in (x, dt, A, B, C)]}")
    check_args(x, dt, A, B, C, chunk)
    b, l, h, p = x.shape
    n = B.shape[2]
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    fn = build.load("ssd_scan", "repro_ssd_scan", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), y.data_ptr(), state.data_ptr(),
             DTYPES[x.dtype], DTYPES[A.dtype], b, l, h, p, n, int(chunk),
             x.stride(0), x.stride(1), x.stride(2),
             dt.stride(0), dt.stride(1), dt.stride(2),
             B.stride(0), B.stride(1), C.stride(0), C.stride(1),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ssd_scan")
    launches += 1
    return y, state
