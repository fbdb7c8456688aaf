"""Mamba2 SSD decode step, in place: the CUDA kernel
``csrc/ssd_decode_step.cu`` and its plain PyTorch version.

The single-token recurrence the reference runs as plain XLA
(``repro/kernels/ref.py::ssd_decode_step``; no Pallas kernel): with
a = exp(dt A), state <- state a + (x dt) B^T and y = state C over n.  On
the H100 it is bound by the bytes of the f32 state, one read and one write
a step; the kernel makes exactly that one pass, one block per (batch,
head), and writes the new state over the old one.

``ssd_decode_step`` (``ops.ssd_decode_step``) updates ``state`` **in place**
and returns ``(y, state)``, ``state`` being the argument itself (the
reference returns a new array).  It dispatches on the state's device: a CPU
tensor runs the plain version ``ref.ssd_decode_step`` and copies its
result into ``state``; a CUDA tensor launches the kernel, or raises on what
the kernel does not take.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 4096            # B and C of a row in 32 KB of shared memory

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """state (b, h, p, n) f32, x (b, h, p), dt (b, h), A (h,), B, C (b, n)
    -> (y (b, h, p) in x's dtype, state), the state updated in place."""
    if state.device.type == "cpu":
        y, new = ref.ssd_decode_step(state, x, dt, A, B, C)
        state.copy_(new)
        return y, state
    return ssd_decode_step_cuda(state, x, dt, A, B, C)


def check_args(state, x, dt, A, B, C) -> None:
    """Raise ``ValueError`` on any input the kernel does not take: it reads
    and writes the state in place through its strides, so nothing is
    copied to make an input fit.  x, dt, B and C may have any strides (the
    model passes slices of its conv output, batch dim fastest); the
    state's rows must be contiguous and 16-byte aligned."""
    if state.dim() != 4 or x.dim() != 3 or dt.dim() != 2 or A.dim() != 1 \
            or B.dim() != 2 or C.dim() != 2:
        raise ValueError("state, x, dt, A, B, C must be (b, h, p, n), "
                         "(b, h, p), (b, h), (h,), (b, n), (b, n)")
    b, h, p, n = state.shape
    if tuple(x.shape) != (b, h, p) or tuple(dt.shape) != (b, h) \
            or tuple(A.shape) != (h,) or tuple(B.shape) != (b, n) \
            or tuple(C.shape) != (b, n):
        raise ValueError(f"shape mismatch state {tuple(state.shape)} x "
                         f"{tuple(x.shape)} dt {tuple(dt.shape)} A "
                         f"{tuple(A.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)}")
    for name, t in (("state", state), ("x", x), ("dt", dt), ("B", B),
                    ("C", C)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: the kernel takes "
                             "float32")
    if A.dtype not in DTYPES:
        raise ValueError(f"A {A.dtype}: the kernel takes float32 or "
                         "bfloat16")
    if b == 0 or h == 0 or p == 0 or n == 0:
        raise ValueError("empty batch, heads, head dim or state")
    if n % 4 or n > MAX_N:
        raise ValueError(f"state size {n}: the kernel takes a multiple of "
                         f"4 (16-byte rows) up to {MAX_N}")
    if state.stride(3) != 1 or any(state.stride(i) % 4 for i in range(3)) \
            or state.data_ptr() % 16:
        raise ValueError(f"state strides {state.stride()}: rows must be "
                         "contiguous and 16-byte aligned")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")


def ssd_decode_step_cuda(state, x, dt, A, B, C):
    global launches
    dev = state.device
    if dev.type != "cuda" or any(t.device != dev for t in (x, dt, A, B, C)):
        raise ValueError(f"ssd_decode_step kernel needs CUDA tensors on one "
                         f"device, got "
                         f"{[str(t.device) for t in (state, x, dt, A, B, C)]}")
    check_args(state, x, dt, A, B, C)
    b, h, p, n = state.shape
    y = torch.empty((b, h, p), dtype=torch.float32, device=dev)
    fn = build.load("ssd_decode_step", "repro_ssd_decode_step", _ARGTYPES)
    err = fn(state.data_ptr(), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
             B.data_ptr(), C.data_ptr(), y.data_ptr(), DTYPES[A.dtype],
             b, h, p, n, state.stride(0), state.stride(1), state.stride(2),
             x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
             dt.stride(1), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ssd_decode_step")
    # scopelint-torch: allow[device-body-side-effect] -- counted at the Python call; a CUDA graph replay repeats the launch without counting it (ROADMAP item 8b)
    launches += 1
    return y, state
