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

The gradient is the CUDA kernel ``csrc/ssd_scan_bwd.cu``, wired in by
``SSDScan``, an autograd Function whose forward is the scan kernel asked
to save the state entering every piece but the first, which the backward
reads instead of recomputing it.  With x in bfloat16 (the training type)
it runs on tensor cores in three launches: the causal scores once per
(row, piece) in three bf16 products of split f32 values; one block of 4
warps per (row, group of ``BWD_HEADS`` heads), three blocks an SM, with x
and dy staged by 16-byte ``cp.async``, the products x dy^T and (G L)^T dy
(the weights split in bf16 hi + lo) on ``mma.sync`` and everything
elementwise on the accumulators in registers, writing each group's dG; and
a reduce that sums dG over the groups and forms dC = dG B and dB = dG^T C
once a row.  ``_emulate_bf16_bwd`` in ``tests/test_torch_ssm_training.py``
repeats that arithmetic on the CPU.  With x in float32 (the parity checks,
held to a float64 witness at 2e-5) it keeps f32 FMA tiles in the first
body, then the same reduce.  The bound at the SFT shapes is bytes; see the
source for what set the kernel's time.  No float atomics: two calls give
the same bits.  ``ssd_scan_bwd_plain`` is its plain version.

``ssd_scan`` (``ops.ssd``) dispatches on the tensor's device: a CPU tensor
goes to the plain version ``ref.ssd`` (whose autograd is the CPU
gradient); on a CUDA tensor, a call that autograd records (grad enabled,
an input that requires grad) goes through ``SSDScan``, any other launches
the forward kernel; either raises on what the kernels do not take, an
initial state included.  ``launches`` counts forward launches,
``bwd_launches`` backward calls.
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
SM_SMEM_BYTES = 233472  # an SM's shared memory (228 KB), 1 KB kept a block
THREADS = 256
STATE_TILES = 2         # 4 x 4 state tiles a thread holds in registers
BWD_HEADS = 4           # heads a backward block (``HEADS`` in the source)
BWD_THREADS = 512       # threads of a backward block, float32 x
BWD_LANES = 2           # heads a bf16 backward block works on at once
BWD_KC = 32             # state columns of a bf16 state-term unit
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 9
                 + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def piece_len(chunk: int) -> int:
    """Positions a chunk is staged in at once: ``chunk`` split into
    ceil(chunk / MAX_PIECE) pieces of ceil(chunk / pieces), the last one
    shorter (``piece_len`` in the source)."""
    pieces = -(-chunk // MAX_PIECE)
    return -(-chunk // pieces)


def pieces(l: int, chunk: int) -> int:
    """Pieces of the sequence: ceil(chunk / MAX_PIECE) a chunk."""
    return (l // chunk) * -(-chunk // MAX_PIECE)


def _round16(v: int) -> int:
    return (v + 15) // 16 * 16


def bwd_tiles(chunk: int) -> int:
    """Causal 16 x 16 tiles of a piece (the piece rounded up to 16): the
    floats of a backward dG or scores partial are 256 a tile."""
    nt = _round16(piece_len(chunk)) // 16
    return nt * (nt + 1) // 2


def bwd_smem_bytes(chunk: int, p: int, n: int, has_state: bool,
                   dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one backward block, for x in ``dtype``.

    float32 x (mirrors ``set_layout`` in ``csrc/ssd_scan_bwd.cu``), for a
    piece of T4 positions (rounded up to 4), p4 and n4 rounded up to 4: B
    and C (T4 x n4 each), the scores, the group's dG and a head's weights
    (T4 x T4 each), the row and column sums of M by tile (T4 x T4 / 4
    each), x dt, dy and dxd (T4 x p4 each), a partial-sum table (T4 x
    max(p4, n4) / 4), seven vectors of T4 and a float a warp, a_cum in
    float64; with state terms the head's dS (p4 x n4).

    bfloat16 x (mirrors ``set_layout_mma``), in 16-byte-aligned parts, for
    a piece of T16 positions (rounded up to 16), p16 and n16 rounded up to
    16: x and dy of ``BWD_LANES`` heads (T16 rows of p16 + 8 bf16) in one
    buffer; each lane's dG (the
    causal tiles, 256 floats each); per head of the block a_cum (float64),
    four vectors (T16 floats each), M's column sums by t tile (T16 / 16 x T16)
    and dA; with state terms per head a vector (T16), a table by state
    column chunk (n16 / 32 x T16) and one by dS unit (p16 / 16 x n16 /
    32)."""
    if dtype == torch.bfloat16:
        t16, p16, n16 = _round16(piece_len(chunk)), _round16(p), _round16(n)
        nt, tiles = t16 // 16, bwd_tiles(chunk)
        nkc = -(-n16 // BWD_KC)
        vec = _round16(BWD_HEADS * t16 * 4)

        size = (2 * _round16(BWD_LANES * t16 * (p16 + 8) * 2)
                + _round16(BWD_LANES * tiles * 256 * 4)
                + _round16(BWD_HEADS * t16 * 8) + 4 * vec
                + _round16(BWD_HEADS * nt * t16 * 4)
                + _round16(BWD_HEADS * 4))
        if has_state:
            size += (vec + _round16(BWD_HEADS * nkc * t16 * 4)
                     + _round16(BWD_HEADS * (p16 // 16) * nkc * 4))
        return size
    t4, p4, n4 = _round4(piece_len(chunk)), _round4(p), _round4(n)
    floats = (2 * t4 * n4 + 3 * t4 * t4 + 2 * t4 * (t4 // 4)
              + 3 * t4 * p4 + t4 * max(p4, n4) // 4 + 7 * t4
              + BWD_THREADS // 32 + 2 * t4
              + (p4 * n4 if has_state else 0))
    return 4 * floats


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
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C)):
        return SSDScan.apply(x, dt, A, B, C, chunk)
    return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk)


class SSDScan(torch.autograd.Function):
    """Autograd over the two CUDA kernels: the scan, which also saves the
    state entering every piece but the first, and ``ssd_scan_bwd`` on the
    saved inputs and states.  Returns (y, final state), both
    differentiable; a gradient autograd does not pass (the final state is
    often unused) counts as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        check_args(x, dt, A, B, C, chunk, backward=True)
        y, state, states = ssd_scan_cuda(x, dt, A, B, C, chunk=chunk,
                                         save_states=True)
        ctx.save_for_backward(x, dt, A, B, C, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        grads = ssd_scan_bwd_cuda(x, dt, A, B, C, dy, dstate, states,
                                  chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate=None, *, chunk: int):
    """(dx, d(dt), dA, dB, dC) of ``ref.ssd(x, dt, A, B, C, chunk=chunk)``
    for the upstream gradients dy of y and ``dstate`` (None: zero) of the
    final state, each in its input's dtype: the backward kernel's
    recurrence step by step.  The entering states are recomputed chunk by
    chunk; then, from the last chunk to the first, carrying dS (the
    gradient of the state leaving the chunk), the diagonal block's
    gradients through the weights L[s][t] = exp(a_cum[s] - a_cum[t]), the
    state terms, and dS_in = exp(a_total) dS + sum_s exp(a_cum[s]) dy[s]
    C[s]^T; d(a) is the reverse running sum of d(a_cum).  a_cum and that
    sum are float64, as in the kernel; everything else is float32, or
    float64 for float64 inputs (a witness for the float32 versions)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence {l} is not a multiple of chunk {chunk}")
    nc, T = l // chunk, chunk
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    xr = x.to(f).reshape(b, nc, T, h, p)
    dtr = dt.to(f).reshape(b, nc, T, h)
    Br, Cr = B.to(f).reshape(b, nc, T, n), C.to(f).reshape(b, nc, T, n)
    dyr = dy.to(f).reshape(b, nc, T, h, p)
    Af = A.to(f)
    acum = torch.cumsum(dtr.double() * Af.double(), dim=2)   # (b,c,T,h)

    def ex(v):
        return torch.exp(v.to(f))

    xd = xr * dtr[..., None]
    dec = ex(acum[:, :, -1:] - acum)
    entering, S = [], torch.zeros((b, h, p, n), dtype=f, device=x.device)
    for c in range(nc):
        entering.append(S)
        S = (ex(acum[:, c, -1])[..., None, None] * S
             + torch.einsum("bth,bthp,btn->bhpn", dec[:, c], xd[:, c],
                            Br[:, c]))
    dS = (torch.zeros((b, h, p, n), dtype=f, device=x.device)
          if dstate is None else dstate.to(f))
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    dx, ddt = torch.empty_like(xr), torch.empty_like(dtr)
    dB, dC = torch.empty_like(Br), torch.empty_like(Cr)
    dA = torch.zeros_like(Af)
    for c in reversed(range(nc)):
        a, Bc, Cc, dyc, xdc = acum[:, c], Br[:, c], Cr[:, c], dyr[:, c],             xd[:, c]
        diff = a[:, :, None, :] - a[:, None, :, :]              # (b,s,t,h)
        L = torch.where(causal, ex(diff.masked_fill(~causal, 0.0)), 0.0)
        G = torch.einsum("bsn,btn->bst", Cc, Bc)
        dW = torch.einsum("bshp,bthp->bsth", dyc, xdc)
        Wk = G[..., None] * L
        M = dW * Wk
        dacum = M.sum(2) - M.sum(1)                             # (b,T,h)
        dG = (dW * L).sum(-1)
        dxd = torch.einsum("bsth,bshp->bthp", Wk, dyc)
        dCc = torch.einsum("bst,btn->bsn", dG, Bc)
        dBc = torch.einsum("bst,bsn->btn", dG, Cc)
        # the state terms: S_in enters y, dS leaves through S_out
        eac, dec_c, Sin = ex(a), dec[:, c], entering[c]
        dyo = dyc * eac[..., None]
        dCo = torch.einsum("bshp,bhpn->bshn", dyo, Sin)
        dCc = dCc + dCo.sum(2)
        dacum = dacum + torch.einsum("bshn,bsn->bsh", dCo, Cc)
        dxs = torch.einsum("btn,bhpn->bthp", Bc, dS) * dec_c[..., None]
        dxd = dxd + dxs
        dBc = dBc + torch.einsum("bthp,bhpn->btn", xdc * dec_c[..., None],
                                 dS)
        qt = (xdc * dxs).sum(-1)
        dacum = dacum - qt
        dacum[:, -1] += qt.sum(1) + ex(a[:, -1]) * (dS * Sin).sum((-2, -1))
        dS = (ex(a[:, -1])[..., None, None] * dS
              + torch.einsum("bshp,bsn->bhpn", dyo, Cc))
        da = torch.flip(torch.cumsum(torch.flip(dacum.double(), [1]), 1),
                        [1]).to(f)
        ddt[:, c] = Af * da + (dxd * xr[:, c]).sum(-1)
        dx[:, c] = dxd * dtr[:, c][..., None]
        dA = dA + (da * dtr[:, c]).sum((0, 1))
        dB[:, c], dC[:, c] = dBc, dCc
    return (dx.reshape(b, l, h, p).to(x.dtype),
            ddt.reshape(b, l, h).to(dt.dtype), dA.to(A.dtype),
            dB.reshape(b, l, n).to(B.dtype), dC.reshape(b, l, n).to(C.dtype))


def check_args(x, dt, A, B, C, chunk: int, *, backward: bool = False) -> None:
    """Raise ``ValueError`` on any input the forward kernel (or, with
    ``backward``, the backward kernel too) does not take."""
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
    if not backward:
        return
    need = bwd_smem_bytes(chunk, p, n, True, x.dtype)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk}, head dim {p}, state {n}: the "
                         f"backward kernel needs {need} bytes of shared "
                         f"memory, more than the {MAX_SMEM_BYTES} a block "
                         "has")


def ssd_scan_cuda(x, dt, A, B, C, *, chunk: int, save_states: bool = False):
    """The scan kernel's (y, final state); with ``save_states`` also the
    state entering each piece but the first, (b, pieces - 1, h, p, n) f32
    (None with one piece), which only then is written."""
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
    npieces = pieces(l, chunk)
    states = (torch.empty((b, npieces - 1, h, p, n), dtype=torch.float32,
                          device=dev)
              if save_states and npieces > 1 else None)
    fn = build.load("ssd_scan", "repro_ssd_scan", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), y.data_ptr(), state.data_ptr(),
             None if states is None else states.data_ptr(),
             DTYPES[x.dtype], DTYPES[A.dtype], b, l, h, p, n, int(chunk),
             x.stride(0), x.stride(1), x.stride(2),
             dt.stride(0), dt.stride(1), dt.stride(2),
             B.stride(0), B.stride(1), C.stride(0), C.stride(1),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ssd_scan")
    # scopelint-torch: allow[device-body-side-effect] -- counted at the Python call; a CUDA graph replay repeats the launch without counting it (ROADMAP item 8b)
    launches += 1
    return (y, state, states) if save_states else (y, state)


def ssd_scan_bwd_cuda(x, dt, A, B, C, dy, dstate, states, *, chunk: int):
    """(dx, d(dt), dA, dB, dC) of ``ssd_scan(x, dt, A, B, C)`` for the
    upstream gradients ``dy`` (b, l, h, p) of y and ``dstate`` (b, h, p, n)
    of the final state (None: zero), from the forward's saved ``states``
    (``ssd_scan_cuda(..., save_states=True)``; None with one piece); each in
    its input's dtype, contiguous."""
    global bwd_launches
    dev = x.device
    tensors = [t for t in (x, dt, A, B, C, dy, dstate, states)
               if t is not None]
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("ssd_scan backward needs CUDA tensors on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    check_args(x, dt, A, B, C, chunk, backward=True)
    b, l, h, p = x.shape
    n = B.shape[2]
    if tuple(dy.shape) != (b, l, h, p) or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must be "
                         f"{(b, l, h, p)} {x.dtype}")
    npieces = pieces(l, chunk)
    if npieces > 1 and (states is None or tuple(states.shape) != (
            b, npieces - 1, h, p, n) or states.dtype != torch.float32
            or not states.is_contiguous()):
        raise ValueError(f"{npieces} pieces need the forward's saved states "
                         f"({b}, {npieces - 1}, {h}, {p}, {n}) float32")
    if dstate is not None and (tuple(dstate.shape) != (b, h, p, n)
                               or dstate.dtype != torch.float32):
        raise ValueError(f"dstate {tuple(dstate.shape)} {dstate.dtype} "
                         f"must be {(b, h, p, n)} float32")
    has_state = npieces > 1 or dstate is not None
    groups = -(-h // BWD_HEADS)
    f32 = dict(dtype=torch.float32, device=dev)
    dS = None
    if has_state:
        dS = (dstate.contiguous().clone() if dstate is not None
              else torch.zeros((b, h, p, n), **f32))
    tiles = bwd_tiles(chunk) * 256
    Gp = (torch.empty((b, npieces, tiles), **f32)
          if x.dtype == torch.bfloat16 else None)
    dGp = torch.empty((b, groups, npieces, tiles), **f32)
    dBs, dCs = ((torch.zeros((b, groups, l, n), **f32) for _ in range(2))
                if has_state else (None, None))
    dAp = torch.empty((b, h), **f32)
    dx = torch.empty((b, l, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, l, h), **f32)
    dB, dC = (torch.empty((b, l, n), **f32) for _ in range(2))
    dA = torch.empty((h,), dtype=A.dtype, device=dev)
    dy = dy.contiguous()
    fn = build.load("ssd_scan_bwd", "repro_ssd_scan_bwd", _BWD_ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), dy.data_ptr(),
             None if states is None else states.data_ptr(),
             None if dS is None else dS.data_ptr(), dx.data_ptr(),
             ddt.data_ptr(), None if Gp is None else Gp.data_ptr(),
             dGp.data_ptr(), None if dBs is None else dBs.data_ptr(),
             None if dCs is None else dCs.data_ptr(), dAp.data_ptr(),
             dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
             DTYPES[x.dtype], DTYPES[A.dtype], b, l, h, p, n, int(chunk),
             int(has_state), x.stride(0), x.stride(1), x.stride(2),
             dt.stride(0), dt.stride(1), dt.stride(2),
             B.stride(0), B.stride(1), C.stride(0), C.stride(1),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ssd_scan_bwd")
    # scopelint-torch: allow[device-body-side-effect] -- counted at the Python call; a CUDA graph replay repeats the launch without counting it (ROADMAP item 8b)
    bwd_launches += 1
    return dx, ddt, dA, dB, dC
