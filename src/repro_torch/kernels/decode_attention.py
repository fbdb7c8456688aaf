"""Decode attention: the CUDA kernels ``csrc/decode_attention.cu`` and
``csrc/paged_decode_attention.cu`` with their plain PyTorch versions.

``decode_attention`` replaces ``repro/kernels/decode_attention.py::
decode_attention`` (Pallas TPU).  One token per row attends a dense
(b, hkv, S, d) cache up to the row's valid length.  On the H100 this is
bound by reading the valid K/V once; as on the TPU, one block per (row,
kv-head) serves its grouped q-heads, up to 4 (a larger group takes one
block for each 4 heads, side by side, the later ones reading the K/V from
L2), and it stops at the row's length.  See ``csrc/decode_common.cuh`` for
the design.

``paged_decode_attention`` replaces ``repro/kernels/decode_attention.py::
paged_decode_attention``: the same math over block-paged storage, each
logical page resolved through the row's page table, masked by ``cache_len``
and ``kv_cap``.  Its kernel shares the dense kernel's body
(``csrc/decode_common.cuh``: keys split by logical position, one combine),
so the two agree bit for bit on the same logical cache.

Both dispatch on the tensor's device: a CPU tensor goes to the plain
version, a CUDA tensor launches the kernel (or raises).  ``launches`` and
``paged_launches`` count the two kernels' launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = build.PAIR_HEAD_DIMS + (112,)   # both kernels; 112 with dv = d
MAX_GROUP = 16              # grouped q-heads one block serves
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
paged_launches = 0
MAX_TABLE_WIDTH = 8192      # pages per row the paged kernel takes

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 8
             + [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])

_PAGED_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 8
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])

CacheLen = Union[int, torch.Tensor]


def _lengths(cache_len: CacheLen, b: int, device) -> torch.Tensor:
    """Scalar or (b,) valid lengths -> (b,) int32 on ``device``."""
    # scopelint-torch: allow[graph-capture-hazard] -- the decode step passes its int32 positions on the card, which as_tensor returns as they are; an int uploads, as in the kernel checks
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    return lens.reshape(-1).expand(b) if lens.numel() == 1 else lens


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: CacheLen, *,
                     window: int = 0, softcap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, hq, 1, d); caches: (b, hkv, S, d[v]); cache_len: scalar or
    (b,) — valid entries INCLUDING the current token.  -> (b, hq, 1, dv)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      window=window, softcap=softcap,
                                      scale=scale)
    return decode_attention_cuda(q, k_cache, v_cache, cache_len,
                                 window=window, softcap=softcap, scale=scale)


def decode_attention_plain(q, k_cache, v_cache, cache_len: CacheLen, *,
                           window: int = 0, softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The XLA decode body of ``repro/kernels/ops.py::decode_attention``,
    except that a row with no valid key (cache_len 0) gives 0, as the TPU
    kernel does, where the XLA body averages v."""
    b, hq, _, d = q.shape
    hkv, S = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    lens = _lengths(cache_len, b, q.device)

    qf = q.float().reshape(b, hkv, g, d) * scale
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.float())
    if softcap > 0.0:
        s = ref.softcap_fn(s, softcap)
    kpos = torch.arange(S, device=q.device)[None]          # (1, S)
    mask = kpos < lens[:, None]
    if window > 0:
        mask &= kpos >= (lens[:, None] - window)
    s = torch.where(mask[:, None, None], s, ref.NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    out = out.masked_fill(~mask.any(dim=-1)[:, None, None, None], 0.0)
    return out.reshape(b, hq, 1, dv).to(q.dtype)


def check_args(q, k_cache, v_cache, lens: torch.Tensor) -> None:
    """Raise ``ValueError`` on any input the kernel does not take."""
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("q and caches must be 4-D (b, h, s, d)")
    b, hq, one, d = q.shape
    _, hkv, S, _ = k_cache.shape
    if one != 1:
        raise ValueError(f"decode takes one query token, got {one}")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}:"
                         " the kernel takes float32 or bfloat16, all the same")
    if k_cache.shape[0] != b or tuple(v_cache.shape[:3]) != (b, hkv, S) \
            or k_cache.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    if hkv == 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"hq {hq} / hkv {hkv}: need a group of 1..{MAX_GROUP}")
    build.check_head_dims(d, v_cache.shape[3], HEAD_DIMS,
                          "the decode kernel")
    if b == 0 or S == 0:
        raise ValueError("empty batch or cache")
    if lens.shape != (b,) or lens.dtype != torch.int32:
        raise ValueError(f"cache_len must be a scalar or ({b},) int32")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")


def decode_attention_cuda(q, k_cache, v_cache, cache_len: CacheLen, *,
                          window: int = 0, softcap: float = 0.0,
                          scale: Optional[float] = None) -> torch.Tensor:
    global launches
    dev = q.device
    if dev.type != "cuda" or k_cache.device != dev or v_cache.device != dev:
        raise ValueError(f"decode_attention kernel needs CUDA tensors on one "
                         f"device, got {dev}/{k_cache.device}/{v_cache.device}")
    b, hq, _, d = q.shape
    lens = _lengths(cache_len, b, dev).contiguous()
    check_args(q, k_cache, v_cache, lens)
    hkv, S, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, 1, dv), dtype=q.dtype, device=dev)
    fn = build.load("decode_attention", "repro_decode_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lens.data_ptr(), out.data_ptr(), DTYPES[q.dtype], b, hq, hkv, S,
             d, dv, q.stride(0), q.stride(1),
             k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
             v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
             int(window), float(softcap), float(scale),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "decode_attention")
    # scopelint-torch: allow[device-body-side-effect] -- counted at the Python call; a CUDA graph replay repeats the launch without counting it (ROADMAP item 8b)
    launches += 1
    return out


# ---------------------------------------------------------------------------
# block-paged cache
# ---------------------------------------------------------------------------
def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, cache_len: CacheLen,
                           page_table: torch.Tensor, *, page_size: int,
                           kv_cap: int, softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, hq, 1, d); k_pages/v_pages: (n_pages + 1, hkv, page_size,
    d[v]) physical page storage, the last page the trash page; page_table:
    (b, W) int32; cache_len: scalar or (b,) valid lengths INCLUDING the
    current token; row i attends logical keys [0, min(cache_len[i],
    kv_cap)).  -> (b, hq, 1, dv)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, cache_len, page_table, page_size=page_size,
            kv_cap=kv_cap, softcap=softcap, scale=scale)
    return paged_decode_attention_cuda(
        q, k_pages, v_pages, cache_len, page_table, page_size=page_size,
        kv_cap=kv_cap, softcap=softcap, scale=scale)


def paged_decode_attention_plain(q, k_pages, v_pages, cache_len: CacheLen,
                                 page_table, *, page_size: int, kv_cap: int,
                                 softcap: float = 0.0,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """The XLA paged body of ``repro/kernels/ops.py``: gather each row's
    pages into a dense view, slice it to ``kv_cap``, then run
    ``decode_attention_plain`` — bit-identical to the dense plain version
    on the gathered cache."""
    b = q.shape[0]
    hkv = k_pages.shape[1]
    n_w = page_table.shape[1]
    idx = page_table.long()
    kd = k_pages[idx].permute(0, 2, 1, 3, 4).reshape(
        b, hkv, n_w * page_size, -1)[:, :, :kv_cap]
    vd = v_pages[idx].permute(0, 2, 1, 3, 4).reshape(
        b, hkv, n_w * page_size, -1)[:, :, :kv_cap]
    return decode_attention_plain(q, kd, vd, cache_len, softcap=softcap,
                                  scale=scale)


def check_paged_args(q, k_pages, v_pages, lens: torch.Tensor, page_table,
                     page_size: int, kv_cap: int) -> None:
    """Raise ``ValueError`` on any input the paged kernel does not take."""
    if q.dim() != 4 or k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError("q and page storage must be 4-D")
    b, hq, one, d = q.shape
    n_total, hkv, page, _ = k_pages.shape
    if one != 1:
        raise ValueError(f"decode takes one query token, got {one}")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_pages.dtype}/{v_pages.dtype}:"
                         " the kernel takes float32 or bfloat16, all the same")
    if tuple(v_pages.shape[:3]) != (n_total, hkv, page) \
            or k_pages.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k_pages.shape)} v {tuple(v_pages.shape)}")
    if page != page_size or page_size < 1:
        raise ValueError(f"page storage holds pages of {page} slots, "
                         f"page_size is {page_size}")
    if hkv == 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"hq {hq} / hkv {hkv}: need a group of 1..{MAX_GROUP}")
    build.check_head_dims(d, v_pages.shape[3], HEAD_DIMS,
                          "the paged decode kernel")
    if b == 0:
        raise ValueError("empty batch")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b or not page_table.is_contiguous():
        raise ValueError(f"page_table must be a contiguous ({b}, W) int32 "
                         f"tensor, got {page_table.dtype} "
                         f"{tuple(page_table.shape)}")
    n_w = page_table.shape[1]
    if not 1 <= n_w <= MAX_TABLE_WIDTH:
        raise ValueError(f"page table width {n_w}: the kernel takes "
                         f"1..{MAX_TABLE_WIDTH}")
    if not 1 <= kv_cap <= n_w * page_size:
        raise ValueError(f"kv_cap {kv_cap} outside [1, {n_w} x {page_size}]")
    if lens.shape != (b,) or lens.dtype != torch.int32:
        raise ValueError(f"cache_len must be a scalar or ({b},) int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")


def paged_decode_attention_cuda(q, k_pages, v_pages, cache_len: CacheLen,
                                page_table, *, page_size: int, kv_cap: int,
                                softcap: float = 0.0,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    global paged_launches
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (k_pages, v_pages, page_table)):
        raise ValueError(
            f"paged_decode_attention kernel needs CUDA tensors on one device, "
            f"got {dev}/{k_pages.device}/{v_pages.device}/{page_table.device}")
    b, hq, _, d = q.shape
    lens = _lengths(cache_len, b, dev).contiguous()
    check_paged_args(q, k_pages, v_pages, lens, page_table, page_size, kv_cap)
    hkv, dv = k_pages.shape[1], v_pages.shape[3]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, 1, dv), dtype=q.dtype, device=dev)
    fn = build.load("paged_decode_attention", "repro_paged_decode_attention",
                    _PAGED_ARGTYPES)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             lens.data_ptr(), page_table.data_ptr(), out.data_ptr(),
             DTYPES[q.dtype], b, hq, hkv, d, dv, int(page_size),
             page_table.shape[1], int(kv_cap), q.stride(0), q.stride(1),
             k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
             v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
             float(softcap), float(scale),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "paged_decode_attention")
    # scopelint-torch: allow[device-body-side-effect] -- counted at the Python call; a CUDA graph replay repeats the launch without counting it (ROADMAP item 8b)
    paged_launches += 1
    return out
