"""Block-paged KV-cache pool: fixed-size pages, per-row page tables,
free-list allocation (no page sharing).

The port of ``repro/serving/kv_pool.py``; host-side numpy, with the same
accounting step for step.  Dense decode allocates every slot's worst case up
front — KV memory is O(slots x horizon) even when most rows drain at EOS
after a handful of tokens.  The pool converts that to O(live tokens): KV
storage is a flat array of ``n_pages`` fixed-size pages plus one **trash
page**, and each decode row owns a page table mapping its logical page index
to a physical page.  Pages are allocated on demand as positions advance
(prompt pages at admission, decode pages per segment) and released when the
row retires at EOS/parse, so a drained slot's memory is immediately reusable
by the next queued prompt — slot admission checks free pages, not remaining
horizon.

Layout per attention layer-stack cache leaf:

  dense  k/v : (count, b, hkv, S, hd)                 S = max_len slots
  paged  k/v : (count, n_pages + 1, hkv, page, hd)    physical pages

A *page id* spans **all** layers: allocating page p grants the row
``page_size`` token slots in every layer's storage at physical index p.
Physical index ``n_pages`` is the trash page: unallocated table entries and
retired rows point there, so done rows keep scatter-decoding PAD harmlessly
(their writes land in trash, their reads are masked or discarded).  Every
table entry therefore lies in ``[0, n_pages]`` — the guarantee the paged
decode-attention kernel relies on instead of checking entries itself.

Deadlock freedom: ``admit_row`` *reserves* the row's worst-case page count
up front (``ceil(min(len + budget, kv_cap) / page)``) and draws the physical
pages down from that reservation as decode advances, so a row admitted is a
row that can always finish.  ``available()`` is what is left for *new*
admissions.

The paged attention implementation is chosen by the device the cache lies
on (the CUDA kernel on the card, its plain version on the CPU), so
``PagedSpec`` carries no kernel switch.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN_KINDS, ModelConfig
from repro_torch.models.attention import resolve_window
from repro_torch.models.common import dtype_of


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """KV bytes one cached token costs across every GQA attention layer
    (``moe`` layers included).  As in the reference, an encoder-decoder's
    cross caches (fixed per row, not per token) are left out, and so are
    MLA layers, whose latent (kv_lora_rank + qk_rope_head_dim values a
    token) the reference's count does not see: deepseek-v2 gives 0 on both
    sides."""
    itemsize = torch.empty((), dtype=dtype_of(cfg.dtype)).element_size()
    per_layer = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * itemsize
    return per_layer * sum(1 for k in cfg.layer_kinds() if k in ATTN_KINDS)


def check_paged_support(cfg: ModelConfig) -> None:
    """Paged KV covers decoder-only, full-window GQA attention stacks only
    (``moe`` layers included): encoder cross caches, MLA latents and
    SSM/conv states have no paged layout, and
    windowed ring buffers already cap their own memory.  Loud failure beats
    decoding from the wrong cache lines."""
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"paged KV requires a decoder-only model: {cfg.name!r} carries "
            "encoder cross caches")
    for kind in cfg.layer_kinds():
        if kind not in ATTN_KINDS:
            raise ValueError(
                "paged KV requires an attention-only GQA backbone: "
                f"{cfg.name!r} has a {kind!r} layer (SSM/MLA states have "
                "no paged layout)")
        if resolve_window(cfg, kind) > 0:
            raise ValueError(
                "paged KV does not support sliding-window layers: "
                f"{cfg.name!r} layer kind {kind!r} resolves a window — "
                "ring buffers already bound their memory at O(window)")


class PagedSpec(NamedTuple):
    """Static half of the paged layout; the page table is the other half."""
    page_size: int
    kv_cap: int                     # per-row logical capacity in tokens


class KVPool:
    """Free-list page allocator with reservation accounting.

    Host-side only.  ``reserved`` counts pages promised to admitted rows
    but not yet physically allocated; ``available()`` is what a *new*
    admission may claim.  Counters (``pages_in_use``/``pages_peak``/
    ``live_tokens``/``tokens_peak``) are updated at every alloc/free.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(
                f"need n_pages >= 1 and page_size >= 1, got "
                f"{n_pages}/{page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(self.n_pages))
        self.reserved = 0
        self.pages_peak = 0
        self.live_tokens = 0
        self.tokens_peak = 0

    # -- allocation -------------------------------------------------------
    @property
    def trash_page(self) -> int:
        return self.n_pages

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def available(self) -> int:
        """Pages a fresh admission may still reserve."""
        return len(self._free) - self.reserved

    def alloc(self, n: int, *, from_reserved: int = 0) -> List[int]:
        if from_reserved > self.reserved:
            raise RuntimeError(
                f"drawing {from_reserved} pages from a reservation of "
                f"{self.reserved}")
        if n > len(self._free) - (self.reserved - from_reserved):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"free of which {self.reserved - from_reserved} reserved")
        ids = [self._free.pop() for _ in range(n)]
        self.reserved -= from_reserved
        self.pages_peak = max(self.pages_peak, self.pages_in_use)
        return ids

    def free(self, ids: List[int]) -> None:
        for p in ids:
            if not (0 <= p < self.n_pages):
                raise RuntimeError(f"freeing invalid page id {p}")
            if p in self._free:
                raise RuntimeError(f"double free of page {p}")
        self._free.extend(ids)

    def reserve(self, n: int) -> None:
        if n > self.available():
            raise RuntimeError(
                f"cannot reserve {n} pages, only {self.available()} "
                "available")
        self.reserved += n

    def unreserve(self, n: int) -> None:
        if n > self.reserved:
            raise RuntimeError(
                f"releasing reservation of {n} > {self.reserved}")
        self.reserved -= n

    # -- token accounting -------------------------------------------------
    def add_live_tokens(self, n: int) -> None:
        self.live_tokens += int(n)
        self.tokens_peak = max(self.tokens_peak, self.live_tokens)

    def drop_live_tokens(self, n: int) -> None:
        self.live_tokens -= int(n)

    @property
    def fragmentation(self) -> float:
        """Fraction of in-use page slots not holding a live token."""
        cap = self.pages_in_use * self.page_size
        if cap == 0:
            return 0.0
        return max(0.0, cap - self.live_tokens) / cap

    def attach(self, batch: int, *, kv_cap: int,
               budget_steps: int) -> "PagedKV":
        return PagedKV(self, batch, kv_cap=kv_cap, budget_steps=budget_steps)


@dataclasses.dataclass
class PagedKV:
    """One decode batch's page tables over a shared ``KVPool``.

    ``table`` is the host mirror, shape (b, W) int32 with W =
    ceil(kv_cap / page_size); unallocated entries hold the trash page.
    ``row_high[i]`` upper-bounds row i's next write position, advanced per
    segment by ``ensure``.
    """
    pool: KVPool
    batch: int
    kv_cap: int
    budget_steps: int

    def __post_init__(self):
        self.page_size = self.pool.page_size
        self.table_width = _ceil_div(self.kv_cap, self.page_size)
        self.table = np.full((self.batch, self.table_width),
                             self.pool.trash_page, np.int32)
        self.row_pages: List[List[int]] = [[] for _ in range(self.batch)]
        self.row_reserved = [0] * self.batch
        self.row_high = np.zeros((self.batch,), np.int64)
        self.row_live = np.zeros((self.batch,), bool)
        # rows admitted ahead of their refill launch (reservation already
        # taken); ``decode_segment`` consumes the flag instead of
        # re-admitting
        self.row_preadmitted = np.zeros((self.batch,), bool)
        self.spec = PagedSpec(self.page_size, int(self.kv_cap))

    # -- admission --------------------------------------------------------
    def row_need(self, true_len: int) -> int:
        """Worst-case pages a row admitted at ``true_len`` can touch."""
        return _ceil_div(min(true_len + self.budget_steps, self.kv_cap),
                         self.page_size)

    def can_admit(self, true_len: int) -> bool:
        return self.pool.available() >= self.row_need(true_len)

    def admit_row(self, row: int, true_len: int) -> None:
        """Reserve the row's worst case and allocate its prompt pages."""
        if self.row_live[row]:
            raise RuntimeError(f"row {row} already admitted")
        if not (1 <= true_len <= self.kv_cap):
            raise ValueError(
                f"prompt of {true_len} tokens outside [1, {self.kv_cap}]")
        need = self.row_need(true_len)
        if need > self.pool.n_pages:
            raise ValueError(
                f"kv pool of {self.pool.n_pages} pages "
                f"(page_size={self.page_size}) is too small to admit a "
                f"single full-budget row: a {true_len}-token prompt with "
                f"{self.budget_steps} decode steps needs {need} pages — "
                "raise kv_pool_pages or kv_page_size")
        if not self.can_admit(true_len):
            raise RuntimeError(
                f"admission of a {true_len}-token row needs {need} pages, "
                f"pool has {self.pool.available()} — check can_admit first")
        n_prompt = _ceil_div(true_len, self.page_size)
        self.pool.reserve(need)
        ids = self.pool.alloc(n_prompt, from_reserved=n_prompt)
        self.table[row, :n_prompt] = ids
        self.row_pages[row] = list(ids)
        self.row_reserved[row] = need - n_prompt
        self.row_high[row] = true_len
        self.row_live[row] = True
        self.pool.add_live_tokens(true_len)

    def retire_row(self, row: int) -> None:
        """Release a row's pages and reservation; its table entries fall
        back to the trash page so any still-running PAD decode of that slot
        scatters harmlessly."""
        if not self.row_live[row]:
            return
        self.pool.free(self.row_pages[row])
        self.pool.unreserve(self.row_reserved[row])
        self.pool.drop_live_tokens(int(self.row_high[row]))
        self.table[row, :] = self.pool.trash_page
        self.row_pages[row] = []
        self.row_reserved[row] = 0
        self.row_high[row] = 0
        self.row_live[row] = False
        self.row_preadmitted[row] = False

    def pre_admit(self, row: int, true_len: int) -> None:
        """Retire + admit a row ahead of its refill launch, so that
        ``can_admit()`` stays truthful for the admissions that follow at
        the same boundary.  ``decode_segment`` consumes
        ``row_preadmitted`` instead of re-admitting."""
        self.retire_row(row)
        self.admit_row(row, true_len)
        self.row_preadmitted[row] = True

    # -- per-segment growth ----------------------------------------------
    def check_steps(self, steps: int) -> None:
        """Per-row capacity guard: every live row must fit ``steps`` more
        writes under ``kv_cap``."""
        if self.row_live.any():
            high = int(self.row_high[self.row_live].max())
            if high + steps > self.kv_cap:
                raise ValueError(
                    f"segment of {steps} steps overruns a paged row: "
                    f"{high} of {self.kv_cap} token capacity used")

    def starved_rows(self, steps: int) -> List[int]:
        """Live rows whose share of the next ``ensure(steps)`` would raise
        on true pool exhaustion — a dry run of ``ensure``'s allocation
        order with no side effects.  Within its reserved budget a row can
        never starve, so this only names rows decoding past their budget
        under a drained pool."""
        free = len(self.pool._free)
        reserved = self.pool.reserved
        out = []
        for row in range(self.batch):
            if not self.row_live[row]:
                continue
            target = min(int(self.row_high[row]) + steps, self.kv_cap)
            need = _ceil_div(target, self.page_size) - len(self.row_pages[row])
            if need <= 0:
                continue
            from_res = min(need, self.row_reserved[row])
            if need > free - (reserved - from_res):
                out.append(row)
                continue
            free -= need
            reserved -= from_res
        return out

    def ensure(self, steps: int) -> None:
        """Allocate the pages ``steps`` more decode writes need and advance
        ``row_high``.  Pages come from the row's reservation first, so
        within budget this can never fail; past it, rows draw best-effort
        from the unreserved free pool and raise only on exhaustion."""
        for row in range(self.batch):
            if not self.row_live[row]:
                continue
            target = min(int(self.row_high[row]) + steps, self.kv_cap)
            need = _ceil_div(target, self.page_size) - len(self.row_pages[row])
            if need > 0:
                from_res = min(need, self.row_reserved[row])
                ids = self.pool.alloc(need, from_reserved=from_res)
                start = len(self.row_pages[row])
                self.table[row, start:start + need] = ids
                self.row_pages[row].extend(ids)
                self.row_reserved[row] -= from_res
            self.pool.add_live_tokens(target - int(self.row_high[row]))
            self.row_high[row] = target

    # -- device views -----------------------------------------------------
    def device_table(self, device, rows: slice = slice(None)
                     ) -> torch.Tensor:
        """The host mirror's ``rows`` as an int32 tensor on ``device``: one
        upload, made once per decode segment at its launch."""
        return torch.tensor(self.table[rows], device=device)

    def prompt_page_ids(self, mask: np.ndarray, n_pages_row: int
                        ) -> np.ndarray:
        """(b, n_pages_row) scatter destinations for refill prompt page
        blocks: admitted rows' freshly allocated prompt pages where the
        mask is set, the trash page elsewhere (so non-refilled rows' live
        pages are never touched by the scatter)."""
        ids = np.where(np.asarray(mask, bool)[:, None],
                       self.table[:, :n_pages_row],
                       np.int32(self.pool.trash_page))
        return ids.astype(np.int32)


# The reference's paged-attention implementation names.  The port accepts
# both so that configurations carry over, and runs the same code for either:
# the CUDA kernel for a cache on the card, its plain version on the CPU.
KV_KERNELS = ("xla", "pallas")


def check_kv_kernel(name: str) -> str:
    """Lower-cased ``name`` if it is one of ``KV_KERNELS``, else raise."""
    key = str(name).lower()
    if key not in KV_KERNELS:
        raise ValueError(f"unknown kv_kernel {name!r} "
                         "(expected 'xla' or 'pallas')")
    return key
