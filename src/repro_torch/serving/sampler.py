"""KV-cache generation: batch prefill + decode segments with slot refill.

The port of ``repro/serving/sampler.py``.  Decode is organised around an
explicit ``DecodeState`` (caches, per-row positions, done-mask, sampling
generator) so the serve runtime can run decode in **segments** and refill a
drained-at-EOS slot with a freshly prefilled prompt between segments
(continuous batching) instead of idling the slot until the batch finishes:

  state = prefill_state(params, cfg, prompts, max_new_tokens=12)
  state, gen, dec = decode_segment(params, cfg, state, 4)
  state = refill_slot(params, cfg, state, row=2, prompt=new_prompt)
  state, gen2, dec2 = decode_segment(params, cfg, state, 4)

``decode_segment(refill=(mask, prompts, lens))`` fuses the refill into the
segment's call, as the reference fuses it into one executable: every slot
drained at one boundary refills with one prefill of the slot-aligned (b, W)
prompt matrix (rows outside the mask are prefilled too and discarded, as in
the reference).  ``prefill_state(kv_pool=...)`` backs the state with the
block-paged layout of ``serving.kv_pool`` instead of a dense
O(b x max_len) cache.

Where JAX scans a jitted body, the port loops over steps in Python; the
caches — dense or paged — are updated IN PLACE (JAX builds new arrays), so a
``DecodeState`` handed to ``decode_segment`` or ``refill_slots`` must not be
reused afterwards.  Sampling, the done-mask and the (YES, NO) logit gather
stay on the device, and only the token ids (b, T), the decision logit pairs
(b, T, 2) and, for the slot runtime, the done-mask (b,) reach the host,
packed into one transfer (``to_host``).

Under a serve mesh each rank's device state holds only its own rows of the
batch (``rows``, a slice of the batch): the host arguments — prompts, true
lengths, refill masks — and the page bookkeeping stay whole and equal on
every rank, and each rank prefills, merges and decodes its own rows.  The
caller (``core.estimator``, GRPO's rollouts) picks the rows (``mesh_rows``)
and gathers their tokens and logits (``gather_rows``).

Positions are per row: right-padded prompts with true lengths
``prompt_lens`` decode from their own length, the new K/V overwriting the
pad slots and attention masked at each row's own valid length, so a padded
row reproduces an unpadded run (attention backbones).  SSM/conv prefill
state consumes right-pad tokens, so an SSM backbone takes exact-fit
lengths only: ragged ``prompt_lens`` and padded refills raise, as in the
reference.  Rows past EOS keep decoding PAD (and writing K/V), exactly as
in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import EOS, NO, PAD, YES
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.models import model as M
from repro_torch.serving.kv_pool import (KVPool, PagedKV, _ceil_div,
                                         check_kv_kernel, check_paged_support)

# decision-logit channel order: [:, :, 0] = YES, [:, :, 1] = NO
DECISION_TOKENS = (YES, NO)

# Seq axis of each decode-cache leaf, behind the layer-stack dim:
#   k / v  : (L, b, kv_heads, S, head_dim)  -> axis 3
#   c_kv   : (L, b, S, kv_lora_rank)        -> axis 2
#   k_rope : (L, b, S, qk_rope_head_dim)    -> axis 2
# Everything else (the mamba conv window and SSM state, the encoder cross
# caches) has no decode-time sequence axis and is never grown, whatever its
# shape.
CACHE_SEQ_AXIS = {"k": 3, "v": 3, "c_kv": 2, "k_rope": 2}


def params_device(params) -> torch.device:
    """The device of this rank's params (sharded ones' local blocks)."""
    return coll.local(params["embed"]).device


def _gather_last(logits: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Per-row last *valid* prompt logits: logits[i, lens[i] - 1], f32."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, lens.long() - 1].float()


def _leaves(caches):
    """(name, leaf) of every cache leaf, in a fixed order."""
    for seg in caches:
        for unit in seg.values():
            yield from unit.items()


def _pad_caches(caches, max_len: int, prompt_len: int):
    """Grow prefill caches (seq = prompt_len) to decode capacity, by the
    explicit seq-axis contract of ``CACHE_SEQ_AXIS`` (never by shape);
    leaves without a seq axis pass through unchanged."""
    def grow(name, leaf):
        ax = CACHE_SEQ_AXIS.get(name)
        if ax is None:
            return leaf
        if leaf.shape[ax] != prompt_len:
            raise ValueError(
                f"cache leaf {name!r} has seq axis {leaf.shape[ax]} != "
                f"prompt_len {prompt_len} (shape {tuple(leaf.shape)})")
        shape = list(leaf.shape)
        shape[ax] = max_len
        out = leaf.new_zeros(shape)
        out.narrow(ax, 0, prompt_len).copy_(leaf)
        return out

    return tuple({j: {name: grow(name, leaf) for name, leaf in unit.items()}
                  for j, unit in seg.items()} for seg in caches)


def _merge_rows(caches, new_caches, rows: torch.Tensor,
                src: torch.Tensor) -> None:
    """Replace dense cache rows ``rows`` by rows ``src`` of the prefill
    caches ``new_caches`` — (count, p, hkv, W, hd) K/V and (count, p, W,
    ·) MLA latents, zero past W; a mamba layer's conv window and SSM state
    whole — the reference's row replacement by a grown prefill cache, in
    place."""
    for (name, old), (_, new) in zip(_leaves(caches), _leaves(new_caches),
                                     strict=True):
        ax = CACHE_SEQ_AXIS.get(name)
        if ax is None:
            old[:, rows] = new[:, src].to(old.dtype)
            continue
        width = new.shape[ax]
        lead = (slice(None), rows) + (slice(None),) * (ax - 2)
        old[lead + (slice(None, width),)] = new[:, src].to(old.dtype)
        # a zero made on the device: a Python 0 here is a host value, which
        # an indexed store into a card tensor copies over, waiting for the
        # stream mid-segment
        old[lead + (slice(width, None),)] = old.new_zeros(())


def _paged_leaf_scatter(leaf: torch.Tensor, storage: torch.Tensor,
                        page_ids: torch.Tensor, page_size: int) -> None:
    """Scatter a dense prefill leaf (count, b, hkv, L, hd) into paged
    storage (count, n_pages + 1, hkv, page_size, hd), in place, at the
    flattened (b * ceil(L / page_size),) physical destinations
    ``page_ids``.  Pad and filler blocks all target the trash page, so the
    scatter is a plain index assignment that tolerates duplicate indices:
    which of the colliding writes wins is unobservable."""
    count, b, hkv, L, hd = leaf.shape
    npg = page_ids.shape[0] // b
    pad = npg * page_size - L
    if pad:
        leaf = F.pad(leaf, (0, 0, 0, pad))
    blocks = leaf.reshape(count, b, hkv, npg, page_size, hd)
    blocks = blocks.permute(0, 1, 3, 2, 4, 5).reshape(
        count, b * npg, hkv, page_size, hd)
    storage[:, page_ids] = blocks.to(storage.dtype)


def _scatter_prefill_caches(new_caches, storage, page_ids: torch.Tensor,
                            page_size: int):
    """Scatter every k/v leaf of ``new_caches`` into the matching leaf of
    the paged ``storage`` (``check_paged_support`` guarantees every
    decode-cache leaf is a GQA k/v pair).  Returns ``storage``."""
    for (name, leaf), (_, store) in zip(_leaves(new_caches),
                                        _leaves(storage), strict=True):
        if name not in ("k", "v"):
            raise AssertionError(
                f"paged scatter hit non-GQA cache leaf {name!r}")
        _paged_leaf_scatter(leaf, store, page_ids, page_size)
    return storage


def _fresh_paged_storage(new_caches, n_pages_total: int, page_size: int):
    """Zeroed paged storage shaped after the prefill caches' leaves."""
    def zeros(leaf):
        count, _, hkv, _, hd = leaf.shape
        return leaf.new_zeros((count, n_pages_total, hkv, page_size, hd))

    return tuple({j: {name: zeros(leaf) for name, leaf in unit.items()}
                  for j, unit in seg.items()} for seg in new_caches)


def _check_refill_lens(cfg: ModelConfig, state: "DecodeState", width: int,
                       lens: np.ndarray) -> None:
    """Shared refill-prompt guards (fused and unfused paths accept exactly
    the same inputs): true lengths in [1, width], attention-only backbones
    when padded, and decode room left in the slot cache."""
    if lens.min() < 1 or lens.max() > width:
        raise ValueError(
            f"prompt_lens must lie in [1, {width}], got "
            f"[{lens.min()}, {lens.max()}]")
    if lens.min() < width and cfg.has_ssm():
        raise ValueError(
            "padded refill requires an attention-only backbone: "
            f"{cfg.name!r} has SSM/conv layers whose prefill state consumes "
            "right-pad tokens — refill at the exact prompt length instead")
    if lens.max() >= state.max_len or width > state.max_len:
        raise ValueError(
            f"refill prompt of {lens.max()} tokens (padded to {width}) "
            f"leaves no decode room in a {state.max_len}-slot cache")


@dataclasses.dataclass
class DecodeState:
    """Decode carry between segments (slot-based continuous batching).

    ``positions[i]`` counts the tokens already in row i's cache; ``done``
    marks rows that emitted EOS (they keep decoding PAD until refilled or
    the batch retires).  ``used`` is a host-side upper bound on cache
    occupancy, checked against ``max_len`` before a segment runs off the
    end of the allocation.  ``generator`` draws the samples at temperature
    > 0 (None = greedy only).

    ``paged`` (a ``kv_pool.PagedKV``) switches the caches to the
    block-paged layout: ``max_len`` then equals the paged ``kv_cap`` and
    the batch-wide ``used`` guard is replaced by the attachment's per-row
    ``row_high`` bound.

    ``rows`` (with ``size`` the whole batch) marks a state whose tensors
    hold only those rows of the batch: one rank's share under a serve
    mesh.  Host-side fields (``used``, ``paged``) cover the whole batch.
    """
    caches: tuple
    last_logits: torch.Tensor       # (b, V) float32
    positions: torch.Tensor         # (b,) int32
    done: torch.Tensor              # (b,) bool
    generator: Optional[torch.Generator]
    max_len: int
    used: int
    paged: Optional[PagedKV] = None
    rows: Optional[slice] = None
    size: Optional[int] = None

    @property
    def batch(self) -> int:
        return self.size if self.rows is not None else int(
            self.last_logits.shape[0])

    @property
    def part(self) -> slice:
        """This state's rows of the batch (all of them unless split)."""
        return slice(None) if self.rows is None else self.rows


def prefill_state(params, cfg: ModelConfig, prompts, *, max_new_tokens: int,
                  prompt_lens=None,
                  generator: Optional[torch.Generator] = None,
                  kv_pool: Optional[KVPool] = None, kv_kernel: str = "xla",
                  kv_active=None, rows: Optional[slice] = None
                  ) -> DecodeState:
    """Batch prefill into a ``DecodeState`` sized for ``max_new_tokens``.

    ``prompts``: (b, L) int, right-padded.  ``prompt_lens`` (b,) gives each
    row's true length (None = every row exactly L).

    ``kv_pool`` backs the state with the block-paged KV layout: each
    admitted row reserves its own worst case (``len + max_new_tokens``
    tokens, page-rounded) and pages materialize as positions advance.
    ``kv_active`` (b,) bool marks the rows to admit (None = all); inactive
    rows own no pages — their tables point at the trash page.
    ``kv_kernel`` is checked against the reference's names ("xla",
    "pallas"); the implementation is the device's (see ``kv_pool``).
    ``rows`` prefills only those rows of the batch (see ``DecodeState``);
    the arguments stay whole.
    """
    dev = params_device(params)
    prompts = np.asarray(prompts, np.int32)
    b, lp = prompts.shape
    part = slice(None) if rows is None else rows
    max_len = lp + int(max_new_tokens)
    lens = None
    if prompt_lens is not None:
        lens = np.asarray(prompt_lens, np.int64).reshape(-1)
        if lens.shape != (b,):
            raise ValueError(f"prompt_lens shape {lens.shape} != ({b},)")
        if lens.min() < 1 or lens.max() > lp:
            raise ValueError(
                f"prompt_lens must lie in [1, {lp}], got "
                f"[{lens.min()}, {lens.max()}]")
        if lens.min() < lp and cfg.has_ssm():
            # SSM/conv prefill has no per-row masking: the recurrent state
            # consumes right-pad tokens, silently corrupting sub-bucket rows
            raise ValueError(
                "ragged prompt_lens require an attention-only backbone: "
                f"{cfg.name!r} has SSM/conv layers whose prefill state "
                "consumes right-pad tokens — use exact-fit lengths "
                "(BucketConfig(prompt_lens=()))")
    paged = None
    if kv_pool is not None:
        check_paged_support(cfg)
        check_kv_kernel(kv_kernel)
        if kv_pool.page_size > max_len:
            raise ValueError(
                f"kv_page_size {kv_pool.page_size} exceeds the row "
                f"capacity {max_len} — a page would never fill")
        paged = kv_pool.attach(b, kv_cap=max_len,
                               budget_steps=int(max_new_tokens))
        active = (np.ones((b,), bool) if kv_active is None
                  else np.asarray(kv_active, bool).reshape(-1))
        if active.shape != (b,):
            raise ValueError(f"kv_active shape {active.shape} != ({b},)")
        row_lens = np.full((b,), lp, np.int64) if lens is None else lens
        for i in np.flatnonzero(active):
            paged.admit_row(int(i), int(row_lens[i]))
        npg = _ceil_div(lp, paged.page_size)
        ids = torch.as_tensor(
            paged.prompt_page_ids(active, npg)[part].reshape(-1),
            dtype=torch.long, device=dev)
    # host->device copies before the first launch (see decode_segment)
    tokens = torch.as_tensor(prompts[part], device=dev)
    positions = (torch.full((tokens.shape[0],), lp, dtype=torch.int32,
                            device=dev)
                 if lens is None else
                 torch.as_tensor(lens[part], dtype=torch.int32, device=dev))
    logits, caches = M.prefill(params, cfg, {"tokens": tokens})
    if paged is not None:
        caches = _scatter_prefill_caches(
            caches, _fresh_paged_storage(caches, kv_pool.n_pages + 1,
                                         paged.page_size),
            ids, paged.page_size)
    else:
        caches = _pad_caches(caches, max_len, lp)
    last = (logits[:, -1].float() if lens is None
            else _gather_last(logits, positions))
    return DecodeState(caches, last, positions,
                       done=torch.zeros((tokens.shape[0],), dtype=torch.bool,
                                        device=dev),
                       generator=generator, max_len=max_len, used=lp,
                       paged=paged, rows=rows, size=b)


def decode_segment(params, cfg: ModelConfig, state: DecodeState, steps: int,
                   *, temperature: float = 0.0, stop_at_eos: bool = True,
                   refill: Optional[Tuple] = None
                   ) -> Tuple[DecodeState, torch.Tensor, torch.Tensor]:
    """Run ``steps`` decode steps: sample -> emit (token, YES/NO logits) ->
    step.  Returns (state, gen (b, T) int32, dec (b, T, 2) float32), both on
    the device; the caches in ``state`` are advanced in place.  Chaining
    segments equals one segment of the summed length.

    ``refill`` = (mask (b,), prompts (b, W), prompt_lens (b,)) admits new
    requests into the masked slots in the same call: the slot-aligned
    prompts are prefilled (right-padded to width W, true lengths in
    ``prompt_lens``), their caches written into the masked rows (dense) or
    into the rows' fresh pages (paged; unmasked rows scatter to the trash
    page), and the masked rows reset to decode from their own prompt before
    the segment runs — equal to ``refill_slots`` followed by a plain
    segment.  On a state of some ``rows`` of the batch, ``refill`` stays
    whole and the rank refills its own masked rows.
    """
    steps = int(steps)
    pg = state.paged
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")
    if pg is not None:
        # per-row bound; with a refill it runs again after the drained
        # rows are retired and re-admitted below
        if refill is None:
            pg.check_steps(steps)
    elif state.used + steps > state.max_len:
        raise ValueError(
            f"segment of {steps} steps overruns the cache: "
            f"{state.used} used of {state.max_len} slots")
    if temperature > 0.0 and state.generator is None:
        raise ValueError(
            "stochastic decoding (temperature > 0) requires an explicit "
            "torch.Generator — greedy decoding needs none")
    dev = state.last_logits.device
    logits, caches = state.last_logits, state.caches
    positions, done, used = state.positions, state.done, state.used
    part = state.part
    if refill is not None:
        mask, prompts, lens = refill
        mask = np.asarray(mask, bool).reshape(-1)
        prompts = np.asarray(prompts, np.int32)
        b = state.batch
        if mask.shape != (b,) or prompts.ndim != 2 or prompts.shape[0] != b:
            raise ValueError(
                f"refill mask/prompts must be ({b},)/({b}, W), got "
                f"{mask.shape}/{prompts.shape}")
        width = prompts.shape[1]
        lens = (np.full((b,), width, np.int64) if lens is None
                else np.asarray(lens, np.int64).reshape(-1))
        if lens.shape != (b,):
            raise ValueError(f"prompt_lens shape {lens.shape} != ({b},)")
        if not mask.any():
            raise ValueError("refill mask selects no rows — pass "
                             "refill=None for a plain segment")
        _check_refill_lens(cfg, state, width, lens[mask])
        mlens = lens[mask]
        lens = np.where(mask, lens, 1)      # unmasked rows: any valid index
        if pg is not None:
            # host-side admission before the launch: release whatever the
            # refilled slots still hold (no-op if the serve loop retired
            # them at sync), then allocate their prompt pages
            for i in np.flatnonzero(mask):
                if pg.row_preadmitted[i]:
                    pg.row_preadmitted[i] = False   # reserved at admit time
                else:
                    pg.retire_row(int(i))
                    pg.admit_row(int(i), int(lens[i]))
            pg.check_steps(steps)
            ids = pg.prompt_page_ids(mask, _ceil_div(width, pg.page_size))
        used = max(used, int(mlens.max()))
        # this rank's rows; a rank none of whose rows refill skips the
        # prefill, unless its params are sharded: the prefill's gathers are
        # collectives every rank joins
        mask, prompts, lens = mask[part], prompts[part], lens[part]
        if pg is not None:
            ids = ids[part]
        if not mask.any() and coll.mesh_of(params) is None:
            refill = None
    paged = None
    if pg is not None:
        pg.ensure(steps)
        paged = (pg.spec, pg.device_table(dev, part))   # one upload a segment
    # every host->device copy of the segment is issued before its first
    # launch: a copy from pageable host memory waits for the stream
    dec_ix = torch.as_tensor(DECISION_TOKENS, device=dev)
    if refill is not None:
        tokens = torch.as_tensor(prompts, device=dev)
        mask_t = torch.as_tensor(mask, device=dev)
        lens_t = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        dest = torch.as_tensor(ids.reshape(-1) if pg is not None
                               else np.flatnonzero(mask), dtype=torch.long,
                               device=dev)
        new_logits, new_caches = M.prefill(params, cfg, {"tokens": tokens})
        if pg is not None:
            _scatter_prefill_caches(new_caches, caches, dest, pg.page_size)
        else:
            _merge_rows(caches, new_caches, dest, dest)
        logits = torch.where(mask_t[:, None], _gather_last(new_logits, lens_t),
                             logits)
        positions = torch.where(mask_t, lens_t, positions)
        done = done & ~mask_t
    gens, decs = [], []
    for t in range(steps):
        if temperature > 0.0:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=state.generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(done, PAD, nxt).to(torch.int32)
        decs.append(logits[:, dec_ix])
        gens.append(nxt)
        if stop_at_eos:
            done = done | (nxt == EOS)
        new_logits, caches = M.decode_step(params, cfg, nxt[:, None], caches,
                                           positions + t, paged=paged)
        logits = new_logits[:, 0].float()
    new = DecodeState(caches, logits, positions + steps, done,
                      state.generator, state.max_len, used + steps, paged=pg,
                      rows=state.rows, size=state.size)
    return new, torch.stack(gens, dim=1), torch.stack(decs, dim=1)


def refill_slots(params, cfg: ModelConfig, state: DecodeState,
                 rows: Sequence[int], prompts, *,
                 prompt_lens: Optional[Sequence[int]] = None) -> DecodeState:
    """Admit new prompts into slots ``rows`` between decode segments.

    ``prompts`` is a (p, W) int token matrix with p >= r = len(rows): the
    first r rows are the refilled prompts (right-padded to a common width
    W), trailing rows are all-PAD filler.  ``prompt_lens`` gives each
    refilled prompt's true length (None = exactly W).  Each prompt's caches
    are written into the batch state at its row — in place, into the dense
    rows or the rows' fresh pages (filler rows scatter to trash) — and the
    row's position/done/logits reset; the other rows are untouched.
    """
    if state.rows is not None:
        raise ValueError("refill_slots takes a state of the whole batch; a "
                         "rank's rows refill through "
                         "decode_segment(refill=...)")
    arr = np.asarray(prompts, np.int32)
    if arr.ndim != 2:
        raise ValueError(f"prompts must be (p, W), got {arr.shape}")
    p, width = arr.shape
    rows = np.asarray(rows, np.int64).reshape(-1)
    r = rows.shape[0]
    if r > p:
        raise ValueError(f"{r} rows for only {p} prompts")
    if r == 0:
        return state
    if len({int(x) for x in rows}) != r:
        raise ValueError(f"duplicate refill rows: {rows.tolist()}")
    if rows.min() < 0 or rows.max() >= state.batch:
        raise ValueError(
            f"rows {rows.tolist()} out of range [0, {state.batch})")
    lens = (np.full((r,), width, np.int64) if prompt_lens is None
            else np.asarray(prompt_lens, np.int64).reshape(-1))
    if lens.shape != (r,):
        raise ValueError(f"prompt_lens shape {lens.shape} != ({r},)")
    _check_refill_lens(cfg, state, width, lens)
    dev = state.last_logits.device
    ridx = torch.as_tensor(rows, device=dev)
    if state.paged is not None:
        pg = state.paged
        for j, row in enumerate(rows):
            if pg.row_preadmitted[row]:
                pg.row_preadmitted[row] = False   # reserved at admit time
            else:
                pg.retire_row(int(row))
                pg.admit_row(int(row), int(lens[j]))
        npg = _ceil_div(width, pg.page_size)
        # prompt-row j's page blocks land in slot rows[j]'s fresh pages;
        # filler prompt rows (j >= r) scatter to trash
        ids = np.full((p, npg), pg.pool.trash_page, np.int32)
        for j, row in enumerate(rows):
            ids[j] = pg.table[row, :npg]
    plens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    tokens = torch.as_tensor(arr, device=dev)
    if state.paged is not None:
        dest = torch.as_tensor(ids.reshape(-1), dtype=torch.long, device=dev)
    logits, new_caches = M.prefill(params, cfg, {"tokens": tokens})
    if state.paged is not None:
        _scatter_prefill_caches(new_caches, state.caches, dest,
                                state.paged.page_size)
    else:
        _merge_rows(state.caches, new_caches, ridx,
                    torch.arange(r, device=dev))
    # gather over the first r (real) prefilled rows only
    last = _gather_last(logits[:r], plens)              # (r, V) f32
    return dataclasses.replace(
        state,
        last_logits=state.last_logits.index_put((ridx,), last),
        positions=state.positions.index_put((ridx,), plens),
        done=state.done.index_put((ridx,), torch.zeros_like(ridx,
                                                          dtype=torch.bool)),
        used=max(state.used, int(lens.max())))


def refill_slot(params, cfg: ModelConfig, state: DecodeState, row: int,
                prompt: Sequence[int], *,
                prompt_len: Optional[int] = None) -> DecodeState:
    """Single-slot ``refill_slots``: admit one prompt into slot ``row``."""
    arr = np.asarray(prompt, np.int32).reshape(1, -1)
    return refill_slots(params, cfg, state, [row], arr,
                        prompt_lens=None if prompt_len is None
                        else [int(prompt_len)])


def to_host(gen: torch.Tensor, dec: torch.Tensor,
            done: Optional[torch.Tensor] = None):
    """(gen (b, T) int32, dec (b, T, 2) f32[, done (b,) bool]) -> numpy, in
    ONE device->host copy: the int32 ids ride as float32 bit patterns beside
    the logits, and the done-mask as 0/1 floats after them.  Returns
    (gen, dec) or, with ``done``, (gen, dec, done)."""
    b, T = gen.shape
    packed = torch.cat([gen.view(torch.float32)[..., None], dec],
                       dim=-1).reshape(b, 3 * T)
    if done is not None:
        packed = torch.cat([packed, done.float()[:, None]], dim=1)
    # scopelint-torch: allow[host-sync-in-hot-path] -- the segment's one device->host copy, after its last launch
    host = packed.cpu().numpy()
    body = host[:, : 3 * T].reshape(b, T, 3)
    out = (np.ascontiguousarray(body[..., 0]).view(np.int32),
           np.ascontiguousarray(body[..., 1:]))
    if done is None:
        return out
    return out + (host[:, 3 * T] != 0,)


def mesh_rows(mesh, cfg: ModelConfig, b: int) -> Optional[slice]:
    """The rows of a b-row generation this rank computes on ``mesh``: None
    without a mesh, all of them where b does not divide over ``data`` or
    the backbone routes tokens over the batch (MoE: a decode step's
    routing group is the whole batch)."""
    if mesh is None:
        return None
    if cfg.has_moe():
        return slice(0, b)
    return shd.local_rows(mesh, b)


def gather_rows(mesh, rows: Optional[slice], b: int, gen: torch.Tensor,
                dec: torch.Tensor, done: Optional[torch.Tensor] = None):
    """(gen (b, T), dec (b, T, 2)[, done (b,)]) on every rank from each
    rank's ``rows`` of them: one all-gather of the three packed as float32
    (the token ids as their bit patterns)."""
    if rows is None or (rows.start, rows.stop) == (0, b):
        return (gen, dec) if done is None else (gen, dec, done)
    n, T = gen.shape
    cols = [gen.view(torch.float32), dec.reshape(n, 2 * T)]
    if done is not None:
        cols.append(done.float()[:, None])
    full = shd.gather_rows(mesh, b, torch.cat(cols, dim=1))
    out = (full[:, :T].contiguous().view(torch.int32),
           full[:, T: 3 * T].reshape(b, T, 2))
    return out if done is None else out + (full[:, 3 * T] != 0,)


def generate_async(params, cfg: ModelConfig, prompts, *,
                   max_new_tokens: int = 12, temperature: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   stop_at_eos: bool = True, prompt_lens=None,
                   rows: Optional[slice] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``generate`` without the host copy: device (gen, dec) tensors (of
    ``rows`` of the batch only, when given)."""
    if temperature > 0.0 and generator is None:
        raise ValueError(
            "generate(temperature > 0) requires an explicit torch.Generator "
            "(greedy decoding stays deterministic without one)")
    state = prefill_state(params, cfg, prompts,
                          max_new_tokens=max_new_tokens,
                          prompt_lens=prompt_lens, generator=generator,
                          rows=rows)
    _, gen, dec = decode_segment(params, cfg, state, max_new_tokens,
                                 temperature=temperature,
                                 stop_at_eos=stop_at_eos)
    return gen, dec


def generate(params, cfg: ModelConfig, prompts, *, max_new_tokens: int = 12,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             stop_at_eos: bool = True, prompt_lens=None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """prompts: (b, Lp) int, right-padded; ``prompt_lens`` (b,) marks each
    row's true length (None = all exactly Lp).  Returns (generated (b, T)
    int32, decision_logits (b, T, 2) float32) where the last axis is the
    (YES, NO) logit pair at each step."""
    gen, dec = generate_async(params, cfg, prompts,
                              max_new_tokens=max_new_tokens,
                              temperature=temperature, generator=generator,
                              stop_at_eos=stop_at_eos,
                              prompt_lens=prompt_lens)
    return to_host(gen, dec)
