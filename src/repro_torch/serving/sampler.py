"""KV-cache generation: batch prefill + a greedy (or sampled) decode loop.

The main subset of ``repro/serving/sampler.py``: ``prefill_state`` fills a
``DecodeState`` (caches grown to decode capacity, per-row positions, EOS
done-mask), ``decode_segment`` runs ``steps`` decode steps, and
``generate`` / ``generate_async`` do both for one batch.  Where JAX scans a
jitted body, the port loops over steps in Python; sampling, the done-mask
and the (YES, NO) logit gather stay on the device, and only the token ids
(b, T) and the decision logit pairs (b, T, 2) reach the host, packed into
one transfer (``to_host``).

Positions are per row: right-padded prompts with true lengths
``prompt_lens`` decode from their own length, the new K/V overwriting the
pad slots and attention masked at each row's own valid length, so a padded
row reproduces an unpadded run.  Rows past EOS keep decoding PAD (and
writing K/V), exactly as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import EOS, NO, PAD, YES
from repro_torch.models import model as M

# decision-logit channel order: [:, :, 0] = YES, [:, :, 1] = NO
DECISION_TOKENS = (YES, NO)

# Seq axis of each decode-cache leaf, behind the layer-stack dim:
#   k / v : (L, b, kv_heads, S, head_dim) -> axis 3
CACHE_SEQ_AXIS = {"k": 3, "v": 3}


def _params_device(params) -> torch.device:
    return params["embed"].device


def _gather_last(logits: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Per-row last *valid* prompt logits: logits[i, lens[i] - 1], f32."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, lens.long() - 1].float()


def _pad_caches(caches, max_len: int, prompt_len: int):
    """Grow prefill caches (seq = prompt_len) to decode capacity, by the
    explicit seq-axis contract of ``CACHE_SEQ_AXIS`` (never by shape)."""
    def grow(name, leaf):
        ax = CACHE_SEQ_AXIS[name]
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


@dataclasses.dataclass
class DecodeState:
    """Decode carry between segments.

    ``positions[i]`` counts the tokens already in row i's cache; ``done``
    marks rows that emitted EOS (they keep decoding PAD).  ``used`` is a
    host-side upper bound on cache occupancy, checked against ``max_len``
    before a segment runs off the end of the allocation.  ``generator``
    draws the samples at temperature > 0 (None = greedy only).
    """
    caches: tuple
    last_logits: torch.Tensor       # (b, V) float32
    positions: torch.Tensor         # (b,) int32
    done: torch.Tensor              # (b,) bool
    generator: Optional[torch.Generator]
    max_len: int
    used: int


def prefill_state(params, cfg: ModelConfig, prompts, *, max_new_tokens: int,
                  prompt_lens=None,
                  generator: Optional[torch.Generator] = None) -> DecodeState:
    """Batch prefill into a ``DecodeState`` sized for ``max_new_tokens``.

    ``prompts``: (b, L) int, right-padded.  ``prompt_lens`` (b,) gives each
    row's true length (None = every row exactly L)."""
    dev = _params_device(params)
    prompts = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
    b, lp = prompts.shape
    max_len = lp + int(max_new_tokens)
    if prompt_lens is not None:
        lens = np.asarray(prompt_lens, np.int64).reshape(-1)
        if lens.shape != (b,):
            raise ValueError(f"prompt_lens shape {lens.shape} != ({b},)")
        if lens.min() < 1 or lens.max() > lp:
            raise ValueError(
                f"prompt_lens must lie in [1, {lp}], got "
                f"[{lens.min()}, {lens.max()}]")
    logits, caches = M.prefill(params, cfg, {"tokens": prompts})
    caches = _pad_caches(caches, max_len, lp)
    if prompt_lens is None:
        last = logits[:, -1].float()
        positions = torch.full((b,), lp, dtype=torch.int32, device=dev)
    else:
        positions = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        last = _gather_last(logits, positions)
    return DecodeState(caches, last, positions,
                       done=torch.zeros((b,), dtype=torch.bool, device=dev),
                       generator=generator, max_len=max_len, used=lp)


def decode_segment(params, cfg: ModelConfig, state: DecodeState, steps: int,
                   *, temperature: float = 0.0, stop_at_eos: bool = True
                   ) -> Tuple[DecodeState, torch.Tensor, torch.Tensor]:
    """Run ``steps`` decode steps: sample -> emit (token, YES/NO logits) ->
    step.  Returns (state, gen (b, T) int32, dec (b, T, 2) float32), both on
    the device; the caches in ``state`` are advanced in place."""
    steps = int(steps)
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")
    if state.used + steps > state.max_len:
        raise ValueError(
            f"segment of {steps} steps overruns the cache: "
            f"{state.used} used of {state.max_len} slots")
    if temperature > 0.0 and state.generator is None:
        raise ValueError(
            "stochastic decoding (temperature > 0) requires an explicit "
            "torch.Generator — greedy decoding needs none")
    dec_ix = torch.as_tensor(DECISION_TOKENS, device=state.last_logits.device)
    logits, caches, done = state.last_logits, state.caches, state.done
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
                                           state.positions + t)
        logits = new_logits[:, 0].float()
    new = DecodeState(caches, logits, state.positions + steps, done,
                      state.generator, state.max_len, state.used + steps)
    return new, torch.stack(gens, dim=1), torch.stack(decs, dim=1)


def to_host(gen: torch.Tensor, dec: torch.Tensor
            ) -> Tuple[np.ndarray, np.ndarray]:
    """(gen (b, T) int32, dec (b, T, 2) f32) -> numpy, in ONE device->host
    copy: the int32 ids ride as float32 bit patterns beside the logits."""
    packed = torch.cat([gen.view(torch.float32)[..., None], dec], dim=-1)
    host = packed.cpu().numpy()
    return (np.ascontiguousarray(host[..., 0]).view(np.int32),
            np.ascontiguousarray(host[..., 1:]))


def generate_async(params, cfg: ModelConfig, prompts, *,
                   max_new_tokens: int = 12, temperature: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   stop_at_eos: bool = True, prompt_lens=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``generate`` without the host copy: device (gen, dec) tensors."""
    if temperature > 0.0 and generator is None:
        raise ValueError(
            "generate(temperature > 0) requires an explicit torch.Generator "
            "(greedy decoding stays deterministic without one)")
    state = prefill_state(params, cfg, prompts,
                          max_new_tokens=max_new_tokens,
                          prompt_lens=prompt_lens, generator=generator)
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
