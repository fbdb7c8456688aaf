#!/usr/bin/env python3
"""Drive the PyTorch port of SCOPE (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero with no result):

  1. device      — the card's name and power limit, torch and CUDA versions
  2. build       — compile the eight CUDA kernels from ``src/repro_torch/csrc``
                   (one nvcc per source, in parallel); ptxas must report
                   no spill
  3. kernels     — each kernel against its plain PyTorch version on the card,
                   at the main path's shapes and at edge shapes (flash: q,
                   k, v as the model's transposed (b, s, h, d) views; bf16
                   through the tensor-core kernel with every mask and shape
                   it takes — window + softcap, negative q_offset with its
                   masked rows exactly 0, non-causal sk != sq, dv != d,
                   groups 1 to 8, sq = 1, 200 tokens, d 32 to 256 — two
                   launches bitwise equal, and a bf16 view whose stride is
                   not a multiple of 8 refused; f32 through the FMA
                   kernel at 2e-5; top-k on raw queries, one launch a
                   call, exact ties included); the paged
                   decode kernel also bit for bit against the dense decode
                   kernel on the same logical cache, and with the trash page
                   and every unreferenced page poisoned to 1e9; both decode
                   kernels at ~4000 keys, two launches bitwise equal, and
                   the dense one bitwise equal on the same keys in a deeper
                   cache and in a view whose rows are not 16-byte aligned;
                   the SSD scan also at chunks 1 to 128, across chunk
                   boundaries, on strided inputs and at head counts its
                   group of 4 does not divide; the SSD decode step in place
                   on a layer view of the full 48-layer stacked cache (the
                   other layers untouched), 12 steps chained from the
                   scan's final state, two launches bitwise equal, and at
                   edge shapes; the flash backward kernel (through the
                   autograd Function, as a loss reaches it) against autograd
                   of the plain version: f32 at d 32 to 256, groups 1 to 4,
                   ragged lengths, window, q_offset (rows with no key get
                   zero gradient), dv != d, softcap; bf16 on tensor cores
                   at the SFT shape and at 300 tokens, groups 1 / 3 / 8,
                   d 32 to 256, dv != d, windows with either sign of
                   q_offset, non-causal sk != sq, softcap; the saved
                   log-sum-exp against the plain one (+inf on rows with
                   no key), the forward's bits equal with and without it;
                   two launches bitwise equal; zamba2-7b's shapes: flash
                   and both decode kernels at head dim 112, group 1, in
                   bf16 and f32 (its prefill and last decode step, ragged
                   tiles and lengths, window and softcap, masked rows),
                   the SSD scan at 112 heads of 64, state 64, chunk 49,
                   and the SSD step in place on its 81-layer stacked
                   cache, two launches bitwise equal, and the flash
                   backward at head dim 112, group 1, in bf16 and f32
                   (the SFT shape, ragged tiles, window and softcap,
                   masked rows, 200 tokens, non-causal sk != sq); the SSD
                   scan backward (through the autograd Function, as a loss
                   reaches it, on a generator of its own) and its plain
                   version against the plain version run in float64, f32
                   within 2e-5 and bf16 x within 3e-2 x max(1, max|want|):
                   mamba2-1.3b's and zamba2-7b's SFT shapes, chunk 1,
                   chunk = l, several chunks, the small configs' chunk 3,
                   a chunk of 128 or 100 walked in pieces, heads the group
                   of 4 does not divide, x a strided slice of the conv
                   output, a final-state gradient; for the bf16 body 9
                   heads, a chunk of 33 (a partial 16-row tile), x rows
                   not 16-byte aligned (p 12) and pieces of 64; two launches bitwise
                   equal, the forward's bits equal with and without the
                   saved states, and the autograd path's bits equal to the
                   wrapper's; the dense families' shapes (a generator of
                   their own): flash, dense and paged decode at GQA group
                   12 (starcoder2-3b) in bf16 and f32, decode and paged
                   decode at group 2 (internlm2-1.8b), flash and decode at
                   gemma2-9b's heads of 256 with softcap 50 and windows
                   shorter than the keys, and the ring-buffer decode's call
                   (a window-sized cache, no window mask, min(pos + 1,
                   window) slots) against its plain version and the
                   windowed history, two launches bitwise equal; the
                   multimodal families' shapes (a generator of their own):
                   flash, dense and paged decode at qwen2-vl-7b's group 7
                   (its serve and its image prefill of 320 tokens), and at
                   whisper-medium's heads of 64: the decoder's flash and
                   decode, the encoder's flash non-causal over 1500
                   frames, the cross-attention's over them at 49 tokens
                   and at sq = 1, the dense decode over 1500 keys; the MoE
                   families' shapes (a generator of their own, every case
                   two launches bitwise equal): flash at deepseek-v2-lite's
                   MLA pair (q / k 192, v 128, 16 heads, group 1, the
                   scale passed explicitly; causal at the serve's shape,
                   a q_offset, masked rows, non-causal sk != sq, 200
                   tokens, f32) and at its reduced config's 48 / 32 (f32
                   and bf16), flash, dense and paged decode at
                   qwen3-moe's group 16 (64 heads on 4 of 128); the
                   training families' shapes (a generator of their own,
                   every case two launches bitwise equal): the flash
                   backward at MLA's (192, 128) (deepseek's SFT shape,
                   masked rows, 200 tokens, non-causal sk != sq, f32) and
                   (48, 32) (f32 and bf16, masked rows, a window), at
                   gemma2-9b's heads of 256 with softcap 50 (and a
                   window), at groups 16, 12 and 7 (qwen2-vl's 256 stub
                   patches and 57 tokens), at whisper-medium's encoder (64
                   x 1500 frames, non-causal) and cross-attention (f32
                   too), and at the small configs' f32 shapes; flash at
                   the MLA pair on the 4 of 16 heads a rank of a (1, 4)
                   mesh computes (a generator of its own, two launches
                   bitwise equal); whisper-medium's attention on the 4 of
                   16 heads of 64 a rank of a (1, 4) mesh computes (a
                   generator of its own, every case two launches bitwise
                   equal): flash over the encoder's 1500 frames, the
                   decoder's causal self-attention, the cross-attention
                   at 49 tokens and at sq = 1, the dense decode, the flash
                   backward over the encoder and the cross-attention
  4. timing      — each kernel, its plain version and one PyTorch library
                   call computing the same function (device time: CUDA
                   graph replays between CUDA events), beside the least time
                   the card could take (its bound) and, for the decode
                   kernels, the launch floor (a one-element op in the same
                   harness); for the paged kernel the yardstick is a page
                   gather plus SDPA, for top-k the same work as the
                   wrapper's one launch (normalize the raw queries, the
                   product, torch.topk); no single PyTorch call computes
                   the SSD scan or the SSD decode step; the flash backward
                   at the SFT shape beside its plain version's autograd and
                   SDPA's backward, all three by the profiler's sum of
                   device time (and eager), the kernel also in graph
                   replays; the flash forward with and without its
                   log-sum-exp output; flash, dense decode, the SSD scan
                   and step again at zamba2-7b's shapes (SDPA beside the
                   attention kernels), and the flash backward at its head
                   dim 112 beside SDPA's backward; the SSD scan backward at
                   both SFT shapes (64 x 57 tokens; 64 heads of 64, state
                   128, and 112 heads, state 64) beside its plain version
                   (no single PyTorch call computes it), in graph replays
                   and by the profiler's sum of device time; flash and
                   dense decode at gemma2-9b's serve shapes (softcap 50:
                   the yardstick is flex_attention under torch.compile
                   with a tanh score_mod, first held to the plain version)
                   and at starcoder2-3b's (group 12), dense decode at
                   internlm2-1.8b's (group 2), and flash and dense decode at
                   qwen2-vl-7b's (group 7) and whisper-medium's decoder
                   (group 1, d 64), all from one table of attention
                   shapes; then flash at qwen2-vl-7b's image prefill (8 x
                   320 tokens), at whisper-medium's encoder (56 x 1500
                   frames, non-causal) and cross-attention (49 tokens and
                   sq = 1 over 1500 frames; beside the latter the dense
                   decode kernel at cache_len 1500, a finding only), the
                   paged decode at group 7; flash and dense decode at
                   qwen3-moe's group 16 and flash at deepseek's (192,
                   128) (SDPA with v's own head dim as the yardstick, or
                   the row says it refused), and the paged decode at group
                   16; the flash backward at the training families' SFT
                   shapes: deepseek's MLA (16 heads, (192, 128), its
                   scale), gemma2-9b's heads of 256 with softcap 50 (no
                   yardstick: SDPA takes no softcap), qwen3-moe's group 16
                   and whisper-medium's encoder (64 x 1500 frames,
                   non-causal), each beside its plain version and SDPA's
                   backward
  5. tiny        — ``ScopeEngine.serve`` on scope-tiny with seeded weights,
                   once on the card (kernels) and once on the CPU (plain
                   versions): equal token streams and decisions
  6. full        — ``ScopeEngine.serve`` on scope-qwen3-4b at full width
                   (36 layers, d 2560, random seeded weights, bf16): 8 test
                   queries x 7 models, launch counts of every kernel read
                   around the run
  6a. lint       — scopelint-torch (``repro_torch.analysis``) on the card:
                   its runtime pass over the five registered serve units
                   (dense, dense refill, paged and paged refill decode
                   segments of 4 steps, 56 rows, 49-token prompts, 16-token
                   pages, on phase 6's full-width params; the tier-0
                   forward) under its dispatch recorder and CUDA's sync
                   debug mode: no host read, float64 output or
                   device->host copy in any window, no sync after a
                   window's first launch, the syncs before it equal to the
                   registry's counts, and the flash, decode and paged
                   decode launches each unit's steps and 36 layers imply;
                   then its static pass over ``src/repro_torch`` (no
                   unsuppressed finding) and its self-test
  7. tiny stream — ``predict_stream`` on scope-tiny, whole-retire and with
                   slot refill over a dense and a paged KV cache, on the
                   card and on the CPU: equal token streams, parsed fields,
                   decisions and scheduler counters
  8. full stream — ``serve_stream`` with slot refill on scope-qwen3-4b at
                   full width: 16 test queries x 7 models in ragged ticks,
                   over the paged KV (paged kernel) and over a dense cache on
                   the same schedule (dense kernel), which must agree bit for
                   bit; launch counts read around each run (36 per decode
                   step or prefill call), wall time, KV footprint, peak
                   memory, and the device's idle share over a window of
                   segments
  9. tiny ssm    — ``ScopeEngine.serve`` on a small pure-SSM Mamba2 config
                   with seeded weights, on the card (SSD kernels) and on the
                   CPU (plain versions): equal token streams and decisions
 10. full ssm    — ``ScopeEngine.serve`` on mamba2-1.3b at full width and
                   depth (48 layers, d 2048, 64 SSM heads of 64, state 128,
                   random seeded weights, bf16): 8 test queries x 7 models,
                   48 SSD scan launches per prefill call and 48 SSD decode
                   step launches per decode step, no attention kernel,
                   finite logits, prefill and decode times, idle share, peak
                   memory
 11. tiny hybrid — ``ScopeEngine.serve`` on a small zamba2 hybrid
                   (zamba2-7b's ``reduced(num_layers=5, d_model=448)``: two
                   units of two mambas and the tied shared attention block,
                   then a mamba; heads of 112, f32) with seeded weights, on
                   the card (flash, decode and SSD kernels) and on the CPU:
                   equal token streams and decisions
 12. full hybrid — ``ScopeEngine.serve`` on zamba2-7b at full width and
                   depth (81 mamba layers, d 3584, the shared attention +
                   MLP block after every 6th, 13 occurrences; 6.64 B random
                   seeded params, bf16): 8 test queries x 7 models, launches
                   flash 13, decode 13 x 12, SSD scan 81, SSD step 81 x 12
                   a cold serve, finite logits, prefill and decode times,
                   idle share, peak memory; the weights freed after
 12a. tiny dense — ``ScopeEngine.serve`` on two small dense configs with
                   seeded weights, on the card and on the CPU (equal token
                   streams and decisions): starcoder2-3b at GQA group 12
                   and gemma2-9b at heads of 256 with a window of 16 under
                   the prompts (softcaps, post-norms, scaled embeddings);
                   then the small gemma2 windowed at 4 on every layer, 12
                   decode steps from position 0 over ring caches of 4
                   slots (logits within 2e-5, greedy tokens equal)
 12b. full dense — ``ScopeEngine.serve`` on gemma2-9b, gemma2-2b,
                   starcoder2-3b and internlm2-1.8b at full width and depth
                   (random seeded weights, bf16), one phase each as phase
                   12: flash one launch a layer, decode a layer and step,
                   finite logits, prefill and decode times, idle share,
                   peak memory; the weights freed after each
 12c. tiny multimodal — ``ScopeEngine.serve`` on a small qwen2-vl config at
                   GQA group 7 (text only), on the card and on the CPU
                   (equal token streams and decisions); then the
                   model-level stub serve (``prefill`` with the stubs, 8
                   greedy ``decode_step`` calls) of it (8 patches, Qwen2-VL's
                   (t, h, w) positions) and of a small whisper (2 + 2
                   layers, 32 frames): in f32 equal tokens and logits within
                   2e-5, in bf16 the CPU's tokens fed to both and logits
                   within 3e-2; flash and decode launches counted
 12d. full vlm   — qwen2-vl-7b at full width and depth (28 layers, d 3584,
                   28 heads on 4 of 128, M-RoPE, 7.07 B random seeded
                   params, bf16): ``ScopeEngine.serve`` as phase 12 (text
                   only); an image prefill of 8 rows of 256 stub patches
                   and 64 text tokens with Qwen2-VL's positions, then 12
                   greedy decode steps (walls, device busy, idle share,
                   peak, launches); the serve's prompts over 16-token pages
                   and a dense cache, equal bit for bit
 12e. full audio — whisper-medium at full width and depth (24 encoder and 24
                   decoder layers, d 1024, 16 heads of 64, 0.76 B random
                   seeded params, bf16): 56 rows of 1500 stub frames and
                   49-token prompts, ``prefill`` then 12 greedy
                   ``decode_step`` calls; the encoder, prefill and decode
                   step's walls, device time, idle shares and peak; flash
                   launches 24 + 2 x 24 a prefill and 24 a step, decode 24
                   a step
 12f. tiny moe   — ``ScopeEngine.serve`` and ``predict_stream`` (whole-retire
                   and dense refill; paged refill for qwen3-moe) on the two
                   MoE configs' ``reduced()`` (f32, seeded weights), on the
                   card and on the CPU: equal token streams and decisions;
                   every router call's smallest margin between a token's
                   k-th and (k + 1)-th probability printed
 12g. full mla   — deepseek-v2-lite-16b at full width and depth (27 layers:
                   one MLA + dense layer, 26 MLA + MoE layers of 64 routed
                   and 2 shared experts, top-6; 15.50 B random seeded
                   params, bf16): ``ScopeEngine.serve`` as phase 12 (flash
                   one launch a layer at (192, 128), no decode kernel: the
                   absorbed MLA decode is plain), prefill and decode-step
                   device ms, idle shares, peak; then one prefill with the
                   MoE in profiler ranges: its share of the prefill's
                   device time and the choices dropped at capacity in each
                   layer
 12h. full moe   — qwen3-moe-235b-a22b at full width and 8 of its 94
                   layers (128 experts of 4096 x 1536, top-8, 64 heads on 4
                   of 128; 20.52 B params; all 94 layers are ~470 GB): the
                   same, and the serve's prompts over 16-token pages and a
                   dense cache, equal bit for bit
 13. tiny tiers  — scope-tiny with seeded weights and a seeded tier-0 head,
                   on the card and on the CPU: ``predict_stream`` over paged
                   slot refill with the gate at a midpoint between two
                   adjacent head confidences (equal answered and escalated
                   pair sets, escalated token streams, decisions and
                   ``tiers`` ledger); a dispatch fault with
                   ``max_retries=0`` (equal tier-0 fallbacks and p); a
                   ``hot_swap`` at a tick boundary to a second seeded
                   estimator, whose post-swap ticks equal a fresh engine's
                   on the new weights bit for bit on the card
 14. full tiers  — phase 8's paged refill ``serve_stream`` on scope-qwen3-4b
                   at full width with the tier-0 gate on at the median head
                   confidence, ``drift_detect`` on, a ``model_drift`` fault
                   armed and one ``hot_swap`` after the fifth tick to a
                   second seeded full-width weight set: answered +
                   escalated = 112, submitted = escalated, tokens saved =
                   answered x 12, one hot swap, paged decode launches = 36
                   x decode steps, finite logits; the gate's wall and
                   device time per request, the stream's wall and idle
                   share, peak memory
 15. tiny train  — scope-tiny from the same seeded port params on the card
                   and on the CPU: the loss and every gradient leaf of one
                   SFT batch, ten SFT steps (losses within 1e-4), then a
                   greedy GRPO step on each (equal rollouts, rewards and
                   advantages; loss, pg and kl within 2e-5)
 16. full train  — scope-qwen3-4b at full width from seeded random weights:
                   three SFT steps of 64 sequences (72 forward and 36
                   backward flash launches a step: one checkpoint a layer)
                   and one GRPO step (16 tasks x group 4, 12 new tokens);
                   loss, reward, format rate, step wall and device time,
                   peak memory
 17. tiny ssm train    — the small pure-SSM config of phase 9 from the same
                   seeded port params on the card and on the CPU: the loss
                   and every gradient leaf of one SFT batch (loss within
                   2e-5, each leaf within 1e-4 of its largest magnitude),
                   then ten SFT steps (losses within 1e-4); launches (two
                   SSD scans and one SSD backward a mamba layer a step,
                   one checkpoint a layer)
 18. tiny hybrid train — the same on phase 11's small zamba2 hybrid (its
                   tied block: two flash forwards and one flash backward
                   at head dim 112 an occurrence)
 19. full ssm train — mamba2-1.3b at full width and depth from seeded
                   random weights: every gradient leaf of one batch with
                   the SSD backward kernel against its plain version
                   (within 0.1 of the leaf's max in the bf16 model, the
                   share of differing signs), then three SFT steps of 64
                   sequences (2 x 48 SSD scan and 48 SSD backward launches
                   a step); losses, step wall and device time, peak memory
 20. full hybrid train — zamba2-7b at full width and 12 of its 81 mamba
                   layers (2 shared-block occurrences, ~1.26 B params; at
                   full depth its AdamW state alone needs ~80 GB): three
                   SFT steps of 64 sequences; the same readings
 20a. tiny families train — the small dense, multimodal and MoE configs of
                   phases 12a, 12c and 12f from the same seeded port
                   params on the card and on the CPU: the loss and every
                   gradient leaf of one SFT batch (with the stub inputs of
                   ``pipeline.with_stubs`` for qwen2-vl and whisper; loss
                   within 2e-5, each leaf within 1e-4 of its largest
                   magnitude), ten SFT steps (losses within 1e-4), and a
                   greedy GRPO step for the text-only ones (equal
                   rollouts); the flash forward and backward launches by
                   (sq, sk, causal)
 20b. full family train — starcoder2-3b, internlm2-1.8b, gemma2-2b,
                   gemma2-9b (16 of 42 layers), qwen2-vl-7b (16 of 28
                   layers, 16 rows of 256 stub patches and 57 tokens),
                   whisper-medium (1500 stub frames a row),
                   deepseek-v2-lite-16b (its dense layer and 6 MoE
                   layers) and qwen3-moe-235b-a22b (1 of 94 layers) at
                   full width from seeded random weights, one phase each:
                   three SFT steps, the flash launches by (sq, sk, causal)
                   (two forward and one backward a call: the encoder's,
                   the decoder's self- and cross-attention), losses, step
                   wall and device time, peak memory, finite losses and
                   params; the weights freed after each
 21. CLIs        — ``python -m repro_torch.launch.train`` on scope-tiny,
                   then ``python -m repro_torch.launch.serve --checkpoint``
                   on what it saved, both on the card
 22. planning    — ``launch.dryrun``: the host plan of all 40 (arch, input
                   shape) pairs (34 ok, 6 skipped with the reference's
                   reason), then each of the 34 steps once on the card
                   through ``run_one`` at its shape's own length (train
                   4096, prefill 32768, decode one token against 32768
                   cached or, for long_500k, a window's ring or an SSM
                   state), seeded random weights, the cuts of
                   ``plan_cut`` listed under ``reduced``: output finite
                   and of its shape, each kernel of its path launched;
                   the kernels at those lengths against their plain
                   versions (``long_checks``: flash at 4096 x 4096 and
                   over 32768 keys, with gemma2-9b's window and softcap;
                   the flash backward at 4096; the dense decode over 32768
                   keys; gemma2-9b's 4096-slot ring full and wrapped; the
                   SSD scan and its backward over 4096 and 32768 tokens
                   against float64), two launches bitwise equal; and their
                   times beside their bounds and yardsticks
                   (``long_timings``); the phase's seconds
 23. mesh        — scope-qwen3-4b at full width served through
                   ``ReasoningEstimator.shard`` over a serve mesh of a
                   world-1 NCCL process group (``launch.mesh``): one
                   batch's tokens and decision logits, the batch serve
                   (decisions, parsed fields, launches; walls and peaks
                   alternated P1 C1 C2 P2), a dense and a paged refill
                   stream (each request's window, decisions, scheduler
                   stats, launches), all bit for bit equal to the
                   unsharded engine on the same weights; ``launch.serve
                   --mesh`` under ``torch.distributed.run`` on a scope-tiny
                   checkpoint written there, its report the unsharded
                   one; on a machine with more cards, the batch serve at
                   world min(cards, 4) (``chip_smoke.py --mesh-rank``, one
                   process a card) held to world 1
 24. mesh training — scope-qwen3-4b at full width placed by
                   ``ReasoningEstimator.shard(make_host_mesh())`` over a
                   world-1 NCCL group: three SFT steps (losses, every param
                   leaf and the flash forward / backward launches) and a
                   batch serve (decisions, parsed fields, launches), all bit
                   for bit equal to the unsharded runs on the same weights
                   and batches, walls and peaks beside them; on a machine
                   with more cards, world n = min(cards, 4), one process a
                   card (``chip_smoke.py --mesh-train-rank``): TP over a
                   (1, n) mesh (the batch serve and a dense and a paged
                   refill stream equal to world 1 with p_hat within 3e-2,
                   three SFT steps within 3e-2 of world 1's losses, the
                   attention kernels at 32/n on 8/n heads, each rank's
                   param bytes ``local_bytes``, and those kernels at those
                   heads against their plain versions and timed) and FSDP
                   over an (n, 1) mesh (gemma2-9b at 16 layers and zamba2-7b
                   at 12 mamba layers within 3e-2 of world 1, then both at
                   full depth: finite losses, step walls, per-card peaks,
                   the bytes of params and AdamW state a rank holds); then
                   the MoE and GRPO job, the SSM backbones' TP job and
                   deepseek-v2-lite-16b's MLA over TP (1, n)
                   (``--mesh-mla-rank``: every flash call at 16/n heads,
                   the latent caches whole, held to world 1 on rank 0's
                   card: serve at 27 layers, logits and gradient leaves
                   at 2 and 7 layers, three SFT steps), and
                   whisper-medium over TP (1, n) (``--mesh-cross-rank``:
                   the encoder's and the decoder's self- and
                   cross-attention at 16/n heads, a rank's ``ck`` / ``cv``
                   its own heads', held to world 1 on rank 0's card: the
                   audio serve at 24 + 24 layers fed world 1's tokens,
                   logits and gradient leaves at 2 + 2 layers, three SFT
                   steps at full depth)

It prints a ``kernels`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  ``python3 chip_smoke.py
--mesh-phase`` runs phases 1, 2, the world, 23 and 24 alone and ends with
the mesh report (on a machine with several cards, phases 23 and 24 also
run over min(cards, 4) of them); ``--mesh-phase ssm`` runs of those phase
24 alone, the SSM backbones (on several cards their TP job too);
``--mesh-phase mla`` the MLA job alone and ``--mesh-phase cross`` the
whisper job alone (several cards).  Details
go to ``build/chip_smoke.json``.  Needs one CUDA card; without one it exits
with code 1.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build"

F32_TOL, BF16_TOL, TOPK_TOL = 2e-5, 3e-2, 1e-5
# the SSD backward's float32 outputs (d(dt), dB, dC) with x in bf16: the
# hi + lo splits keep them near f32 (~2e-3 of their maxima without the lo
# parts)
SPLIT_TOL = 1e-4
N_QUERIES, K_ANCHORS, N_ANCHORS, NEW_TOKENS = 8, 5, 250, 12

# the streaming phases: 16 test queries x 7 models in ragged ticks, slot
# buckets up to 16, 4-step segments, 16-token KV pages
STREAM_QUERIES, STREAM_BUCKETS, SEGMENT, PAGE = 16, (1, 2, 4, 8, 16), 4, 16

TPU_KERNELS = {
    "topk_retrieval": "src/repro/kernels/topk_retrieval.py:68",
    "flash_attention": "src/repro/kernels/flash_attention.py:76",
    "decode_attention": "src/repro/kernels/decode_attention.py:88",
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:185",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:80",
    "ssd_decode_step": "src/repro/kernels/ops.py:308 (plain XLA, no Pallas "
                       "kernel)",
    "flash_attention_bwd": "src/repro/kernels/ref.py:18 (no Pallas kernel: "
                           "XLA's gradient of ref.attention, which "
                           "src/repro/kernels/ops.py:40 sends training to)",
    "ssd_scan_bwd": "src/repro/kernels/ref.py:76 (no Pallas kernel: XLA's "
                    "gradient of ref.ssd, reached from "
                    "src/repro/models/ssm.py:75)",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in TPU_KERNELS}
# the kernels of the zamba2-7b serve, whose rows of the kernels line carry
# this suffix: its shapes (head dim 112, g = 1; 112 SSM heads, state 64)
# and launches are its own
HYBRID = "@zamba2-7b"
HYBRID_KERNELS = ("flash_attention", "decode_attention", "ssd_scan",
                  "ssd_decode_step")
# and of the zamba2-7b SFT steps (phase 20), at head dim 112 and its SSD
# shapes
HYBRID_TRAIN_KERNELS = ("flash_attention_bwd", "ssd_scan_bwd")
# the dense families' full-width serves (phase 12b): rows of the kernels
# line named <kernel>@<config> carry that config's shapes and launches
# (gemma2-9b: heads of 256, softcap 50, windows on its local layers;
# starcoder2-3b: GQA group 12; internlm2-1.8b: group 2)
DENSE_ROWS = (("flash_attention", "@gemma2-9b"),
              ("decode_attention", "@gemma2-9b"),
              ("flash_attention", "@starcoder2-3b"),
              ("decode_attention", "@starcoder2-3b"),
              ("decode_attention", "@internlm2-1.8b"))
DENSE_FULL = {"gemma2-9b": 9.0e9, "gemma2-2b": 2.5e9, "starcoder2-3b": 4.0e9,
              "internlm2-1.8b": 1.6e9}       # config: least params it has
# the multimodal families' full-width runs (phases 12d, 12e): rows named
# <kernel>@<config>[/<call>] carry that run's shapes and launches.
# qwen2-vl-7b: GQA group 7 at heads of 128 in its serve (flash, dense
# decode), its image prefill of 8 x 320 tokens (/image) and its paged
# decode; whisper-medium: heads of 64 at group 1 in the decoder's
# self-attention (flash, dense decode), the encoder over 1500 frames
# (/encoder, non-causal) and the cross-attention over them, of the prefill
# (/cross) and of each decode step (/cross-sq1)
VLM, AUDIO = "@qwen2-vl-7b", "@whisper-medium"
MULTIMODAL_ROWS = (("flash_attention", VLM), ("flash_attention", VLM + "/image"),
                   ("decode_attention", VLM), ("paged_decode_attention", VLM),
                   ("flash_attention", AUDIO),
                   ("flash_attention", AUDIO + "/encoder"),
                   ("flash_attention", AUDIO + "/cross"),
                   ("flash_attention", AUDIO + "/cross-sq1"),
                   ("decode_attention", AUDIO))
VLM_PATCHES, VLM_TEXT, VLM_ROWS = 256, 64, 8    # the image prefill's shape
# the MoE families' full-width serves (phases 12g, 12h): rows named
# <kernel>@<config> carry that serve's shapes and launches.
# deepseek-v2-lite-16b: its MLA prefill's flash at q / k 192, v 128, 16
# heads at group 1 (its decode is the plain absorbed form, no kernel);
# qwen3-moe-235b-a22b: GQA group 16 (64 heads on 4 of 128) in its flash,
# dense decode and paged decode
MLA, MOE_Q = "@deepseek-v2-lite-16b", "@qwen3-moe-235b-a22b"
MOE_ROWS = (("flash_attention", MLA), ("flash_attention", MOE_Q),
            ("decode_attention", MOE_Q), ("paged_decode_attention", MOE_Q))
MOE_LAYERS = 8          # qwen3-moe-235b-a22b's depth on one card (of 94)
# the training families' full-width SFT steps (phase 20b): rows named
# flash_attention_bwd@<config>[/encoder] carry that run's backward shapes
# and launches (deepseek-v2-lite-16b's MLA at (192, 128), gemma2-9b's heads
# of 256 with softcap 50, qwen3-moe-235b-a22b's g 16, whisper-medium's
# encoder non-causal over its frames)
TRAIN_ROWS = (("flash_attention_bwd", MLA),
              ("flash_attention_bwd", "@gemma2-9b"),
              ("flash_attention_bwd", MOE_Q),
              ("flash_attention_bwd", AUDIO + "/encoder"))
TO_PORT = []            # every TPU kernel of the repository has a port
NO_LAUNCHES = {name: 0 for name in TPU_KERNELS}
# the training phases: SFT steps on the small configs and at full width,
# and the full-width SFT batch
SFT_STEPS_TINY, SFT_STEPS_FULL, SFT_BATCH = 10, 3, 64
# the dense, multimodal and MoE families' SFT steps at full width (phase
# 20b): config -> (least params of what runs, layers kept of its depth
# or None for all, SFT batch).  A step holds bf16 weights, bf16 gradients
# and f32 AdamW moments, ~12 bytes a parameter, beside the activations and
# the loss's float32 logits over the vocabulary, so the largest run cut:
# gemma2-9b at 16 of 42 layers (eight (local, global) units; at 20 AdamW's
# update ran out of the card's memory), qwen2-vl-7b at
# 16 of 28 and 16 sequences (each its 256 stub patches before the 57
# tokens: the float32 logits over 152064 ids of 64 such rows would take
# ~12 GB a copy), deepseek-v2-lite-16b at its dense layer and 6 of its 26
# MoE layers, qwen3-moe-235b-a22b at 1 of 94 layers (~30 GB of state a
# layer)
FAMILY_TRAIN = {
    "starcoder2-3b": (4.0e9, None, SFT_BATCH),
    "internlm2-1.8b": (1.6e9, None, SFT_BATCH),
    "gemma2-2b": (2.5e9, None, SFT_BATCH),
    "gemma2-9b": (3.9e9, 16, SFT_BATCH),
    "qwen2-vl-7b": (4.0e9, 16, 16),
    "whisper-medium": (0.7e9, None, SFT_BATCH),
    "deepseek-v2-lite-16b": (3.5e9, 7, SFT_BATCH),
    "qwen3-moe-235b-a22b": (2.9e9, 1, SFT_BATCH),
}

# SSD scan checks: name, (b, l, h, p, n, chunk; 0 = the main path's chunk
# of an L-token prompt, l 0 = L), x / A dtype, dt scale, the kernel whose
# max_abs_err it gives, x as a strided slice of the conv output
SSD_CASES = [
    ("ssd main", (56, 0, 64, 64, 128, 0), "bfloat16", 1.0, "ssd_scan", True),
    ("ssd main f32", (56, 0, 64, 64, 128, 0), "float32", 1.0, None, True),
    ("ssd chunk 16 nc 4", (1, 64, 2, 16, 8, 16), "float32", 0.1, None, False),
    ("ssd chunk 32 nc 4", (2, 128, 3, 16, 8, 32), "float32", 0.1, None,
     False),
    ("ssd chunk 24 nc 4", (2, 96, 1, 32, 16, 24), "float32", 0.1, None,
     False),
    ("ssd chunk 128 nc 2", (1, 256, 4, 8, 4, 128), "float32", 0.1, None,
     False),
    ("ssd chunk 7 nc 7", (2, 49, 3, 32, 16, 7), "float32", 0.1, None, False),
    ("ssd chunk 1", (2, 5, 3, 16, 8, 1), "float32", 0.1, None, False),
    ("ssd chunk 49 f32 full head", (2, 49, 4, 64, 128, 49), "float32", 0.1,
     None, False),
    ("ssd chunk 128 nc 2 full head", (2, 256, 64, 64, 128, 128), "float32",
     0.1, None, False),
    ("ssd chunk 24 nc 4 n 16", (1, 96, 4, 64, 16, 24), "float32", 0.1, None,
     False),
    # one head, and head counts the group of 4 does not divide (3, 5, 6);
    # p 12 / n 6 take the element-by-element x (bf16) and B, C paths; a
    # chunk of 100 is walked in two pieces of 50
    ("ssd h 1", (2, 49, 1, 64, 128, 49), "float32", 1.0, None, False),
    ("ssd h 3 bf16", (3, 49, 3, 64, 128, 49), "bfloat16", 1.0, None, True),
    ("ssd h 5 p 12 n 6 bf16", (2, 49, 5, 12, 6, 49), "bfloat16", 0.1, None,
     False),
    ("ssd h 5 p 12 n 6", (2, 49, 5, 12, 6, 49), "float32", 0.1, None, False),
    ("ssd h 6 chunk 100 nc 2", (1, 200, 6, 16, 8, 100), "float32", 0.1, None,
     False),
]
# zamba2-7b's prefill: 112 heads of 64, state 64 (its own generator, see
# kernel_checks)
HYBRID_SSD_CASES = [
    ("ssd zamba2", (56, 0, 112, 64, 64, 0), "bfloat16", 1.0,
     "ssd_scan" + HYBRID, True),
    ("ssd zamba2 f32", (56, 0, 112, 64, 64, 0), "float32", 1.0, None, True),
]
# the SSD decode step's edge shapes: (b, h, p, n), chained steps
STEP_CASES = [((1, 3, 16, 8), 4), ((2, 5, 16, 16), 4), ((1, 64, 64, 128), 3)]
# SSD scan backward checks: name, (b, l, h, p, n, chunk; l 0 = the SFT
# length, chunk 0 = the model's chunk of it), x / A dtype, dt scale, x as
# a strided slice of the conv output, a final-state gradient, the row whose
# max_abs_err it gives (its own generator, see ssd_bwd_checks)
SSD_BWD_CASES = [
    ("ssd bwd main", (64, 0, 64, 64, 128, 0), "bfloat16", 1.0, True, False,
     "ssd_scan_bwd"),
    ("ssd bwd main f32", (64, 0, 64, 64, 128, 0), "float32", 1.0, True,
     False, None),
    ("ssd bwd zamba2", (64, 0, 112, 64, 64, 0), "bfloat16", 1.0, True, False,
     "ssd_scan_bwd" + HYBRID),
    ("ssd bwd zamba2 f32", (64, 0, 112, 64, 64, 0), "float32", 1.0, True,
     False, None),
    ("ssd bwd chunk 1", (2, 5, 3, 16, 8, 1), "float32", 0.1, False, True,
     None),
    ("ssd bwd chunk = l", (2, 40, 3, 16, 8, 40), "float32", 0.1, False,
     False, None),
    ("ssd bwd chunk = l dstate", (2, 40, 3, 16, 8, 40), "float32", 0.1,
     False, True, None),
    ("ssd bwd chunk 16 nc 4", (2, 64, 5, 32, 16, 16), "float32", 0.1, False,
     True, None),
    # the small configs' SFT chunk: 19 chunks of 3
    ("ssd bwd chunk 3 nc 19", (4, 57, 16, 32, 16, 3), "float32", 1.0, True,
     False, None),
    ("ssd bwd chunk 128 nc 2", (1, 256, 4, 16, 8, 128), "float32", 0.1,
     False, True, None),
    ("ssd bwd chunk 100 nc 2", (1, 200, 6, 16, 8, 100), "float32", 0.1,
     False, False, None),
    ("ssd bwd h 5 p 12 n 6", (2, 49, 5, 12, 6, 7), "float32", 0.1, False,
     True, None),
    ("ssd bwd h 3 bf16 dstate", (3, 0, 3, 64, 128, 0), "bfloat16", 1.0, True,
     True, None),
    ("ssd bwd h 1", (2, 0, 1, 64, 128, 0), "float32", 1.0, False, False,
     None),
    ("ssd bwd full head nc 2 dstate", (2, 114, 64, 64, 128, 57), "float32",
     1.0, True, True, None),
    # the bf16 body's edges, drawn after the cases above: 9 heads (a last
    # group of one head, one round of its two lanes), a chunk of 33 that
    # pads to a partial 16-row tile (three t tiles; two chunks, so every
    # state term), x rows that are not 16-byte aligned (p 12, n 6: staged
    # element by element), and a chunk of 128 in pieces of 64 (a block
    # walking several pieces)
    ("ssd bwd h 9 bf16", (2, 0, 9, 64, 128, 0), "bfloat16", 1.0, True, False,
     None),
    ("ssd bwd chunk 33 nc 2 bf16 dstate", (2, 66, 5, 64, 64, 33), "bfloat16",
     1.0, False, True, None),
    ("ssd bwd h 5 p 12 n 6 bf16", (2, 49, 5, 12, 6, 7), "bfloat16", 0.1,
     False, True, None),
    ("ssd bwd chunk 128 nc 2 bf16 dstate", (1, 256, 6, 64, 128, 128),
     "bfloat16", 1.0, True, True, None),
]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0: float) -> None:
    print(f"   ({time.perf_counter() - t0:.2f} s)", flush=True)


def release(torch) -> None:
    """Free what a phase left behind before the next one measures its peak:
    reference cycles first (an engine and its caches can sit in one until
    the collector happens to run, holding device memory into a later
    phase's peak), then the allocator's cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def eager_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean time per eager call of ``fn`` over ``iters`` back-to-back calls,
    CUDA events around the run: what the eager main path pays per call,
    host launch overhead included whenever it exceeds the device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_SIDE = []                  # device_ms's side stream, made at first use


def device_ms(torch, fn, iters: int, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so no host
    overhead sits between the launches.  Inputs stay warm in L2, as on the
    main path, where the projections just wrote them.  The warm-up runs on
    one side stream for every call: cuBLAS keeps a workspace (tens of MiB)
    for each stream it has run on, as long as the process lives."""
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    side = _SIDE[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def times(torch, kernel, plain, library, iters: int):
    """Device ms of the kernel, its plain version and the library call
    (None where no single PyTorch call computes the function), and the
    eager per-call ms of the kernel's wrapper."""
    return dict(ms=device_ms(torch, kernel, iters),
                plain_ms=device_ms(torch, plain, max(iters // 10, 5)),
                library_ms=(None if library is None
                            else device_ms(torch, library, iters)),
                eager_ms=eager_ms(torch, kernel, iters))


def bound(nbytes: float, flops: float, dtype: str):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over the peak rate for their type (the H100's, the
    planning path's ``launch/step_cost``)."""
    from repro_torch.launch.step_cost import HBM_BYTES_PER_S, PEAK_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3/4: kernels against plain versions, and their times
# ---------------------------------------------------------------------------
def kernel_checks(torch, L: int, s_train: int):
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import topk_retrieval as TK

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    errs = {}

    def compare(name, got, want, tol, main=None, scale="abs"):
        """max |got - want| within ``tol`` ("abs"), within ``tol * max(1,
        max |want|)`` ("max"), within ``tol * min(1, max |want|)`` ("rel",
        for outputs far below 1), or each element's within ``tol * max(1,
        |want|)`` ("each")."""
        torch.cuda.synchronize()
        w = want.float()
        diff = (got.float() - w).abs()
        err = diff.max().item()
        if scale == "each":
            bad = (diff / w.abs().clamp(min=1.0)).max().item()
        else:
            top = w.abs().max().item()
            bad = err / {"abs": 1.0, "max": max(1.0, top),
                         "rel": max(min(1.0, top), 1e-30)}[scale]
        finite = bool(torch.isfinite(got.float()).all())
        how = {"abs": "", "max": " x max(1, max|want|)",
               "rel": " x min(1, max|want|)",
               "each": " x max(1, |want|) each"}[scale]
        print(f"   {name}: max_abs_err {err:.3g} (tol {tol}{how})")
        check(finite and bad <= tol, f"{name}: err {bad} > {tol} or non-finite")
        if main:
            errs[main] = err

    compare.errs = errs

    S = L + NEW_TOKENS
    # flash: (b, hq, hkv, sq, sk, d, dv), kwargs, dtype, the kernel whose
    # max_abs_err it gives, and the layout: "model" builds q, k, v as
    # gqa_full passes them (transposed views of (b, s, h, d) projections),
    # "heads" as contiguous (b, h, s, d).  The main path's shape is 56
    # prompts of L tokens, 32/8 heads of 128, bf16.  bf16 runs the
    # tensor-core kernel (every mask and shape it takes), f32 the FMA one
    bf = torch.bfloat16
    f32 = torch.float32
    flash_cases = [
        ("flash main", (56, 32, 8, L, L, 128, 128), {}, bf, "flash_attention",
         "model"),
        ("flash f32 tiny", (2, 4, 2, 17, 17, 32, 32), {}, f32, None, "heads"),
        ("flash window+softcap", (2, 4, 1, 70, 70, 64, 64),
         dict(window=16, softcap=30.0), f32, None, "heads"),
        ("flash dv!=d hkv=4", (1, 8, 4, 40, 40, 64, 32), {}, f32, None,
         "heads"),
        ("flash sk!=sq non-causal", (2, 2, 2, 33, 50, 32, 32),
         dict(causal=False), f32, None, "heads"),
        ("flash fully masked rows", (1, 4, 2, 20, 20, 32, 32),
         dict(q_offset=-5), f32, None, "heads"),
        ("flash d=256 bf16 softcap", (1, 4, 1, 33, 33, 256, 256),
         dict(softcap=50.0), bf, None, "heads"),
        ("flash bf16 window+softcap", (2, 8, 2, 70, 70, 64, 64),
         dict(window=16, softcap=30.0), bf, None, "model"),
        ("flash bf16 fully masked rows", (1, 4, 2, 20, 20, 32, 32),
         dict(q_offset=-5), bf, None, "model"),
        ("flash bf16 sk!=sq non-causal", (2, 4, 2, 33, 50, 64, 64),
         dict(causal=False), bf, None, "heads"),
        ("flash bf16 sk!=sq window offset", (2, 4, 2, 70, 130, 64, 128),
         dict(causal=False, window=40, q_offset=60), bf, None, "heads"),
        ("flash bf16 dv!=d", (1, 8, 4, 40, 40, 64, 32), {}, bf, None,
         "model"),
        ("flash bf16 group 1", (2, 8, 8, L, L, 128, 128), {}, bf, None,
         "model"),
        ("flash bf16 group 2", (2, 8, 4, L, L, 128, 128), {}, bf, None,
         "model"),
        ("flash bf16 group 4", (2, 8, 2, L, L, 128, 128), {}, bf, None,
         "model"),
        ("flash bf16 group 8", (2, 16, 2, L, L, 128, 128), {}, bf, None,
         "model"),
        ("flash bf16 group 3", (2, 6, 2, L, L, 128, 128), {}, bf, None,
         "model"),
        ("flash bf16 sq=1", (3, 32, 8, 1, 1, 128, 128), {}, bf, None,
         "model"),
        ("flash bf16 sq=1 last row", (3, 32, 8, 1, L, 128, 128),
         dict(q_offset=L - 1), bf, None, "heads"),
        ("flash bf16 s=200", (2, 32, 8, 200, 200, 128, 128), {}, bf, None,
         "model"),
        ("flash bf16 d=32", (2, 8, 2, L, L, 32, 32), {}, bf, None, "model"),
        ("flash bf16 d=64", (2, 8, 2, L, L, 64, 64), {}, bf, None, "model"),
        ("flash bf16 d=256 s=200", (1, 4, 2, 200, 200, 256, 256), {}, bf,
         None, "model"),
    ]
    def run_flash(cases, rnd, bitwise=False):
        """``bitwise``: every case's two launches bitwise equal, not only
        the main ones'."""
        for name, (b, hq, hkv, sq, sk, d, dv), kw, dt, main, layout in \
                cases:
            if layout == "model":
                q = rnd(b, sq, hq, d, dt=dt).transpose(1, 2)
                k = rnd(b, sk, hkv, d, dt=dt).transpose(1, 2)
                v = rnd(b, sk, hkv, dv, dt=dt).transpose(1, 2)
            else:
                q, k, v = (rnd(b, hq, sq, d, dt=dt), rnd(b, hkv, sk, d, dt=dt),
                           rnd(b, hkv, sk, dv, dt=dt))
            got = FA.flash_attention_cuda(q, k, v, **kw)
            # over ~1500 keys an output is ~0.05: held relative to max|want|
            compare(name, got, FA.flash_attention_plain(q, k, v, **kw),
                    F32_TOL if dt == f32 else BF16_TOL, main,
                    scale="rel" if sk >= 1000 else "abs")
            if "masked" in name:
                check(bool((got[:, :, :5] == 0).all()), f"{name}: masked rows "
                      "not 0")
            if main or bitwise:
                # no atomics, no split over keys: the same bits every launch
                check(torch.equal(got, FA.flash_attention_cuda(q, k, v, **kw)),
                      f"{name}: two launches differ")
                print(f"   {name}: two launches bitwise equal")

    run_flash(flash_cases, rnd)
    x = rnd(3, 21, 4, 32)
    kt, vt = rnd(3, 21, 2, 32).transpose(1, 2), rnd(3, 21, 2, 32).transpose(1, 2)
    compare("flash strided views", FA.flash_attention_cuda(x.transpose(1, 2),
                                                           kt, vt),
            FA.flash_attention_plain(x.transpose(1, 2), kt, vt), F32_TOL)
    # bf16 rows go in 16-byte copies: a view whose strides are not
    # multiples of 8 elements is refused before any launch
    qo = rnd(2, 21, 4, 132, dt=bf)[..., :128].transpose(1, 2)
    ko = rnd(2, 21, 2, 128, dt=bf).transpose(1, 2)
    try:
        FA.flash_attention_cuda(qo, ko, ko)
    except ValueError as e:
        print(f"   flash bf16 stride {qo.stride()}: refused ({e})")
    else:
        raise SmokeFailure("flash: a bf16 view with a stride that is not a "
                           "multiple of 8 was not refused")

    decode_cases = [
        ("decode main", (56, 32, 8, S, 128, 128), None, {}, bf,
         "decode_attention"),
        ("decode ragged f32", (3, 4, 2, 70, 32, 32), [10, 70, 33], {},
         torch.float32, None),
        ("decode window+softcap", (2, 8, 4, 96, 64, 64), [40, 96],
         dict(window=16, softcap=50.0), torch.float32, None),
        ("decode empty row g=16", (2, 16, 1, 40, 64, 32), [0, 40], {},
         torch.float32, None),
        ("decode d=256 bf16", (1, 4, 4, 300, 256, 256), [123], {}, bf, None),
        ("decode g=6 window f32", (2, 12, 2, 90, 64, 128), [90, 33],
         dict(window=20), torch.float32, None),
        ("decode long bf16", (2, 32, 8, 4000, 128, 128), [4000, 3001], {}, bf,
         None),
        ("decode long f32 window+softcap", (2, 32, 8, 4000, 128, 128),
         [4000, 3001], dict(window=1000, softcap=30.0), torch.float32, None),
        # a warp with several chunks and more than one pass of 4 heads
        # (the second pass copies its first chunk again), and f32 d = dv =
        # 256, the largest K/V buffer, over several chunks a warp
        ("decode g=8 300 keys f32", (2, 16, 2, 300, 128, 128), [300, 259],
         {}, torch.float32, None),
        ("decode d=256 f32", (2, 4, 4, 300, 256, 256), [300, 190], {},
         torch.float32, None),
    ]
    def run_decode(cases, rnd, gen, bitwise=False):
        for name, (b, hq, hkv, S_, d, dv), lens, kw, dt, main in cases:
            q = rnd(b, hq, 1, d, dt=dt)
            kc, vc = rnd(b, hkv, S_, d, dt=dt), rnd(b, hkv, S_, dv, dt=dt)
            if lens is None:
                lens_t = torch.randint(L + 1, S_ + 1, (b,), generator=gen,
                                       device=dev, dtype=torch.int32)
            else:
                lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = DA.decode_attention_cuda(q, kc, vc, lens_t, **kw)
            # over ~4000 keys an output is ~0.03: the long cases are held
            # relative to max|want|, so a skipped stage of keys would not pass
            compare(name, got,
                    DA.decode_attention_plain(q, kc, vc, lens_t, **kw),
                    F32_TOL if dt == torch.float32 else BF16_TOL, main,
                    scale="rel" if "long" in name else "abs")
            if lens is not None and 0 in lens:
                check(bool((got[lens.index(0)] == 0).all()),
                      f"{name}: empty row not 0")
            if bitwise and not main:
                check(torch.equal(got, DA.decode_attention_cuda(
                    q, kc, vc, lens_t, **kw)), f"{name}: two launches differ")
                print(f"   {name}: two launches bitwise equal")
            if not main:
                continue
            # no atomics: the same bits every launch
            check(torch.equal(got, DA.decode_attention_cuda(q, kc, vc, lens_t,
                                                            **kw)),
                  f"{name}: two launches differ")
            # a row's bits depend on its keys and length, not on the cache's
            # depth: the same keys in a cache 37 deeper, garbage behind them
            deep_k, deep_v = rnd(b, hkv, S_ + 37, d, dt=dt), \
                rnd(b, hkv, S_ + 37, dv, dt=dt)
            deep_k[:, :, :S_], deep_v[:, :, :S_] = kc, vc
            check(torch.equal(got, DA.decode_attention_cuda(q, deep_k, deep_v,
                                                            lens_t, **kw)),
                  f"{name}: depth {S_} and {S_ + 37} differ")
            # rows that do not start on 16 bytes (a view of a wider cache) are
            # copied element by element into the same layout: the same bits
            wide_k, wide_v = rnd(b, hkv, S_, d + 4, dt=dt), \
                rnd(b, hkv, S_, dv + 4, dt=dt)
            wide_k[..., :d], wide_v[..., :dv] = kc, vc
            check(torch.equal(got, DA.decode_attention_cuda(
                q, wide_k[..., :d], wide_v[..., :dv], lens_t, **kw)),
                f"{name}: a view with row stride {d + 4} differs")
            print(f"   {name}: two launches bitwise equal; depth {S_} and "
                  f"{S_ + 37} bitwise equal; row stride {d + 4} view bitwise "
                  "equal")

    run_decode(decode_cases, rnd, gen)
    for name, (nq, na, d, k), main in [
            ("topk main", (N_QUERIES, N_ANCHORS, 32, K_ANCHORS),
             "topk_retrieval"),
            ("topk multi-chunk k=64", (37, 3001, 24, 64), None),
            ("topk k=n", (1, 64, 32, 64), None)]:
        qq, aa = rnd(nq, d), rnd(na, d)
        s1, i1 = TK.topk_retrieval_cuda(qq, aa, k)
        s2, i2 = TK.topk_retrieval_plain(qq, aa, k)
        compare(name, s1, s2, TOPK_TOL, main)
        check(torch.equal(i1, i2), f"{name}: indices differ")
    # exact ties: one-hot rows give exactly equal similarities
    aa = torch.zeros(300, 32, device=dev)
    aa[torch.arange(300), torch.arange(300) % 32] = 1.0
    qq = torch.zeros(7, 32, device=dev)
    qq[torch.arange(7), torch.arange(7) * 3] = 1.0
    qq[0, 5] = 1.0
    s1, i1 = TK.topk_retrieval_cuda(qq, aa, 12, anchors_prenormalized=True)
    s2, i2 = TK.topk_retrieval_plain(qq, aa, 12, anchors_prenormalized=True)
    compare("topk exact ties", s1, s2, TOPK_TOL)
    check(torch.equal(i1, i2), "topk ties: indices differ")

    # paged decode: (b, hq, hkv, S = kv_cap, d, dv, page, lens, softcap, dtype)
    kv_cap = L + NEW_TOKENS
    paged_cases = [
        ("paged main", (16, 32, 8, kv_cap, 128, 128, PAGE, None, 0.0, bf),
         "paged_decode_attention"),
        ("paged f32 page 8 ragged clipped", (3, 4, 2, 70, 32, 32, 8,
                                             [10, 70, 33], 0.0, torch.float32),
         None),
        ("paged f32 page 32 softcap", (2, 8, 4, 96, 64, 64, 32, [40, 96],
                                       50.0, torch.float32), None),
        ("paged bf16 page 32 softcap", (2, 8, 4, 96, 64, 64, 32, [41, 90],
                                        30.0, bf), None),
        ("paged g=16 empty row dv=32", (2, 16, 1, 40, 64, 32, 16, [0, 40],
                                        0.0, torch.float32), None),
        ("paged kv_cap < W*page", (2, 4, 2, 50, 32, 32, 16, [50, 17], 0.0,
                                   torch.float32), None),
        ("paged d=256 bf16", (1, 4, 4, 300, 256, 256, 16, [123], 0.0, bf),
         None),
        # ~4000 keys: 63 chunks a warp, the stage loop
        ("paged long bf16", (2, 32, 8, 4000, 128, 128, PAGE, [4000, 3001],
                             0.0, bf), None),
        ("paged long f32", (2, 32, 8, 4000, 128, 128, PAGE, [4000, 3001],
                            0.0, torch.float32), None),
        ("paged g=8 300 keys f32", (2, 16, 2, 300, 128, 128, 16, [300, 259],
                                    0.0, torch.float32), None),
        ("paged d=256 f32", (2, 4, 4, 300, 256, 256, 16, [300, 190], 0.0,
                             torch.float32), None),
    ]
    def run_paged(cases, rnd, gen, bitwise=False):
        for name, (b, hq, hkv, S_, d, dv, page, lens, cap, dt), main in \
                cases:
            q = rnd(b, hq, 1, d, dt=dt)
            kc, vc, kp, vp, table = paged_layout(torch, gen, b, hkv, S_, d, dv,
                                                 page, dt)
            if lens is None:
                lens_t = torch.randint(L + 1, S_ + 1, (b,), generator=gen,
                                       device=dev, dtype=torch.int32)
            else:
                lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            kw = dict(page_size=page, kv_cap=S_, softcap=cap)
            got = DA.paged_decode_attention_cuda(q, kp, vp, lens_t, table,
                                                 **kw)
            compare(name, got, DA.paged_decode_attention_plain(
                q, kp, vp, lens_t, table, **kw),
                F32_TOL if dt == torch.float32 else BF16_TOL, main,
                scale="rel" if "long" in name else "abs")
            # the dense kernel on the same logical cache: same chunks, same
            # bits
            dense = DA.decode_attention_cuda(q, kc, vc, lens_t, softcap=cap)
            check(torch.equal(got, dense), f"{name}: paged and dense kernels "
                  "differ on the same logical cache")
            if lens is not None and 0 in lens:
                check(bool((got[lens.index(0)] == 0).all()), "empty row not 0")
            # poison the trash page and every unreferenced page: not one bit
            # of the output may move
            unref = torch.ones(kp.shape[0], dtype=torch.bool, device=dev)
            unref[table.reshape(-1).long()] = False
            kp2, vp2 = kp.clone(), vp.clone()
            kp2[unref], vp2[unref] = 1e9, 1e9
            poisoned = DA.paged_decode_attention_cuda(q, kp2, vp2, lens_t,
                                                      table, **kw)
            check(torch.equal(poisoned, got), f"{name}: poisoned pages leak")
            if main or bitwise:
                check(torch.equal(got, DA.paged_decode_attention_cuda(
                    q, kp, vp, lens_t, table, **kw)),
                    f"{name}: two launches differ")
                print(f"   {name}: two launches bitwise equal")
    run_paged(paged_cases, rnd, gen)
    print("   paged == dense kernel bit for bit; poisoned pages inert")

    # SSD scan: the main path's shape (mamba2-1.3b's prefill of 56 prompts
    # of L tokens: one chunk of L, x a head-split slice of the conv output
    # as mamba_full passes it) in bf16 and in f32, then float32 edge shapes
    # — the reference's SSD_CASES, chunks 1 / 7 / 24 / 128, nc >= 2, n 4 to
    # 128.  Kernel and f32 plain version sum in f32 in different orders, so
    # each is held element by element to the plain version run in float64
    # on the same values, within tol x max(1, |witness|): 2e-5 for f32 y
    # and every state, 3e-2 for bf16 y (|y| reaches ~50 there, where one
    # bf16 step is 0.25)
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models.ssm import _largest_chunk
    main_chunk = _largest_chunk(L, 128)
    def run_ssd(cases, gen):
        for name, (b, l, h, p, n, chunk), dtn, dts, main, strided in cases:
            dt = getattr(torch, dtn)
            l, chunk = l or L, chunk or main_chunk
            x, dtv, A, B, C = ssd_inputs(torch, gen, b, l, h, p, n, dts, dt,
                                         conv_layout=strided)
            got = SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=chunk)
            plain = ref.ssd(x, dtv, A, B, C, chunk=chunk)
            yw, sw = ref.ssd(*(t.double() for t in (x, dtv, A, B, C)),
                             chunk=chunk)
            y_tol = F32_TOL if dt == torch.float32 else BF16_TOL
            for side, (y, st) in (("kernel", got), ("plain", plain)):
                compare(f"{name} {side} y", y, yw, y_tol,
                        main if side == "kernel" else None, scale="each")
                compare(f"{name} {side} state", st, sw, F32_TOL, scale="each")
            if main:
                y2, s2 = SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=chunk)
                check(torch.equal(got[0], y2) and torch.equal(got[1], s2),
                      f"{name}: two launches differ")
                print(f"   {name}: two launches bitwise equal")
    run_ssd(SSD_CASES, gen)
    # B and C strided too (at an f32 model dtype mamba_full passes them as
    # slices of the conv output; at bf16 they are float32 copies)
    wide = rnd(2, 49, 3 * 16 + 40)
    x = wide[..., :48].reshape(2, 49, 3, 16)
    _, dtv, A, _, _ = ssd_inputs(torch, gen, 2, 49, 3, 16, 8, 0.1,
                                 torch.float32)
    bc = rnd(2, 49, 40) * 0.5
    B, C = bc[..., :8], bc[..., 8:16]
    y, st = SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=7)
    yp, sp = ref.ssd(x, dtv, A, B, C, chunk=7)
    compare("ssd strided y", y, yp, F32_TOL)
    compare("ssd strided state", st, sp, F32_TOL)
    step_checks(torch, gen, L, main_chunk, compare,
                [("step main", (56, 64, 64, 128, 48, 17), "ssd_decode_step")])
    bwd_checks(torch, rnd, compare, s_train)

    # zamba2-7b's kernels at its shapes, on inputs of a generator of their
    # own (rnd draws from it too), so the cases above keep their inputs
    gen = torch.Generator(device=dev).manual_seed(112)
    hybrid_flash = [
        # zamba2-7b's shared attention: 32 heads of 112, group 1, its
        # prefill of 56 prompts of L tokens in bf16 (the serve's) and f32,
        # then a ragged tile (70 tokens), window and softcap, fully masked
        # rows, sk != sq with an offset, 200 tokens
        ("flash d112 main", (56, 32, 32, L, L, 112, 112), {}, bf,
         "flash_attention" + HYBRID, "model"),
        ("flash d112 main f32", (56, 32, 32, L, L, 112, 112), {}, f32,
         "flash_attention" + HYBRID + " f32", "model"),
        ("flash d112 ragged window+softcap", (2, 4, 4, 70, 70, 112, 112),
         dict(window=16, softcap=30.0), bf, None, "model"),
        ("flash d112 f32 ragged window+softcap", (2, 4, 4, 70, 70, 112, 112),
         dict(window=16, softcap=30.0), f32, None, "model"),
        ("flash d112 fully masked rows", (1, 4, 4, 20, 20, 112, 112),
         dict(q_offset=-5), bf, None, "model"),
        ("flash d112 sk!=sq window offset", (2, 4, 4, 70, 130, 112, 112),
         dict(causal=False, window=40, q_offset=60), bf, None, "heads"),
        ("flash d112 s=200", (2, 8, 8, 200, 200, 112, 112), {}, bf, None,
         "model"),
    ]
    hybrid_decode = [
        # zamba2-7b's decode: 32 kv-heads of 112, group 1, the serve's
        # last step over ragged lengths in bf16 and f32, then a window and
        # softcap, several chunks a warp, an empty row
        ("decode d112 main", (56, 32, 32, S, 112, 112), None, {}, bf,
         "decode_attention" + HYBRID),
        ("decode d112 main f32", (56, 32, 32, S, 112, 112), None, {},
         torch.float32, "decode_attention" + HYBRID + " f32"),
        ("decode d112 window+softcap f32", (3, 4, 4, 70, 112, 112),
         [10, 70, 33], dict(window=16, softcap=50.0), torch.float32, None),
        ("decode d112 300 keys bf16", (2, 4, 4, 300, 112, 112), [300, 190],
         {}, bf, None),
        ("decode d112 empty row f32", (2, 4, 4, 40, 112, 112), [0, 40], {},
         torch.float32, None),
    ]
    hybrid_paged = [
        # head dim 112 (the body the dense kernel runs; zamba2 itself never
        # pages, its mamba states have no paged layout)
        ("paged d112 bf16", (4, 32, 32, kv_cap, 112, 112, PAGE, None, 0.0,
                             bf), None),
        ("paged d112 f32 ragged", (3, 4, 4, 70, 112, 112, 16, [10, 70, 33],
                                   0.0, torch.float32), None),
    ]
    run_flash(hybrid_flash, rnd)
    run_decode(hybrid_decode, rnd, gen)
    run_paged(hybrid_paged, rnd, gen)
    run_ssd(HYBRID_SSD_CASES, gen)
    step_checks(torch, gen, L, main_chunk, compare,
                [("step zamba2", (56, 112, 64, 64, 81, 40),
                  "ssd_decode_step" + HYBRID)], edges=False)
    # zamba2-7b's tied block trains: the flash backward at head dim 112,
    # group 1 (its SFT shape, ragged tiles, window and softcap, masked
    # rows, several tiles, non-causal sk != sq)
    bwd_checks(torch, rnd, compare, s_train, [
        ("bwd d112 main", (64, 32, 32, s_train, s_train, 112, 112), {}, bf,
         "flash_attention_bwd" + HYBRID),
        ("bwd d112 f32", (2, 32, 32, s_train, s_train, 112, 112), {}, f32,
         None),
        ("bwd d112 ragged window+softcap", (2, 4, 4, 70, 70, 112, 112),
         dict(window=16, softcap=30.0), bf, None),
        ("bwd d112 f32 ragged window+softcap", (2, 4, 4, 70, 70, 112, 112),
         dict(window=16, softcap=30.0), f32, None),
        ("bwd d112 masked rows", (1, 4, 4, 20, 20, 112, 112),
         dict(q_offset=-5), bf, None),
        ("bwd d112 f32 masked rows", (1, 4, 4, 20, 20, 112, 112),
         dict(q_offset=-5), f32, None),
        ("bwd d112 s=200", (2, 8, 8, 200, 200, 112, 112), {}, bf, None),
        ("bwd d112 sk!=sq non-causal", (2, 4, 4, 33, 100, 112, 112),
         dict(causal=False), bf, None),
    ])
    ssd_bwd_checks(torch, compare, s_train)

    # the dense families' kernels at their shapes, on inputs of a generator
    # of their own (rnd draws from it too), so the cases above keep theirs:
    # starcoder2-3b's GQA group 12 (24 heads on 2 kv-heads of 128; the
    # decode body's 4-head passes three times over), internlm2-1.8b's
    # group 2, gemma2-9b's heads of 256 with its softcap of 50 and windows
    # shorter than the keys
    gen = torch.Generator(device=dev).manual_seed(23)
    run_flash([
        ("flash g12 main", (56, 24, 2, L, L, 128, 128), {}, bf,
         "flash_attention@starcoder2-3b", "model"),
        ("flash g12 f32", (2, 24, 2, L, L, 128, 128), {}, f32, None,
         "model"),
        ("flash g12 s=200 window+softcap", (2, 24, 2, 200, 200, 128, 128),
         dict(window=64, softcap=50.0), bf, None, "model"),
        ("flash gemma2-9b main softcap", (56, 16, 8, L, L, 256, 256),
         dict(softcap=50.0), bf, "flash_attention@gemma2-9b", "model"),
        ("flash gemma2-9b local softcap", (56, 16, 8, L, L, 256, 256),
         dict(window=4096, softcap=50.0), bf, None, "model"),
        ("flash gemma2-9b window 16 softcap", (4, 16, 8, L, L, 256, 256),
         dict(window=16, softcap=50.0), bf, None, "model"),
        ("flash gemma2-9b f32 window 16 softcap", (2, 16, 8, L, L, 256, 256),
         dict(window=16, softcap=50.0), f32, None, "model"),
        ("flash gemma2-9b s=200 window 40 softcap", (2, 16, 8, 200, 200, 256,
                                                     256),
         dict(window=40, softcap=50.0), bf, None, "model"),
    ], rnd)
    run_decode([
        ("decode g12 main", (56, 24, 2, S, 128, 128), None, {}, bf,
         "decode_attention@starcoder2-3b"),
        ("decode g12 f32 ragged", (3, 24, 2, 70, 128, 128), [10, 70, 33], {},
         torch.float32, None),
        ("decode g12 300 keys window+softcap", (2, 24, 2, 300, 128, 128),
         [300, 190], dict(window=40, softcap=50.0), bf, None),
        ("decode g2 main", (56, 16, 8, S, 128, 128), None, {}, bf,
         "decode_attention@internlm2-1.8b"),
        ("decode gemma2-9b main softcap", (56, 16, 8, S, 256, 256), None,
         dict(softcap=50.0), bf, "decode_attention@gemma2-9b"),
        ("decode gemma2-9b window 20 softcap f32", (3, 16, 8, 90, 256, 256),
         [90, 33, 61], dict(window=20, softcap=50.0), torch.float32, None),
        ("decode gemma2-9b 300 keys window 64 softcap",
         (2, 16, 8, 300, 256, 256), [300, 190], dict(window=64,
                                                     softcap=50.0), bf, None),
    ], rnd, gen)
    run_paged([
        ("paged g12 bf16", (16, 24, 2, kv_cap, 128, 128, PAGE, None, 0.0, bf),
         None),
        ("paged g12 f32 ragged", (3, 24, 2, 70, 128, 128, 16, [10, 70, 33],
                                  0.0, torch.float32), None),
        ("paged g2 bf16", (16, 16, 8, kv_cap, 128, 128, PAGE, None, 0.0, bf),
         None),
    ], rnd, gen)
    ring_checks(torch, rnd, compare)

    # the multimodal families' kernels at their shapes, on inputs of a
    # generator of their own (rnd draws from it too), so the cases above
    # keep theirs: qwen2-vl-7b's GQA group 7 (28 heads on 4 kv-heads of
    # 128: its serve, its image prefill of 320 tokens, its dense and paged
    # decode) and whisper-medium's heads of 64 at group 1 (the decoder's
    # causal self-attention and decode, the encoder non-causal over 1500
    # frames, the cross-attention non-causal over them at a prompt and at
    # sq = 1, all as the model's transposed views)
    gen = torch.Generator(device=dev).manual_seed(25)
    run_flash([
        ("flash g7 main", (56, 28, 4, L, L, 128, 128), {}, bf,
         "flash_attention" + VLM, "model"),
        ("flash g7 image prefill s=320", (VLM_ROWS, 28, 4, 320, 320, 128, 128),
         {}, bf, "flash_attention" + VLM + "/image", "model"),
        ("flash g7 f32", (2, 28, 4, L, L, 128, 128), {}, f32, None, "model"),
        ("flash whisper self main", (56, 16, 16, L, L, 64, 64), {}, bf,
         "flash_attention" + AUDIO, "model"),
        ("flash whisper encoder s=1500", (56, 16, 16, 1500, 1500, 64, 64),
         dict(causal=False), bf, "flash_attention" + AUDIO + "/encoder",
         "model"),
        ("flash whisper cross", (56, 16, 16, L, 1500, 64, 64),
         dict(causal=False), bf, "flash_attention" + AUDIO + "/cross",
         "model"),
        ("flash whisper encoder s=1500 b=4", (4, 16, 16, 1500, 1500, 64, 64),
         dict(causal=False), bf, None, "model"),
        ("flash whisper cross b=8", (8, 16, 16, L, 1500, 64, 64),
         dict(causal=False), bf, None, "model"),
        ("flash whisper cross sq=1", (56, 16, 16, 1, 1500, 64, 64),
         dict(causal=False), bf, "flash_attention" + AUDIO + "/cross-sq1",
         "model"),
        ("flash whisper cross f32", (2, 16, 16, L, 1500, 64, 64),
         dict(causal=False), f32, None, "model"),
        ("flash whisper cross sq=1 f32", (3, 16, 16, 1, 1500, 64, 64),
         dict(causal=False), f32, None, "model"),
    ], rnd)
    run_decode([
        ("decode g7 main", (56, 28, 4, S, 128, 128), None, {}, bf,
         "decode_attention" + VLM),
        ("decode g7 f32 ragged", (3, 28, 4, 70, 128, 128), [10, 70, 33], {},
         torch.float32, None),
        ("decode whisper main", (56, 16, 16, S, 64, 64), None, {}, bf,
         "decode_attention" + AUDIO),
        ("decode whisper f32 ragged", (3, 16, 16, 70, 64, 64), [10, 70, 33],
         {}, torch.float32, None),
        # the dense decode over every encoder frame, the sq = 1
        # cross-attention's function (timed beside it as a finding only)
        ("decode whisper long 1500 keys", (8, 16, 16, 1500, 64, 64),
         [1500] * 8,
         {}, bf, None),
    ], rnd, gen)
    run_paged([
        ("paged g7 main", (56, 28, 4, kv_cap, 128, 128, PAGE, None, 0.0, bf),
         "paged_decode_attention" + VLM),
        ("paged g7 f32 ragged", (3, 28, 4, 70, 128, 128, 16, [10, 70, 33],
                                 0.0, torch.float32), None),
    ], rnd, gen)

    # the MoE families' attention at their shapes, on inputs of a generator
    # of their own (rnd draws from it too), so the cases above keep theirs;
    # every case's two launches bitwise equal.  deepseek-v2-lite-16b's MLA
    # prefill: q / k of nope 128 + rope 64 = 192, v 128, 16 heads at g 1,
    # the scale (nope + rope) ** -0.5 passed as mla_full passes it (causal
    # at the serve's 56 x L, a q_offset case, non-causal sk != sq; the f32
    # body too), and its reduced config's 48 / 32 (f32, which the CPU
    # tests' configs run, and bf16); qwen3-moe-235b-a22b's GQA group 16 (64
    # heads on 4 kv-heads of 128): flash, dense and paged decode
    gen = torch.Generator(device=dev).manual_seed(27)
    mla = dict(scale=192 ** -0.5)
    run_flash([
        ("flash mla 192/128 main", (56, 16, 16, L, L, 192, 128), mla, bf,
         "flash_attention" + MLA, "model"),
        ("flash mla 192/128 q_offset", (4, 16, 16, 20, L, 192, 128),
         dict(mla, q_offset=L - 20), bf, None, "model"),
        ("flash mla 192/128 masked rows", (2, 16, 16, 20, 20, 192, 128),
         dict(mla, q_offset=-5), bf, None, "model"),
        ("flash mla 192/128 non-causal sk!=sq", (2, 16, 16, 33, 70, 192,
                                                 128),
         dict(mla, causal=False), bf, None, "model"),
        ("flash mla 192/128 s=200", (2, 16, 16, 200, 200, 192, 128), mla, bf,
         None, "model"),
        ("flash mla 192/128 f32", (2, 16, 16, L, L, 192, 128), mla, f32,
         None, "model"),
        ("flash mla 48/32 f32", (3, 4, 4, L, L, 48, 32),
         dict(scale=48 ** -0.5), f32, None, "model"),
        ("flash mla 48/32 f32 non-causal sk!=sq", (2, 4, 4, 33, 70, 48, 32),
         dict(scale=48 ** -0.5, causal=False), f32, None, "model"),
        ("flash mla 48/32 f32 masked rows", (1, 4, 4, 20, 20, 48, 32),
         dict(scale=48 ** -0.5, q_offset=-5), f32, None, "model"),
        ("flash mla 48/32 bf16", (3, 4, 4, L, L, 48, 32),
         dict(scale=48 ** -0.5), bf, None, "model"),
        ("flash g16 main", (56, 64, 4, L, L, 128, 128), {}, bf,
         "flash_attention" + MOE_Q, "model"),
        ("flash g16 f32", (2, 64, 4, L, L, 128, 128), {}, f32, None,
         "model"),
        ("flash g16 s=200", (2, 64, 4, 200, 200, 128, 128), {}, bf, None,
         "model"),
    ], rnd, bitwise=True)
    run_decode([
        ("decode g16 main", (56, 64, 4, S, 128, 128), None, {}, bf,
         "decode_attention" + MOE_Q),
        ("decode g16 f32 ragged", (3, 64, 4, 70, 128, 128), [10, 70, 33], {},
         torch.float32, None),
        ("decode g16 300 keys", (2, 64, 4, 300, 128, 128), [300, 190], {},
         bf, None),
    ], rnd, gen, bitwise=True)
    run_paged([
        ("paged g16 main", (56, 64, 4, kv_cap, 128, 128, PAGE, None, 0.0, bf),
         "paged_decode_attention" + MOE_Q),
        ("paged g16 f32 ragged", (3, 64, 4, 70, 128, 128, 16, [10, 70, 33],
                                  0.0, torch.float32), None),
    ], rnd, gen, bitwise=True)
    # the training families' flash backward at their shapes, on a
    # generator of its own (rnd draws from it too), every case's two
    # launches bitwise equal: MLA's (192, 128) at deepseek-v2-lite-16b's
    # SFT shape (16 heads at g 1, the scale (nope + rope) ** -0.5 as
    # mla_full passes it) with masked rows, several tiles, non-causal sk !=
    # sq and the f32 body, and its reduced config's (48, 32) in both bodies;
    # gemma2-9b's heads of 256 with softcap 50 (and a window),
    # qwen3-moe-235b-a22b's g 16, starcoder2-3b's g 12, qwen2-vl-7b's g 7
    # over the image's patches and the text, whisper-medium's encoder
    # (non-causal over 1500 frames, at its SFT batch) and its
    # cross-attention; and the small configs' f32 shapes (heads of 32 at g
    # 12 and g 7, whisper's 64 over 32 frames)
    gen = torch.Generator(device=dev).manual_seed(29)
    family_bwd_checks(torch, rnd, compare, s_train)
    # deepseek-v2-lite-16b's MLA prefill at the heads one rank of a (1, 4)
    # mesh computes (4 of 16, q / k 192, v 128, its scale), on a generator
    # of its own; two launches bitwise equal
    gen = torch.Generator(device=dev).manual_seed(34)
    run_flash([("flash mla 192/128 tp4 heads", (56, 4, 4, L, L, 192, 128),
                mla, bf, None, "model")], rnd, bitwise=True)
    # whisper-medium's attention at the heads one rank of a (1, 4) mesh
    # computes (4 of 16 heads of 64, g 1): the encoder over its 1500
    # frames, the decoder's causal self-attention, the cross-attention at
    # the prompts and at sq = 1 (non-causal), the dense decode, the flash
    # backward over the encoder (its SFT batch) and the cross-attention;
    # on a generator of its own, every case's two launches bitwise equal
    gen = torch.Generator(device=dev).manual_seed(37)
    enc = dict(causal=False)
    run_flash([
        ("flash whisper encoder tp4 heads", (56, 4, 4, ENC_FRAMES,
                                             ENC_FRAMES, 64, 64), enc, bf,
         None, "model"),
        ("flash whisper self tp4 heads", (56, 4, 4, L, L, 64, 64), {}, bf,
         None, "model"),
        ("flash whisper cross tp4 heads", (56, 4, 4, L, ENC_FRAMES, 64, 64),
         enc, bf, None, "model"),
        ("flash whisper cross sq=1 tp4 heads", (56, 4, 4, 1, ENC_FRAMES, 64,
                                                64), enc, bf, None, "model"),
    ], rnd, bitwise=True)
    run_decode([("decode whisper tp4 heads", (56, 4, 4, S, 64, 64), None,
                 {}, bf, None)], rnd, gen, bitwise=True)
    bwd_checks(torch, rnd, compare, s_train, [
        ("bwd whisper encoder tp4 heads", (FAMILY_TRAIN[AUDIO[1:]][2], 4, 4,
                                           ENC_FRAMES, ENC_FRAMES, 64, 64),
         enc, bf, None),
        ("bwd whisper cross tp4 heads", (FAMILY_TRAIN[AUDIO[1:]][2], 4, 4,
                                         s_train, ENC_FRAMES, 64, 64), enc,
         bf, None),
    ])
    return errs


def ring_checks(torch, rnd, compare):
    """The ring-buffer decode's call: a windowed layer's cache of exactly
    ``window`` slots, the key of position p in slot p % window, attended
    with no window mask over ``min(pos + 1, window)`` slots.  Kernel against
    its plain version, against the windowed plain attention over the whole
    history (the same keys in position order), and two launches bitwise
    equal; gemma2-9b's heads of 256 and softcap, rows short of the window,
    at it, and past it."""
    from repro_torch.kernels import decode_attention as DA
    W, d, hq, hkv, cap = 16, 256, 16, 8, 50.0
    pos = torch.tensor([3, 15, 16, 40], dtype=torch.int32, device="cuda")
    b, depth = pos.numel(), int(pos.max()) + 1
    for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        name = f"decode ring d256 softcap {str(dt)[6:]}"
        full_k, full_v = rnd(b, hkv, depth, d, dt=dt), rnd(b, hkv, depth, d,
                                                           dt=dt)
        ring_k = torch.zeros(b, hkv, W, d, dtype=dt, device="cuda")
        ring_v = torch.zeros_like(ring_k)
        for i, p in enumerate(pos.tolist()):
            keep = torch.arange(max(0, p - W + 1), p + 1, device="cuda")
            ring_k[i, :, keep % W] = full_k[i, :, keep]
            ring_v[i, :, keep % W] = full_v[i, :, keep]
        q = rnd(b, hq, 1, d, dt=dt)
        lens = torch.clamp(pos + 1, max=W)
        got = DA.decode_attention_cuda(q, ring_k, ring_v, lens, softcap=cap)
        compare(name, got, DA.decode_attention_plain(
            q, ring_k, ring_v, lens, softcap=cap), tol)
        compare(f"{name} vs the windowed history", got,
                DA.decode_attention_plain(q, full_k, full_v, pos + 1,
                                          window=W, softcap=cap), tol)
        check(torch.equal(got, DA.decode_attention_cuda(
            q, ring_k, ring_v, lens, softcap=cap)),
            f"{name}: two launches differ")
        print(f"   {name}: two launches bitwise equal")


def ssd_bwd_checks(torch, compare, s_train: int):
    """The SSD scan backward kernel, through ``ssd_scan`` as a loss reaches
    it (x, dt, A, B, C requiring grad, so the call goes through the autograd
    Function ``SSDScan``: the scan saving its entering states, then the
    backward kernel), on inputs of a generator of its own.  Each of dx,
    d(dt), dA, dB and dC, and its plain version's (``ssd_scan_bwd_plain``),
    is held to the plain version run in float64 on the same values within
    tol x max(1, max|want|): 2e-5 with x in f32, 3e-2 with x in bf16 (dx
    and dA are bf16 there, and gradients reach ~1000), where the kernel's
    float32 outputs d(dt), dB and dC are held within ``SPLIT_TOL``, the
    limit of its split arithmetic's CPU emulation.  The main path's
    shapes are the SFT batches of mamba2-1.3b (64 x ``s_train`` tokens, 64
    heads of 64, state 128) and zamba2-7b (112 heads, state 64), x the
    conv output's strided slice.  Every case also: one scan and one
    backward launch, two backward launches bitwise equal and equal to the
    autograd path's, the forward's y and final state bitwise equal with and
    without the saved states."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models.ssm import _largest_chunk
    gen = torch.Generator(device="cuda").manual_seed(21)
    main_chunk = _largest_chunk(s_train, 128)
    parts = ("dx", "ddt", "dA", "dB", "dC")
    for name, (b, l, h, p, n, chunk), dtn, dts, conv, with_ds, main \
            in SSD_BWD_CASES:
        dt_ = getattr(torch, dtn)
        l, chunk = l or s_train, chunk or main_chunk
        x, dtv, A, B, C = ssd_inputs(torch, gen, b, l, h, p, n, dts, dt_,
                                     conv_layout=conv)
        dy = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dt_)
        ds = (torch.randn(b, h, p, n, generator=gen, device="cuda")
              if with_ds else None)
        leaves = [t.detach().requires_grad_(True) for t in (x, dtv, A, B, C)]
        before = (SS.launches, SS.bwd_launches)
        y, st = SS.ssd_scan(*leaves, chunk=chunk)
        outs, gouts = ([y, st], [dy, ds]) if with_ds else ([y], [dy])
        got = torch.autograd.grad(outs, leaves, gouts)
        check((SS.launches, SS.bwd_launches) == (before[0] + 1,
                                                 before[1] + 1),
              f"{name}: the scan and backward kernels did not run once each")
        wit = SS.ssd_scan_bwd_plain(
            *(t.double() for t in (x, dtv, A, B, C, dy)),
            None if ds is None else ds.double(), chunk=chunk)
        plain = SS.ssd_scan_bwd_plain(x, dtv, A, B, C, dy, ds, chunk=chunk)
        tol = F32_TOL if dt_ == torch.float32 else BF16_TOL
        for part, g, pl, w, inp in zip(parts, got, plain, wit,
                                       (x, dtv, A, B, C), strict=True):
            check(g.shape == inp.shape and g.dtype == inp.dtype
                  and pl.dtype == inp.dtype,
                  f"{name} {part}: {g.shape} {g.dtype} != {inp.shape} "
                  f"{inp.dtype}")
            compare(f"{name} {part} kernel", g, w,
                    SPLIT_TOL if tol == BF16_TOL and g.dtype == torch.float32
                    else tol, scale="max")
            compare(f"{name} {part} plain", pl, w, tol, scale="max")
        if main:
            compare.errs[main] = max(
                (g.double() - w).abs().max().item()
                for g, w in zip(got, wit, strict=True))
        with torch.no_grad():
            y0, s0 = SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=chunk)
            y1, s1, states = SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=chunk,
                                              save_states=True)
            one = SS.ssd_scan_bwd_cuda(x, dtv, A, B, C, dy, ds, states,
                                       chunk=chunk)
            two = SS.ssd_scan_bwd_cuda(x, dtv, A, B, C, dy, ds, states,
                                       chunk=chunk)
        torch.cuda.synchronize()
        check(torch.equal(y0, y1) and torch.equal(s0, s1),
              f"{name}: the forward's bits differ with the states saved")
        check(all(torch.equal(a, c) and torch.equal(a, g)
                  for a, c, g in zip(one, two, got, strict=True)),
              f"{name}: two backward launches differ, or differ from the "
              "autograd path")
        print(f"   {name}: two launches bitwise equal, = the autograd path; "
              f"forward bits equal with and without the saved states "
              f"({0 if states is None else states.shape[1]} saved)")


def bwd_checks(torch, rnd, compare, s_train: int, cases=None):
    """The flash backward kernel against autograd of the plain version on
    the card, through ``flash_attention`` as a loss reaches it (q, k, v the
    model's transposed views requiring grad, so the call goes through the
    autograd Function: the forward kernel saving each row's log-sum-exp,
    then the backward kernel).  dq, dk and dv each within tol x max(1,
    max|want|): gradients reach ~10, where one bf16 step is 0.06.  The main
    path's shape is the SFT batch: 64 sequences of ``s_train`` tokens, 32/8
    heads of 128, bf16, causal.  bf16 runs the tensor-core kernels (every
    mask and shape they take: several key and row tiles, groups 1 to 8, d
    32 to 256, dv != d, windows with either sign of q_offset, non-causal sk
    != sq, softcap), f32 the FMA kernels.  On the main case also: the saved
    log-sum-exp against the plain one and the forward's bits without and
    with it.  Every case's two launches are bitwise equal.  ``cases``
    replaces those cases (zamba2-7b's head dim 112; the training
    families' shapes)."""
    from repro_torch.kernels import flash_attention as FA
    bf, f32 = torch.bfloat16, torch.float32
    cases = cases or [
        ("bwd main", (64, 32, 8, s_train, s_train, 128, 128), {}, bf,
         "flash_attention_bwd"),
        ("bwd f32 d=32 g=2", (2, 4, 2, 17, 17, 32, 32), {}, f32, None),
        ("bwd f32 d=64 g=4 window", (2, 8, 2, 40, 40, 64, 64),
         dict(window=7), f32, None),
        ("bwd f32 d=128 g=1 q_offset", (1, 8, 8, 33, 50, 128, 128),
         dict(q_offset=17), f32, None),
        ("bwd f32 d=128 g=4 ragged", (3, 32, 8, 61, 61, 128, 128), {}, f32,
         None),
        ("bwd f32 dv!=d masked rows", (1, 4, 1, 20, 20, 64, 32),
         dict(q_offset=-5), f32, None),
        ("bwd f32 d=256 non-causal window offset", (2, 4, 2, 33, 50, 256,
                                                    256),
         dict(causal=False, window=9, q_offset=20), f32, None),
        ("bwd f32 window+softcap", (2, 8, 2, 40, 40, 64, 64),
         dict(window=16, softcap=30.0), f32, None),
        ("bwd bf16 g=1", (2, 8, 8, 45, 45, 128, 128), {}, bf, None),
        ("bwd bf16 window q_offset", (2, 8, 2, 40, 70, 64, 64),
         dict(window=16, q_offset=30), bf, None),
        # several 64-key dK/dV blocks, 32-row steps and 32-key dQ tiles,
        # a partial last of each
        ("bwd bf16 s=300 ragged", (2, 8, 2, 300, 300, 128, 128), {}, bf,
         None),
        ("bwd bf16 group 8", (2, 16, 2, s_train, s_train, 128, 128), {}, bf,
         None),
        ("bwd bf16 group 3", (2, 6, 2, 70, 70, 64, 64), {}, bf, None),
        ("bwd bf16 d=32", (2, 8, 2, 70, 70, 32, 32), {}, bf, None),
        # d + dv > 256: dK/dV columns split over 8 warps
        ("bwd bf16 d=256", (1, 4, 2, 100, 100, 256, 256), {}, bf, None),
        ("bwd bf16 dv!=d", (1, 8, 4, 40, 40, 64, 32), {}, bf, None),
        ("bwd bf16 d=32 dv=256", (1, 4, 1, 40, 40, 32, 256), {}, bf, None),
        ("bwd bf16 window negative q_offset", (2, 8, 2, 90, 90, 64, 64),
         dict(window=20, q_offset=-5), bf, None),
        ("bwd bf16 sk!=sq non-causal", (2, 4, 2, 33, 100, 64, 64),
         dict(causal=False), bf, None),
        ("bwd bf16 softcap", (2, 8, 2, s_train, s_train, 128, 128),
         dict(softcap=30.0), bf, None),
    ]
    for name, (b, hq, hkv, sq, sk, d, dv), kw, dt, main in cases:
        q = rnd(b, sq, hq, d, dt=dt).transpose(1, 2).requires_grad_(True)
        k = rnd(b, sk, hkv, d, dt=dt).transpose(1, 2).requires_grad_(True)
        v = rnd(b, sk, hkv, dv, dt=dt).transpose(1, 2).requires_grad_(True)
        dout = rnd(b, hq, sq, dv, dt=dt)
        before = (FA.launches, FA.bwd_launches)
        got = torch.autograd.grad(FA.flash_attention(q, k, v, **kw),
                                  (q, k, v), dout)
        check((FA.launches, FA.bwd_launches) == (before[0] + 1,
                                                 before[1] + 1),
              f"{name}: the forward and backward kernels did not run once "
              "each")
        again = torch.autograd.grad(FA.flash_attention(q, k, v, **kw),
                                    (q, k, v), dout)
        check(all(torch.equal(a, c) for a, c in zip(got, again, strict=True)),
              f"{name}: two launches differ")
        want = torch.autograd.grad(FA.flash_attention_plain(q, k, v, **kw),
                                   (q, k, v), dout)
        tol = F32_TOL if dt == f32 else BF16_TOL
        for part, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name} {part}: {g.shape} {g.dtype} != {w.shape} "
                  f"{w.dtype}")
            compare(f"{name} {part}", g, w, tol, None, scale="max")
        if kw.get("q_offset", 0) < 0:
            check(bool((got[0][:, :, :-kw["q_offset"]] == 0).all()),
                  f"{name}: rows with no key got a gradient")
        if not (main or "masked" in name):
            continue
        # the saved log-sum-exp: within 2e-5 x max(1, |want|) of the plain
        # one on every row with a key, +inf on a row without
        with torch.no_grad():
            out, lse = FA.flash_attention_cuda(q, k, v, return_lse=True,
                                               **kw)
            lse_want = FA.flash_lse_plain(q, k, v, **kw)
        empty = torch.isinf(lse_want)
        check(torch.equal(torch.isinf(lse), empty)
              and bool((lse[empty] > 0).all()),
              f"{name}: rows with no key do not save +inf")
        compare(f"{name} saved lse", lse[~empty], lse_want[~empty], F32_TOL,
                None, scale="each")
        if not main:
            continue
        compare.errs[main] = max((g.float() - w.float()).abs().max().item()
                                 for g, w in zip(got, want, strict=True))
        # the serve path's call (no log-sum-exp) writes the same output
        check(torch.equal(out, FA.flash_attention_cuda(q.detach(), k.detach(),
                                                       v.detach(), **kw)),
              f"{name}: the forward's output differs with the lse saved")
        print(f"   {name}: two launches bitwise equal; forward bits equal "
              "with and without the saved lse")


def family_bwd_checks(torch, rnd, compare, st: int):
    """The flash backward at the training families' shapes (``bwd_checks``
    on ``st``-token SFT sequences)."""
    bf, f32 = torch.bfloat16, torch.float32
    mla, mla48 = dict(scale=192 ** -0.5), dict(scale=48 ** -0.5)
    bwd_checks(torch, rnd, compare, st, [
        ("bwd mla 192/128 main", (SFT_BATCH, 16, 16, st, st, 192, 128), mla,
         bf, "flash_attention_bwd" + MLA),
        ("bwd mla 192/128 f32", (2, 16, 16, st, st, 192, 128), mla, f32,
         None),
        ("bwd mla 192/128 masked rows", (1, 4, 4, 20, 20, 192, 128),
         dict(mla, q_offset=-5), bf, None),
        ("bwd mla 192/128 f32 masked rows", (1, 4, 4, 20, 20, 192, 128),
         dict(mla, q_offset=-5), f32, None),
        ("bwd mla 192/128 s=200", (2, 4, 4, 200, 200, 192, 128), mla, bf,
         None),
        ("bwd mla 192/128 sk!=sq non-causal", (2, 4, 4, 33, 100, 192, 128),
         dict(mla, causal=False), bf, None),
        ("bwd mla 48/32 f32", (3, 4, 4, st, st, 48, 32), mla48, f32, None),
        ("bwd mla 48/32 bf16", (3, 4, 4, st, st, 48, 32), mla48, bf, None),
        ("bwd mla 48/32 f32 masked rows", (1, 4, 4, 20, 20, 48, 32),
         dict(mla48, q_offset=-5), f32, None),
        ("bwd mla 48/32 s=200 window", (2, 4, 4, 200, 200, 48, 32),
         dict(mla48, window=40), bf, None),
        ("bwd gemma2-9b main", (SFT_BATCH, 16, 8, st, st, 256, 256),
         dict(softcap=50.0), bf, "flash_attention_bwd@gemma2-9b"),
        ("bwd d256 window+softcap", (2, 4, 2, 100, 100, 256, 256),
         dict(window=16, softcap=50.0), bf, None),
        ("bwd g16 main", (SFT_BATCH, 64, 4, st, st, 128, 128), {}, bf,
         "flash_attention_bwd" + MOE_Q),
        ("bwd g12", (8, 24, 2, st, st, 128, 128), {}, bf, None),
        ("bwd g7 image + text", (4, 28, 4, VLM_PATCHES + st,
                                 VLM_PATCHES + st, 128, 128), {}, bf, None),
        ("bwd whisper encoder main", (FAMILY_TRAIN[AUDIO[1:]][2], 16, 16,
                                      ENC_FRAMES, ENC_FRAMES, 64, 64),
         dict(causal=False), bf, "flash_attention_bwd" + AUDIO + "/encoder"),
        ("bwd whisper cross", (8, 16, 16, st, ENC_FRAMES, 64, 64),
         dict(causal=False), bf, None),
        ("bwd whisper cross f32", (2, 4, 4, st, ENC_FRAMES, 64, 64),
         dict(causal=False), f32, None),
        ("bwd g12 d32 f32", (2, 24, 2, st, st, 32, 32), {}, f32, None),
        ("bwd g7 d32 f32", (2, 28, 4, 8 + st, 8 + st, 32, 32), {}, f32,
         None),
        ("bwd whisper small encoder f32", (2, 4, 4, 32, 32, 64, 64),
         dict(causal=False), f32, None),
    ])


def step_checks(torch, gen, L: int, main_chunk: int, compare, stacked,
                edges: bool = True):
    """The SSD decode step, in place.  Each of ``stacked`` — name, (b, h,
    p, n, depth, layer), the kernel whose max_abs_err it gives — is a main
    path's shape: mamba2-1.3b's decode of 56 rows on a (56, 64, 64, 128)
    f32 layer view of the full 48-layer stacked cache, or zamba2-7b's on a
    (56, 112, 64, 64) view of its 81-layer one, every other layer poisoned
    to 1e9 and checked untouched, 12 chained steps from the scan's final
    state on the main prompt, x, B and C slices of a conv-output row whose
    batch dim is the fastest and A in bf16, as mamba_decode passes them.
    Kernel and f32 plain version are each held element by element to the
    chain run in float64 from the same state, within 2e-5 x max(1,
    |witness|) (y of every step and the final state); two launches on the
    same inputs are bitwise equal.  Then, with ``edges``, edge shapes (n 8
    and 16, p 16, b 1, A in f32) with contiguous inputs, and one small one
    in the conv-output layout."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_decode_step as SD
    from repro_torch.kernels import ssd_scan as SS

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def step_inputs(b, h, p, n, conv=False):
        if conv:   # x (b, h, p), B, C (b, n): slices of (b, h p + 2 n)
            row = rnd(h * p + 2 * n, b).t() * 0.5     # batch dim fastest
            return (row[:, :h * p].reshape(b, h, p),
                    torch.nn.functional.softplus(rnd(b, h)),
                    row[:, h * p:h * p + n], row[:, h * p + n:])
        return (rnd(b, h, p) * 0.5, torch.nn.functional.softplus(rnd(b, h)),
                rnd(b, n) * 0.5, rnd(b, n) * 0.5)

    def chain(name, state, A, steps, main=None, conv=False):
        """``steps`` steps on ``state`` in place (kernel), on a copy (plain)
        and in float64 (witness)."""
        b, h, p, n = state.shape
        plain, wit = state.clone(), state.double()
        ys = {"kernel": [], "plain": [], "witness": []}
        for _ in range(steps):
            x, dt, B, C = step_inputs(b, h, p, n, conv)
            y, st = SD.ssd_decode_step_cuda(state, x, dt, A, B, C)
            check(st is state, f"{name}: the state is not updated in place")
            yp, plain = ref.ssd_decode_step(plain, x, dt, A, B, C)
            yw, wit = ref.ssd_decode_step(
                wit, *(t.double() for t in (x, dt, A, B, C)))
            for side, v in (("kernel", y), ("plain", yp), ("witness", yw)):
                ys[side].append(v)
        yw = torch.stack(ys["witness"])
        for side, st in (("kernel", state), ("plain", plain)):
            compare(f"{name} {side} y ({steps} steps)",
                    torch.stack(ys[side]), yw, F32_TOL,
                    main if side == "kernel" else None, scale="each")
            compare(f"{name} {side} state", st, wit, F32_TOL, scale="each")

    poison = 1e9
    for name, (b, h, p, n, depth, layer), main in stacked:
        x, dtv, A, B, C = ssd_inputs(torch, gen, b, L, h, p, n, 1.0,
                                     torch.bfloat16, conv_layout=True)
        _, s0 = SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=main_chunk)
        cache = torch.full((depth, b, h, p, n), poison, device="cuda")
        cache[layer] = s0
        chain(name, cache[layer], A, NEW_TOKENS, main=main, conv=True)
        check(bool((cache[:layer] == poison).all())
              and bool((cache[layer + 1:] == poison).all()),
              f"{name}: a layer other than the stepped one changed")
        print(f"   {name}: the other {depth - 1} layers of the stacked "
              "cache untouched")
        del cache
        x, dt, B, C = step_inputs(b, h, p, n, conv=True)
        s1, s2 = s0.clone(), s0.clone()
        y1, _ = SD.ssd_decode_step_cuda(s1, x, dt, A, B, C)
        y2, _ = SD.ssd_decode_step_cuda(s2, x, dt, A, B, C)
        torch.cuda.synchronize()
        check(torch.equal(y1, y2) and torch.equal(s1, s2),
              f"{name}: two launches differ")
        print(f"   {name}: two launches bitwise equal")
    if not edges:
        return
    for (b, h, p, n), steps in STEP_CASES:
        A = -torch.exp(rnd(h) * 0.3)
        chain(f"step b {b} h {h} p {p} n {n}", rnd(b, h, p, n) * 0.5, A,
              steps)
    chain("step conv-output slices", rnd(2, 5, 16, 16) * 0.5,
          -torch.exp(rnd(5) * 0.3), 4, conv=True)


def ssd_inputs(torch, gen, b, l, h, p, n, dt_scale, dtype,
               conv_layout: bool = False):
    """x (b, l, h, p) and A (h,) in ``dtype``, dt (b, l, h), B and C (b, l,
    n) float32, distributed as the reference's SSD tests draw them
    (``dt_scale`` 0.1) or as the model's random weights give them (1.0).
    With ``conv_layout`` x is the head-split slice of a (b, l, h p + 2 n)
    conv output, the strided view mamba_full passes."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    if conv_layout:
        x = (rnd(b, l, h * p + 2 * n) * 0.5).to(dtype)[..., :h * p]
        x = x.reshape(b, l, h, p)
    else:
        x = (rnd(b, l, h, p) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, l, h)) * dt_scale
    A = (-torch.exp(rnd(h) * 0.3)).to(dtype)
    return x, dt, A, rnd(b, l, n) * 0.5, rnd(b, l, n) * 0.5


def paged_layout(torch, gen, b, hkv, S, d, dv, page, dt, spare: int = 5):
    """Dense caches (b, hkv, S, d[v]) and the same keys in block-paged
    storage behind a permuted page table: (n_pages + 1, hkv, page, d[v])
    pages, the last the trash page, ``spare`` unreferenced pages, random
    values everywhere the table does not point."""
    dev = "cuda"
    n_w = -(-S // page)
    n_pages = b * n_w + spare
    kc = torch.randn(b, hkv, S, d, generator=gen, device=dev).to(dt)
    vc = torch.randn(b, hkv, S, dv, generator=gen, device=dev).to(dt)
    kp = torch.randn(n_pages + 1, hkv, page, d, generator=gen,
                     device=dev).to(dt)
    vp = torch.randn(n_pages + 1, hkv, page, dv, generator=gen,
                     device=dev).to(dt)
    table = torch.randperm(n_pages, generator=gen, device=dev)[: b * n_w]
    pad = n_w * page - S

    def blocks(c):
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
        return c.reshape(b, hkv, n_w, page, -1).permute(0, 2, 1, 3, 4) \
            .reshape(b * n_w, hkv, page, -1)

    kp[table], vp[table] = blocks(kc), blocks(vc)
    return kc, vc, kp, vp, table.reshape(b, n_w).to(torch.int32).contiguous()


def kernel_timings(torch, L: int, retriever, query_embs, s_train: int):
    """Each kernel at its main-path shape: kernel, plain version, library."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import topk_retrieval as TK

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    out = {}

    # the launch floor: a one-element PyTorch op in the same graph harness,
    # what any kernel of a few microseconds pays per launch besides its work
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(torch, lambda: one.add_(1.0), 200)
    # flash and dense decode at every serve's attention shape, one table
    out.update(attention_timings(torch, L, floor_ms))
    b, hq, hkv, d = 56, 32, 8, 128          # scope-qwen3-4b's attention
    # the main flash call saving each row's log-sum-exp, as training's
    # forward does (the serve path saves none)
    q, k, v = (torch.randn(b, L, h, d, generator=gen, device=dev).to(bf)
               .transpose(1, 2) for h in (hq, hkv, hkv))
    out["flash_attention"]["lse_ms"] = device_ms(
        torch, lambda: FA.flash_attention_cuda(q, k, v, return_lse=True), 50)
    print(f"   flash_attention: {out['flash_attention']['ms']:.5f} ms, with "
          f"the lse saved {out['flash_attention']['lse_ms']:.5f} ms")
    # the same batch at 128-token prompts, off the main path: 4 key tiles a
    # row tile instead of 2
    q2, k2, v2 = (torch.randn(b, 128, h, d, generator=gen, device=dev)
                  .to(bf).transpose(1, 2) for h in (hq, hkv, hkv))
    out["flash_attention"]["at_128_tokens"] = dict(
        ms=device_ms(torch, lambda: FA.flash_attention_cuda(q2, k2, v2), 50),
        library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
            q2, k2, v2, is_causal=True, enable_gqa=True), 50),
        bound_ms=bound(2 * (2 * q2.numel() + k2.numel() + v2.numel()),
                       2 * 2 * d * 128 * 129 // 2 * b * hq, "bfloat16")[0])
    print(f"   flash_attention at 128 tokens: "
          + " ".join(f"{key} {val:.5f}" for key, val in
                     out["flash_attention"]["at_128_tokens"].items()))
    del q, k, v, q2, k2, v2

    # paged decode: the stream's last decode step (16 slots, cache_len =
    # kv_cap on every row); qwen2-vl-7b's serve at group 7 on 56 rows, on a
    # generator of its own
    out["paged_decode_attention"] = paged_timing(torch, gen, 16, hq, hkv, d,
                                                 L + NEW_TOKENS)
    out["paged_decode_attention" + VLM] = paged_timing(
        torch, torch.Generator(device=dev).manual_seed(26), 56, 28, 4, 128,
        L + NEW_TOKENS)
    # qwen3-moe-235b-a22b's paged decode at group 16 (the serve's prompts
    # paged), on a generator of its own
    out["paged_decode_attention" + MOE_Q] = paged_timing(
        torch, torch.Generator(device=dev).manual_seed(28), 56, 64, 4, 128,
        L + NEW_TOKENS)

    # top-k: the request's 8 raw query embeddings against the 250 unit-norm
    # SCOPE anchors, as retrieve() calls it; the library call does the same
    # work (normalize the queries, the product, torch.topk)
    qe = torch.as_tensor(query_embs, device=dev)
    an = retriever._anchors_norm
    nq, n, dd = qe.shape[0], an.shape[0], an.shape[1]
    nbytes = 4 * (qe.numel() + an.numel()) + 8 * nq * K_ANCHORS

    def topk_library():
        qn = qe / (torch.linalg.norm(qe, dim=-1, keepdim=True) + 1e-8)
        return torch.topk(qn @ an.T, K_ANCHORS)

    out["topk_retrieval"] = dict(
        times(torch, lambda: TK.topk_retrieval_cuda(
                  qe, an, K_ANCHORS, anchors_prenormalized=True),
              lambda: TK.topk_retrieval_plain(
                  qe, an, K_ANCHORS, anchors_prenormalized=True),
              topk_library, 200),
        shape=f"queries ({nq},{dd}) raw, anchors ({n},{dd}) unit, f32 k "
              f"{K_ANCHORS}",
        library_call="q / (|q| + 1e-8), the product, torch.topk",
        library_eager_ms=eager_ms(torch, topk_library, 200))
    print(f"   topk_retrieval eager: wrapper call "
          f"{out['topk_retrieval']['eager_ms']:.5f} ms, library chain "
          f"{out['topk_retrieval']['library_eager_ms']:.5f} ms")
    out["topk_retrieval"]["bound_ms"], out["topk_retrieval"]["bound_by"] = \
        bound(nbytes, 2 * nq * n * dd, "float32")
    print(f"   dense decode kernel at the paged row's shape: "
          f"{out['paged_decode_attention']['dense_kernel_ms']:.5f} ms")
    out["paged_decode_attention"]["launch_floor_ms"] = floor_ms
    print(f"   launch floor (one-element add_): {floor_ms:.5f} ms; decode "
          f"{out['decode_attention']['ms']:.5f} ms, paged decode "
          f"{out['paged_decode_attention']['ms']:.5f} ms")
    # the SSD kernels at mamba2-1.3b's serve and SFT (64 heads of 64, state
    # 128) and at zamba2-7b's (112 heads, state 64; its attention rows are
    # in attention_timings' table)
    out.update(ssd_rows(torch, gen, 56, 64, 128, L, s_train))
    out.update(ssd_rows(torch, gen, 56, 112, 64, L, s_train, HYBRID))
    out["flash_attention_bwd"] = bwd_timing(torch, gen, s_train)
    # zamba2-7b's SFT: the flash backward at its tied block's 32 heads of
    # 112, group 1
    row = "flash_attention_bwd" + HYBRID
    out[row] = bwd_timing(torch, gen, s_train, hq=32, hkv=32, d=112,
                          label=row)
    # the training families' flash backward at their SFT shapes, on a
    # generator of its own: deepseek-v2-lite-16b's MLA (16 heads at g 1,
    # q / k 192, v 128, its scale), gemma2-9b's heads of 256 with softcap
    # 50 (flex_attention's backward the yardstick: SDPA takes no softcap),
    # qwen3-moe-235b-a22b's g 16, whisper-medium's encoder non-causal over
    # its 1500 frames
    gen = torch.Generator(device=dev).manual_seed(30)
    for row, kw in (
            (MLA, dict(hq=16, hkv=16, d=192, dv=128, scale=192 ** -0.5)),
            ("@gemma2-9b", dict(hq=16, hkv=8, d=256, softcap=50.0)),
            (MOE_Q, dict(hq=64, hkv=4, d=128)),
            (AUDIO + "/encoder", dict(
                hq=16, hkv=16, d=64, causal=False, sk=ENC_FRAMES,
                b=FAMILY_TRAIN[AUDIO[1:]][2]))):
        row = "flash_attention_bwd" + row
        out[row] = bwd_timing(torch, gen, ENC_FRAMES if "/encoder" in row
                              else s_train, label=row, **kw)
    for name, t in out.items():
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.5f}")
        print(f"   {name} [{t['shape']}]: kernel_ms {t['ms']:.5f} "
              f"plain_ms {t['plain_ms']:.5f} library_ms {lib}"
              f" bound_ms {t['bound_ms']:.6f} ({t['bound_by']}); eager "
              f"wrapper call {t['eager_ms']:.5f} ms")
    return out


# the flash calls of a serve's prefill that attention_timings times: (row
# suffix, rows, sq, sk, causal, timed calls); a length of None is the
# prompt's, L
SERVE_FLASH = (("", 56, None, None, True, 50),)
ENC_FRAMES = 1500                           # whisper-medium's encoder_seq_len

# the serves' attention shapes (config suffix of the row, q-heads,
# kv-heads, head dim, softcap, flash calls): the main path's
# scope-qwen3-4b, zamba2-7b's shared block (group 1, d 112), gemma2-9b's
# global layer (its local layers' window of 4096 never bites on L + 12
# tokens), starcoder2-3b's group 12, internlm2-1.8b's decode at group 2,
# qwen2-vl-7b's group 7 (and its image prefill of 8 x 320 tokens) and
# whisper-medium's decoder (group 1, d 64; and the encoder over its
# frames, the cross-attention over them at the prompts and at sq = 1, all
# non-causal), qwen3-moe-235b-a22b's group 16 and deepseek-v2-lite-16b's
# MLA prefill (head dims (d, dv) = (192, 128), the scale d ** -0.5 passed
# explicitly).  Each has its dense decode timed too, but for
# MLA's (dv != d: it decodes in plain PyTorch, no kernel).
ATTENTION_SHAPES = (
    ("", 32, 8, 128, 0.0, SERVE_FLASH),
    (HYBRID, 32, 32, 112, 0.0, SERVE_FLASH),
    ("@gemma2-9b", 16, 8, 256, 50.0, SERVE_FLASH),
    ("@starcoder2-3b", 24, 2, 128, 0.0, SERVE_FLASH),
    ("@internlm2-1.8b", 16, 8, 128, 0.0, ()),
    (VLM, 28, 4, 128, 0.0, SERVE_FLASH + (
        ("/image", VLM_ROWS, VLM_PATCHES + VLM_TEXT, VLM_PATCHES + VLM_TEXT,
         True, 20),)),
    (AUDIO, 16, 16, 64, 0.0, SERVE_FLASH + (
        ("/encoder", 56, ENC_FRAMES, ENC_FRAMES, False, 10),
        ("/cross", 56, None, ENC_FRAMES, False, 50),
        ("/cross-sq1", 56, 1, ENC_FRAMES, False, 200))),
    (MOE_Q, 64, 4, 128, 0.0, SERVE_FLASH),
    (MLA, 16, 16, (192, 128), 0.0, SERVE_FLASH))


# flex_attention's tile options for a prefill at heads of 256: its default
# tiles take ~1.3 ms at gemma2-9b's shape on the H100, these ~0.07 ms;
# attention_timings times both and keeps the faster
FLEX_PREFILL_OPTIONS = dict(BLOCK_M=64, BLOCK_N=32, num_warps=4, num_stages=2)


def softcap_library(torch, cap: float, q, k, v, lens=None,
                    kernel_options=None, window: int = 0, q_offset: int = 0):
    """The one PyTorch call that computes softcapped attention:
    ``flex_attention`` under ``torch.compile``, with the score_mod cap *
    tanh(s / cap) and a block mask, causal for a prefill (queries from
    position ``q_offset``, within ``window`` keys when it is set) or each
    row's first ``lens[b]`` keys for a decode; q-heads grouped on k's
    heads.  The port never calls it; it is the yardstick of the softcapped
    rows."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    if lens is None:
        def mask_mod(b, h, q_idx, kv_idx):
            keep = q_idx + q_offset >= kv_idx
            if window:
                keep = keep & (q_idx + q_offset - kv_idx < window)
            return keep
    else:
        def mask_mod(b, h, q_idx, kv_idx):
            return kv_idx < lens[b]
    block_mask = create_block_mask(mask_mod, B=None if lens is None else
                                   q.shape[0], H=None, Q_LEN=q.shape[2],
                                   KV_LEN=k.shape[2], device=q.device)
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda: fn(q, k, v, score_mod=score_mod, block_mask=block_mask,
                      enable_gqa=True, kernel_options=kernel_options)


def attention_timings(torch, L: int, floor_ms: float,
                      shapes=ATTENTION_SHAPES):
    """Flash and dense decode at every serve's attention shape
    (ATTENTION_SHAPES): each flash call of its prefill (56 prompts of L
    tokens, and the table's other calls) and the last decode step at L +
    12 keys on every row, bf16, q, k, v the model's transposed (b, s, h,
    d) views.  The yardstick is SDPA where there is no softcap and
    ``softcap_library`` where there is one (for a prefill the faster of
    its default tiles and FLEX_PREFILL_OPTIONS), held to the plain version
    before it is timed.  Beside a flash call at sq = 1 the dense decode
    kernel on the same keys is timed, as a finding only: the model keeps
    the reference's flash call there."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA

    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(24)
    b, S = 56, L + NEW_TOKENS       # the decode's rows and keys
    out = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    def yardstick(row, cap, library, plain):
        if not cap:
            return library
        err = (library().float() - plain().float()).abs().max().item()
        print(f"   {row}: flex_attention vs plain {err:.3e}")
        check(err <= BF16_TOL, f"{row}: flex_attention differs from the "
              f"plain version by {err:.3e} (tolerance {BF16_TOL})")
        return library

    for config, hq, hkv, d, cap, flashes in shapes:
        d, dv = d if isinstance(d, tuple) else (d, d)
        kw = dict(softcap=cap) if cap else {}
        if dv != d:                 # MLA passes its scale explicitly
            kw["scale"] = d ** -0.5
        note = f" softcap {cap:g}" if cap else ""
        call = ("flex_attention (torch.compile), score_mod softcap * "
                "tanh(s / softcap), {} block mask" if cap else
                "scaled_dot_product_attention")
        for suffix, fb, sq, sk, causal, iters in flashes:
            sq, sk = sq or L, sk or L
            check(causal or not cap, "softcap_library masks causally")
            q = randn(fb, sq, hq, d).transpose(1, 2)
            k = randn(fb, sk, hkv, d).transpose(1, 2)
            v = randn(fb, sk, hkv, dv).transpose(1, 2)
            row = "flash_attention" + config + suffix
            plain = (lambda: FA.flash_attention_plain(q, k, v, causal=causal,
                                                      **kw))
            library = (softcap_library(torch, cap, q, k, v) if cap else
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, is_causal=causal, enable_gqa=True,
                           scale=kw.get("scale")))
            refused = None
            if dv != d:
                try:
                    library()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    refused = f"SDPA refused dv {dv} != d {d}: {e}"[:300]
                    print(f"   {row}: {refused}")
                    library = None
            out[row] = dict(
                times(torch, lambda: FA.flash_attention_cuda(
                          q, k, v, causal=causal, **kw),
                      plain, library and yardstick(row, cap, library, plain),
                      iters),
                shape=f"q ({fb},{hq},{sq},{d}) kv ({fb},{hkv},{sk},{d}) "
                      + (f"v dim {dv} scale {d}^-0.5 " if dv != d else "")
                      + f"bf16 {'causal' if causal else 'non-causal'}{note}, "
                      "views of (b, s, h, d)",
                library_call=refused or call.format("causal"))
            if cap:
                tuned = softcap_library(torch, cap, q, k, v,
                                        kernel_options=FLEX_PREFILL_OPTIONS)
                t = out[row]
                t["library_default_ms"] = t["library_ms"]
                t["library_tuned_ms"] = device_ms(
                    torch, yardstick(row, cap, tuned, plain), 50)
                print(f"   {row}: flex_attention default tiles "
                      f"{t['library_default_ms']:.5f} ms, "
                      f"{FLEX_PREFILL_OPTIONS} {t['library_tuned_ms']:.5f}")
                if t["library_tuned_ms"] < t["library_ms"]:
                    t["library_ms"] = t["library_tuned_ms"]
                    t["library_call"] += f", {FLEX_PREFILL_OPTIONS}"
            pairs = sq * (sq + 1) // 2 if causal else sq * sk
            out[row]["bound_ms"], out[row]["bound_by"] = bound(
                2 * (q.numel() + k.numel() + v.numel() + fb * hq * sq * dv),
                2 * (d + dv) * pairs * fb * hq, "bfloat16")
            if sq == 1 and not causal:
                lens = torch.full((fb,), sk, dtype=torch.int32, device=dev)
                qd, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
                out[row]["dense_decode_ms"] = device_ms(
                    torch, lambda: DA.decode_attention_cuda(qd, kc, vc,
                                                            lens), 200)
                print(f"   {row}: dense decode kernel at cache_len {sk} "
                      f"{out[row]['dense_decode_ms']:.5f} ms")
                del qd, kc, vc
            del q, k, v
        if dv != d:                 # MLA: no decode kernel
            continue
        qd = randn(b, hq, 1, d)
        kc, vc = randn(b, hkv, S, d), randn(b, hkv, S, d)
        lens = torch.full((b,), S, dtype=torch.int32, device=dev)
        mask = (torch.arange(S, device=dev)[None] < lens[:, None])[:, None,
                                                                   None]
        valid = int(lens.sum())
        row = "decode_attention" + config
        plain = (lambda: DA.decode_attention_plain(qd, kc, vc, lens, **kw))
        library = (softcap_library(torch, cap, qd, kc, vc, lens) if cap else
                   lambda: F.scaled_dot_product_attention(
                       qd, kc, vc, attn_mask=mask, enable_gqa=True))
        out[row] = dict(
            times(torch, lambda: DA.decode_attention_cuda(qd, kc, vc, lens,
                                                          **kw),
                  plain, yardstick(row, cap, library, plain), 200),
            shape=f"q ({b},{hq},1,{d}) cache ({b},{hkv},{S},{d}) bf16 "
                  f"cache_len {S}{note}", launch_floor_ms=floor_ms,
            library_call=call.format("valid-length"))
        out[row]["bound_ms"], out[row]["bound_by"] = bound(
            2 * (2 * qd.numel() + 2 * valid * hkv * d) + 4 * b,
            2 * 2 * d * valid * hq, "bfloat16")
        del qd, kc, vc
    return out


def paged_timing(torch, gen, b: int, hq: int, hkv: int, d: int, S: int):
    """Paged decode at a serve's last step: ``b`` rows at cache_len ``S``,
    16-token pages behind a permuted table, bf16 (``gen`` draws the
    inputs).  The yardstick is the gather of the rows' pages plus SDPA on
    the result; beside it, the dense decode kernel on the same logical
    cache, for the cost of the page indirection alone."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA

    dev, bf = "cuda", torch.bfloat16
    qd = torch.randn(b, hq, 1, d, generator=gen, device=dev).to(bf)
    kc, vc, kp, vp, table = paged_layout(torch, gen, b, hkv, S, d, d, PAGE,
                                         bf)
    lens = torch.full((b,), S, dtype=torch.int32, device=dev)
    mask = torch.ones(b, 1, 1, S, dtype=torch.bool, device=dev)
    n_w = table.shape[1]

    def gather_sdpa():
        idx = table.long()
        kd = kp[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, n_w * PAGE, d)
        vd = vp[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, n_w * PAGE, d)
        return F.scaled_dot_product_attention(
            qd, kd[:, :, :S], vd[:, :, :S], attn_mask=mask, enable_gqa=True)

    kw = dict(page_size=PAGE, kv_cap=S)
    valid = int(lens.sum())
    out = dict(
        times(torch, lambda: DA.paged_decode_attention_cuda(
                  qd, kp, vp, lens, table, **kw),
              lambda: DA.paged_decode_attention_plain(
                  qd, kp, vp, lens, table, **kw), gather_sdpa, 200),
        shape=f"q ({b},{hq},1,{d}) pages ({kp.shape[0]},{hkv},{PAGE},{d}) "
              f"table ({b},{n_w}) bf16 cache_len {S}",
        library_call="gather of the pages + scaled_dot_product_attention",
        dense_kernel_ms=device_ms(torch, lambda: DA.decode_attention_cuda(
            qd, kc, vc, lens), 200))
    out["bound_ms"], out["bound_by"] = bound(
        2 * (2 * qd.numel() + 2 * valid * hkv * d) + 4 * b
        + 4 * table.numel(), 2 * 2 * d * valid * hq, "bfloat16")
    return out


def kernels_ms(torch, fn, iters: int, warmup: int = 3, by_kernel=False):
    """Device time per call of ``fn``: the CUDA time of every kernel (and
    memset / copy) the profiler sees over ``iters`` calls, summed, over
    ``iters``.  The gaps between kernels, where the host is launching the
    next one, are not in it, so an eager call with many small kernels is
    timed as a CUDA-graph replay of the same kernels would be, minus the
    graph's own small gaps.  With ``by_kernel`` also {kernel name: ms per
    call}."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    us = sum(e.self_device_time_total for e in events)
    check(us > 0, "the profiler saw no device time")
    if not by_kernel:
        return us / 1e3 / iters
    return us / 1e3 / iters, {e.key.split("(")[0][:60]:
                              e.self_device_time_total / 1e3 / iters
                              for e in events}


def bwd_timing(torch, gen, s: int, hq: int = 32, hkv: int = 8,
               d: int = 128, label: str = "flash_attention_bwd", *,
               b: int = SFT_BATCH, sk=None, dv=None, causal: bool = True,
               softcap: float = 0.0, scale=None):
    """The flash backward kernel at an SFT step's shape (``b`` sequences of
    ``s`` tokens, bf16, q, k, v the model's views; scope-qwen3-4b's 32/8
    heads of 128, causal, by default; keys ``sk`` (default ``s``), v's
    head dim ``dv`` (default ``d``), the mask, softcap and scale as the
    model passes them), beside the plain version's backward (autograd of
    ``flash_attention_plain``) and, as a yardstick only, the backward of
    one PyTorch call on the same inputs: ``F.scaled_dot_product_attention``
    without a softcap, ``softcap_library`` with one (the faster of its
    default tiles and FLEX_PREFILL_OPTIONS, its gradients held to the plain
    version's first, as the forward's yardstick is).  All three are timed
    the same way, by device time: the CUDA time of their kernels summed
    from ``torch.profiler`` (``kernels_ms``; autograd's backward is not
    captured in a graph).
    ``ms`` is the kernel's wrapper in CUDA-graph replays, as every other
    kernel's, ``prof_ms`` the same call by the profiler's sum; the eager
    times stand beside them.  The forward kernel at this shape is timed
    without and with its log-sum-exp output (graph replays)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    dev, bf = "cuda", torch.bfloat16
    sk, dv = sk or s, dv or d
    mask = dict(causal=causal, softcap=softcap, scale=scale)

    def view(n, h, w):
        return torch.randn(b, n, h, w, generator=gen, device=dev).to(bf) \
            .transpose(1, 2).requires_grad_(True)

    q, k, v = view(s, hq, d), view(sk, hkv, d), view(sk, hkv, dv)
    dout = torch.randn(b, hq, s, dv, generator=gen, device=dev).to(bf)
    with torch.no_grad():
        out, lse = FA.flash_attention_cuda(q, k, v, return_lse=True, **mask)
    plain_out = FA.flash_attention_plain(q, k, v, **mask)

    def kernel():
        return FA.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **mask)

    def grads(y):
        return lambda: torch.autograd.grad(y, (q, k, v), dout,
                                           retain_graph=True)

    plain = grads(plain_out)
    if softcap:
        check(causal, "softcap_library masks causally")
        lib_ms, call = softcap_bwd_library(torch, softcap, q, k, v, dout,
                                           plain(), label)
        lib_eager_ms = None
        lib_call = call or "none: flex_attention's backward failed to run"
    else:
        sdpa_out = F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True, scale=scale)
        lib_ms = kernels_ms(torch, grads(sdpa_out), 20)
        lib_eager_ms = eager_ms(torch, grads(sdpa_out), 20)
        lib_call = ("backward of scaled_dot_product_attention (GQA, the "
                    "same mask and scale)")
        del sdpa_out

    with torch.no_grad():
        fwd = dict(
            fwd_ms=device_ms(torch, lambda: FA.flash_attention_cuda(
                q, k, v, **mask), 50),
            fwd_lse_ms=device_ms(torch, lambda: FA.flash_attention_cuda(
                q, k, v, return_lse=True, **mask), 50))
    prof_ms, split = kernels_ms(torch, kernel, 20, by_kernel=True)
    t = dict(
        ms=device_ms(torch, kernel, 20),
        prof_ms=prof_ms, split_ms=split,
        plain_ms=kernels_ms(torch, plain, 10),
        library_ms=lib_ms,
        eager_ms=eager_ms(torch, kernel, 20),
        plain_eager_ms=eager_ms(torch, plain, 10),
        library_eager_ms=lib_eager_ms,
        **fwd,
        shape=f"q ({b},{hq},{s},{d}) k ({b},{hkv},{sk},{d}) v ({b},{hkv},"
              f"{sk},{dv}) bf16 {'causal' if causal else 'non-causal'}"
              + (f" softcap {softcap}" if softcap else "")
              + (f" scale {scale:.6g}" if scale else "")
              + ", views of (b, s, h, d); out, dO (b, hq, s, dv); lse "
              "(b, hq, s) f32",
        library_call=lib_call + "; plain_ms and library_ms are profiler "
                                "sums of device time, as prof_ms")

    def ms(x):
        return "none" if x is None else f"{x:.5f}"

    lib = "flex_attention" if softcap else "SDPA"
    print(f"   {label} device ms, profiler sums: kernel "
          f"{t['prof_ms']:.5f} plain {t['plain_ms']:.5f} {lib} backward "
          f"{ms(t['library_ms'])}; kernel graph replays {t['ms']:.5f}; "
          f"eager: kernel {t['eager_ms']:.5f} plain "
          f"{t['plain_eager_ms']:.5f} {lib} backward "
          f"{ms(t['library_eager_ms'])}")
    print(f"   {label} by launch (profiler, ms a call): "
          + ", ".join(f"{k} {v:.5f}" for k, v in split.items()))
    print(f"   flash forward at the SFT shape: {t['fwd_ms']:.5f} ms, with "
          f"the lse saved {t['fwd_lse_ms']:.5f} ms")
    # q, k, v, o, dO and lse read once, dq, dk, dv written once; per
    # (query, key) pair that attends and q-head the scores (2d), dP (2dv),
    # dV (2dv), dK (2d) and dQ (2d)
    pairs = s * (s + 1) // 2 if causal else s * sk
    nbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + 2 * out.numel()) + 4 * lse.numel()
    t["bound_ms"], t["bound_by"] = bound(
        nbytes, pairs * b * hq * (6 * d + 4 * dv), "bfloat16")
    del plain_out
    release(torch)
    return t


def softcap_bwd_library(torch, cap: float, q, k, v, dout, want, label):
    """(device ms, call) of the backward of ``softcap_library`` (causal) on
    q, k, v for the upstream gradient ``dout``: for its default tiles and
    for FLEX_PREFILL_OPTIONS, each one's (dq, dk, dv) held to ``want`` (the
    plain version's) within BF16_TOL x max(1, max |want|) before it is
    timed, the faster kept.  A tiling the compiler refuses is printed and
    skipped; (None, None) if both are."""
    best = (None, None)
    for options in (None, FLEX_PREFILL_OPTIONS):
        name = "default tiles" if options is None else str(options)
        try:
            y = softcap_library(torch, cap, q, k, v,
                                kernel_options=options)()

            def grads():
                return torch.autograd.grad(y, (q, k, v), dout,
                                           retain_graph=True)

            got = grads()
            torch.cuda.synchronize()
        except Exception as e:          # noqa: BLE001 (a compiler's refusal)
            print(f"   {label}: flex_attention backward, {name}: "
                  f"{type(e).__name__}: {str(e)[:300]}")
            continue
        for g, w, n in zip(got, want, "qkv"):
            w = w.float()
            err = (g.float() - w).abs().max().item()
            tol = BF16_TOL * max(1.0, w.abs().max().item())
            print(f"   {label}: flex_attention backward, {name}: d{n} vs "
                  f"plain {err:.3e} (tolerance {tol:.3e})")
            check(err <= tol, f"{label}: flex_attention's d{n} differs from "
                  f"the plain version's by {err:.3e} (tolerance {tol:.3e})")
        t = kernels_ms(torch, grads, 20)
        print(f"   {label}: flex_attention backward, {name}: {t:.5f} ms")
        if best[0] is None or t < best[0]:
            best = (t, "backward of flex_attention (torch.compile), score_mod "
                       "softcap * tanh(s / softcap), causal block mask"
                       + ("" if options is None else f", {options}"))
        del y, got
    return best


L2_BYTES = 50 * 2 ** 20         # the H100's L2


def ssd_rows(torch, gen, b: int, h: int, n: int, L: int, s_train: int,
             tag: str = "", check64: bool = False):
    """The SSD kernels at ``h`` heads of 64 and state ``n``, as rows
    ``<kernel>{tag}``: the scan at a batch serve's prefill (``b`` x ``L``,
    x the strided slice of a conv output: the heads' channels, then B, C),
    the decode step in place on an f32 state (x, B, C slices of a
    conv-output row, batch dim fastest), the scan backward at an SFT step's
    shape (``ssd_bwd_timing``).  Each is timed beside its plain version
    (``times``) with its bound (``ssd_work``, ``step_work``,
    ``ssd_bwd_work``); no single PyTorch call computes any of them.  The
    step walks the layers of a stacked state of more than twice the L2,
    one layer a call, so each call reads its state from HBM, as a decode
    step over a model's layers does.  With ``check64`` each kernel is
    first held to its plain version run in float64 on the same values, as
    ``kernel_checks`` holds them (scan y 3e-2 and state 2e-5 x max(1,
    |witness|); the step's y and state 2e-5 that way; the backward's bf16
    parts 3e-2 and float32 parts ``SPLIT_TOL`` x max(1, max |witness|)),
    its largest |difference| the row's ``max_abs_err``."""
    import itertools
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_decode_step as SD
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models.ssm import _largest_chunk
    bf, p, dev, rows = torch.bfloat16, 64, "cuda", {}

    def held(what, got, want, tol, scale):
        diff = (got.double() - want).abs()
        den = (want.abs().clamp(min=1.0) if scale == "each"
               else max(1.0, want.abs().max().item()))
        bad = (diff / den).max().item()
        check(bad <= tol, f"{what}: {bad:.3e} from its plain version in "
              f"float64 (tol {tol})")
        return diff.max().item()

    chunk = _largest_chunk(L, 128)
    x, dtv, A, B, C = ssd_inputs(torch, gen, b, L, h, p, n, 1.0, bf,
                                 conv_layout=True)
    row = rows["ssd_scan" + tag] = {}
    if check64:
        y, st = SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=chunk)
        yw, sw = ref.ssd(*(t.double() for t in (x, dtv, A, B, C)),
                         chunk=chunk)
        row["max_abs_err"] = max(
            held(f"ssd_scan{tag} y", y, yw, BF16_TOL, "each"),
            held(f"ssd_scan{tag} state", st, sw, F32_TOL, "each"))
        del y, st, yw, sw
    row.update(
        times(torch, lambda: SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=chunk),
              lambda: ref.ssd(x, dtv, A, B, C, chunk=chunk), None, 50),
        shape=f"x ({b},{L},{h},{p}) bf16 conv-output slice dt ({b},{L},{h}) "
              f"A ({h},) bf16 B, C ({b},{L},{n}) f32 chunk {chunk}",
        library_call="none: no single PyTorch call computes the SSD scan")
    row["bound_ms"], row["bound_by"] = bound(
        *ssd_work(b, L, h, p, n, chunk, x.element_size(), A.element_size()),
        "float32")
    del x, dtv, B, C

    layers = max(2, -(-2 * L2_BYTES // (4 * b * h * p * n)))
    cache = torch.randn(layers, b, h, p, n, generator=gen, device=dev) * 0.1
    conv = torch.randn(h * p + 2 * n, b, generator=gen, device=dev).t() * 0.5
    xs, Bs, Cs = (conv[:, :h * p].reshape(b, h, p), conv[:, h * p:h * p + n],
                  conv[:, h * p + n:])
    dts = torch.nn.functional.softplus(torch.randn(b, h, generator=gen,
                                                   device=dev))
    row = rows["ssd_decode_step" + tag] = {}
    if check64:
        wit = cache[0].double()
        ys, _ = SD.ssd_decode_step_cuda(cache[0], xs, dts, A, Bs, Cs)
        yw, wit = ref.ssd_decode_step(wit, *(t.double() for t in (
            xs, dts, A, Bs, Cs)))
        row["max_abs_err"] = max(
            held(f"ssd_decode_step{tag} y", ys, yw, F32_TOL, "each"),
            held(f"ssd_decode_step{tag} state", cache[0], wit, F32_TOL,
                 "each"))
        del ys, yw, wit
    ring, plain_ring = itertools.cycle(cache), itertools.cycle(cache)
    row.update(
        times(torch, lambda: SD.ssd_decode_step_cuda(next(ring), xs, dts, A,
                                                     Bs, Cs),
              lambda: ref.ssd_decode_step(next(plain_ring), xs, dts, A, Bs,
                                          Cs), None, 200),
        shape=f"state {layers} layers of ({b},{h},{p},{n}) f32, one a call, "
              f"x ({b},{h},{p}) dt ({b},{h}) B, C ({b},{n}) f32 conv-output "
              f"slices, A ({h},) bf16, in place",
        library_call="none: no single PyTorch call computes the SSD step")
    row["bound_ms"], row["bound_by"] = bound(
        *step_work(b, h, p, n, A.element_size()), "float32")
    del cache, conv, ring, plain_ring

    row = rows["ssd_scan_bwd" + tag] = {}
    if check64:
        bchunk = _largest_chunk(s_train, 128)
        x, dtv, A, B, C = ssd_inputs(torch, gen, SFT_BATCH, s_train, h, p,
                                     n, 1.0, bf, conv_layout=True)
        dy = torch.randn(SFT_BATCH, s_train, h, p, generator=gen,
                         device=dev).to(bf)
        with torch.no_grad():
            _, _, states = SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=bchunk,
                                            save_states=True)
            got = SS.ssd_scan_bwd_cuda(x, dtv, A, B, C, dy, None, states,
                                       chunk=bchunk)
        wit = SS.ssd_scan_bwd_plain(
            *(t.double() for t in (x, dtv, A, B, C, dy)), None,
            chunk=bchunk)
        row["max_abs_err"] = max(
            held(f"ssd_scan_bwd{tag} {part}", g, w,
                 SPLIT_TOL if g.dtype == torch.float32 else BF16_TOL, "max")
            for part, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, wit,
                                  strict=True))
        del x, dtv, A, B, C, dy, got, wit, states
    row.update(ssd_bwd_timing(torch, gen, s_train, h=h, n=n))
    for k in ("ssd_scan", "ssd_decode_step", "ssd_scan_bwd"):
        r = rows[k + tag]
        print(f"   {k}{tag}: max |err| {r.get('max_abs_err', 'not held')}, "
              f"{r['ms']:.5f} ms (plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.5f} by {r['bound_by']})")
    release(torch)
    return rows


def ssd_bwd_timing(torch, gen, s: int, h: int, n: int, p: int = 64):
    """The SSD scan backward kernel at an SFT step's shape (64 sequences of
    ``s`` tokens, ``h`` heads of ``p``, state ``n``; x the conv output's
    strided bf16 slice, dy bf16, no final-state gradient, as a mamba layer's
    backward gets them) beside its plain version, both in CUDA-graph
    replays (``ms``, ``plain_ms``); ``prof_ms`` is the kernel's wrapper by
    the profiler's sum of device time (``kernels_ms``), split by launch in
    ``split_ms``; no single PyTorch call computes it."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models.ssm import _largest_chunk
    b, bf = 64, torch.bfloat16
    chunk = _largest_chunk(s, 128)
    x, dtv, A, B, C = ssd_inputs(torch, gen, b, s, h, p, n, 1.0, bf,
                                 conv_layout=True)
    dy = torch.randn(b, s, h, p, generator=gen, device="cuda").to(bf)
    with torch.no_grad():
        _, _, states = SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=chunk,
                                        save_states=True)
    t = dict(
        times(torch, lambda: SS.ssd_scan_bwd_cuda(x, dtv, A, B, C, dy, None,
                                                  states, chunk=chunk),
              lambda: SS.ssd_scan_bwd_plain(x, dtv, A, B, C, dy,
                                            chunk=chunk), None, 20),
        shape=f"x ({b},{s},{h},{p}) bf16 conv-output slice dy bf16 dt "
              f"({b},{s},{h}) A ({h},) bf16 B, C ({b},{s},{n}) f32 chunk "
              f"{chunk}, no final-state gradient",
        library_call="none: no single PyTorch call computes the SSD scan "
                     "backward")
    t["prof_ms"], t["split_ms"] = kernels_ms(
        torch, lambda: SS.ssd_scan_bwd_cuda(x, dtv, A, B, C, dy, None, states,
                                            chunk=chunk), 20, by_kernel=True)
    t["bound_ms"], t["bound_by"] = bound(
        *ssd_bwd_work(b, s, h, p, n, chunk, x.element_size(),
                      A.element_size()), "float32")
    print(f"   ssd_scan_bwd h {h} n {n} device ms: graph replays "
          f"{t['ms']:.5f}, profiler sum {t['prof_ms']:.5f} ("
          + ", ".join(f"{k} {v:.5f}" for k, v in t["split_ms"].items())
          + ")")
    return t


def ssd_bwd_work(b, l, h, p, n, chunk, x_bytes, a_bytes):
    """(bytes, f32 FLOPs) the SSD scan backward needs with no final-state
    gradient: x, dy, dt, A, B, C and, from the second chunk on, the saved
    entering states read once, dx, d(dt), dA, dB and dC written once.  Per
    (row, chunk) the causal scores C[s].B[t] and the products dC = dG B and
    dB = dG^T C over the T (T + 1) / 2 pairs t <= s (2 n each: B and C are
    one group every head shares); per (row, head, chunk) dW = dy.xd and
    dxd = (G L)^T dy (2 p a pair each); per (row, head) of a chunk that a
    later one follows, the state's dxd and dB terms (2 T p n each), and of
    a chunk after the first the entering state's dC and dS_in (2 T p n
    each)."""
    nc = l // chunk
    nbytes = (3 * x_bytes * b * l * h * p + 2 * 4 * b * l * h
              + 2 * a_bytes * h + 4 * 4 * b * l * n
              + 4 * b * (nc - 1) * h * p * n)
    pairs = chunk * (chunk + 1) // 2
    flops = (b * nc * 3 * 2 * pairs * n + b * h * nc * 2 * 2 * pairs * p
             + b * h * (nc - 1) * 2 * 2 * 2 * chunk * p * n)
    return nbytes, flops


def step_work(b, h, p, n, a_bytes):
    """(bytes, f32 FLOPs) of one SSD decode step: the f32 state read once and
    written once, x, dt, A, B and C read once, y written once; per state
    element x dt B (1), state a + that (2) and y's product and sum (2)."""
    nbytes = (2 * 4 * b * h * p * n + 4 * (2 * b * h * p + b * h + 2 * b * n)
              + a_bytes * h)
    return nbytes, 5 * b * h * p * n


def ssd_work(b, l, h, p, n, chunk, x_bytes, a_bytes):
    """(bytes, f32 FLOPs) the SSD scan needs: x, dt, A, B and C read once,
    y and the f32 final state written once.  B and C are one group that
    every head shares, so the causal scores C[s].B[t] over the T (T + 1) / 2
    pairs t <= s of a chunk of T are needed once per (row, chunk); per
    (row, head) and chunk, their weighted sum of x dt, the state update
    (T x p x n), and from the second chunk on the entering state's term
    C[s].h (T x p x n)."""
    nc = l // chunk
    nbytes = (2 * x_bytes * b * l * h * p + 4 * b * l * h + a_bytes * h
              + 2 * 4 * b * l * n + 4 * b * h * p * n)
    pairs = chunk * (chunk + 1) // 2
    scores = b * nc * 2 * pairs * n
    per_head = (nc * (2 * pairs * p + 2 * chunk * p * n)
                + (nc - 1) * 2 * chunk * p * n)
    return nbytes, scores + b * h * per_head


# ---------------------------------------------------------------------------
# phases 5/6, 9/10 and 11/12: the main path through ScopeEngine.serve
# ---------------------------------------------------------------------------
def build_world():
    from repro_torch.core.fingerprint import (FingerprintLibrary,
                                              build_anchor_set)
    from repro_torch.data.datasets import build_scope_data, stratified_anchors
    from repro_torch.data.worldsim import World
    world = World(seed=0)
    data = build_scope_data(world, n_queries=600, seed=0)
    anchors = build_anchor_set(
        world, stratified_anchors(world, n=N_ANCHORS, seed=7))
    lib = FingerprintLibrary(anchors)
    for m in world.pool:
        if m.seen:
            lib.onboard(world, m.name, seed=3)
    return world, data, anchors, lib


def prompt_len(world, data, anchors, lib, qids) -> int:
    """The length of the serve's prompts of ``qids`` (every one has it),
    read from a scope-tiny engine's ``_prepare`` on the host."""
    from repro_torch.api import RouteRequest
    from repro_torch.configs.scope_estimator import TINY
    from repro_torch.models.model import init_params
    probe = make_engine(TINY, init_params(TINY, seed=0, device="cpu"),
                        anchors, lib, world, data, "cpu")
    st = probe._prepare(RouteRequest([data.queries[q] for q in qids]), False)
    L = len(st.prompts[0])
    check(all(len(p) == L for p in st.prompts), "prompts are not constant")
    return L


def make_engine(cfg, params, anchors, lib, world, data, device, **kw):
    from repro_torch.api import EngineConfig, ScopeEngine
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.core.retrieval import AnchorRetriever
    return ScopeEngine.build(EngineConfig(
        estimator=ReasoningEstimator(cfg, params,
                                     max_new_tokens=NEW_TOKENS),
        retriever=AnchorRetriever(anchors, device=device), library=lib,
        models_meta={m: world.models[m] for m in data.models}, **kw))


def tiny_ssm_config():
    """The small pure-SSM Mamba2 config of the CPU tests: mamba2-1.3b's
    ``reduced()`` (2 layers, d 256, 16 heads of 32, state 16, chunk 16,
    f32) with its shared attention switched off."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                               shared_attn_every=0)


def tiny_hybrid_config():
    """The small zamba2 hybrid of the CPU tests: zamba2-7b's
    ``reduced(num_layers=5, d_model=448)`` (two units of two mambas and the
    shared block, then one mamba; 4 heads of 112, group 1; f32)."""
    from repro_torch.configs import get_config
    return get_config("zamba2-7b").reduced(num_layers=5, d_model=448)


def tiny_dense_configs():
    """The small dense configs of the CPU tests' engines
    (``tests/test_torch_dense_families.py``): starcoder2-3b's ``reduced(
    d_model=768, num_heads=24)`` (24 heads of 32 on 2 kv-heads: GQA group
    12) and gemma2-9b's ``reduced(d_model=512, num_heads=2)`` with one
    kv-head and a window of 16 under the 49-token prompts (heads of 256,
    softcaps 50 / 30, post-norms, scaled embeddings); two layers, f32."""
    import dataclasses
    from repro_torch.configs import get_config
    return [get_config("starcoder2-3b").reduced(d_model=768, num_heads=24),
            dataclasses.replace(get_config("gemma2-9b").reduced(
                d_model=512, num_heads=2), num_kv_heads=1,
                sliding_window=16)]


def ring_card_vs_cpu(torch, cfg, steps: int = 12):
    """The ring-buffer decode: ``cfg`` with every layer windowed at 4
    (``force_window``), ``init_cache`` for ``steps`` tokens (caches of
    exactly 4 slots) and ``steps`` teacher-forced ``decode_step`` calls from
    position 0, on the card and on the CPU from the same seeded params:
    logits within 2e-5, greedy tokens equal, one dense decode launch a
    layer and step on the card."""
    import dataclasses
    import numpy as np
    from repro_torch import kernels
    from repro_torch.models.model import decode_step, init_cache, init_params

    cfg = dataclasses.replace(cfg, sliding_window=4, force_window=4)
    cpu_params = init_params(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (3, steps))
    runs = {}
    for dev in ("cpu", "cuda"):
        params = cpu_params if dev == "cpu" else _to(cpu_params, dev)
        caches = init_cache(cfg, 3, steps, device=dev)
        check({leaf.shape[3] for leaf in _leaves(caches)} == {4},
              f"ring caches {[tuple(x.shape) for x in _leaves(caches)]}")
        kernels.reset_launch_counts()
        logits = []
        for t in range(steps):
            lg, caches = decode_step(
                params, cfg, torch.tensor(toks[:, t:t + 1], device=dev),
                caches, torch.full((3,), t, dtype=torch.int32, device=dev))
            logits.append(lg[:, 0].float().cpu())
        runs[dev] = (torch.stack(logits, 1), kernels.launch_counts())
    (cpu, _), (card, counts) = runs["cpu"], runs["cuda"]
    err = float((cpu - card).abs().max())
    check(err <= F32_TOL, f"ring decode: logits differ by {err}")
    check(torch.equal(cpu.argmax(-1), card.argmax(-1)),
          "ring decode: greedy tokens differ")
    want = layer_counts(cfg)[0] * steps
    check(counts["decode_attention"] == want,
          f"ring decode: {counts['decode_attention']} decode launches, "
          f"want {want}")
    print(f"   ring decode ({cfg.name}, window 4, {steps} steps): logits "
          f"max_abs_err {err:.3g}, greedy tokens equal, {want} decode "
          "launches")
    return {"logits_max_abs_err": err, "decode_launches": want}


def tiny_multimodal_configs():
    """The small multimodal configs of the CPU tests
    (``tests/test_torch_multimodal.py``): qwen2-vl-7b's ``reduced(
    d_model=896, num_heads=28)`` (28 heads of 32 on 4 kv-heads: GQA group
    7; M-RoPE sections (8, 12, 12); 8 stub patches) and whisper-medium's
    ``reduced()`` (2 encoder and 2 decoder layers, 4 heads of 64, 32
    frames, a GELU MLP); f32."""
    from repro_torch.configs import get_config
    return [get_config("qwen2-vl-7b").reduced(d_model=896, num_heads=28),
            get_config("whisper-medium").reduced()]


def stub_batch(torch, cfg, b: int, s: int, seed: int, device):
    """Seeded tokens (b, s) and the family's stubs in the model dtype, made
    on ``device`` from its own generator: ``enc_features`` (b, enc_seq, d)
    for an encoder-decoder; for a VLM ``image_embeds`` (b, P, d) and
    ``positions_3d`` as Qwen2-VL lays them out (``grid_positions_3d``)."""
    from repro_torch.data.pipeline import grid_positions_3d
    from repro_torch.models.common import dtype_of
    g = torch.Generator(device=device).manual_seed(seed)
    dt = dtype_of(cfg.dtype)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                     device=device, dtype=torch.int32)}
    if cfg.is_encoder_decoder:
        batch["enc_features"] = torch.randn(
            b, cfg.encoder_seq_len, cfg.d_model, generator=g,
            device=device).to(dt)
    P = cfg.num_stub_patches
    if P:
        batch["image_embeds"] = torch.randn(b, P, cfg.d_model, generator=g,
                                            device=device).to(dt)
        batch["positions_3d"] = grid_positions_3d(b, s, P, device=device)
    return batch


def stub_generate(torch, params, cfg, batch, steps: int, forced=None,
                  walls=None, parts=None, shapes=None):
    """The model-level serve of a stub batch, as the reference can serve
    it: ``prefill`` with the stubs, the caches grown by ``steps`` slots,
    then ``steps`` ``decode_step`` calls, each fed the argmax of the
    previous logits (or, given ``forced`` (b, steps), its tokens).
    Returns (tokens (b, steps), float32 logits (b, steps + 1, V)); given a
    dict ``walls``, it records the prefill's and the decode's wall seconds
    (synchronized) under "prefill_s" and "decode_s"; given a dict
    ``parts``, the launch counts of each, every count set to 0 just
    before it and read just after, under "prefill" and "decode"
    (``launch_counts()`` and the flash launches by (sq, sk, causal) under
    "flash_by_shape"); given a dict ``shapes``, the prefill caches' shapes
    under "<segment>/<unit position>/<leaf>"."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    from repro_torch.serving.sampler import _pad_caches
    b, s = batch["tokens"].shape
    dev = batch["tokens"].device

    def tally(part):
        if parts is not None:
            parts[part] = dict(kernels.launch_counts(),
                               flash_by_shape=dict(FA.shape_launches))
            kernels.reset_launch_counts()

    if walls is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
    if parts is not None:
        kernels.reset_launch_counts()
    logits, caches = M.prefill(params, cfg, batch)
    if shapes is not None:
        shapes.update({f"{i}/{j}/{k}": list(t.shape) for i, seg in
                       enumerate(caches) for j, unit in seg.items()
                       for k, t in unit.items()})
    caches = _pad_caches(caches, s + steps, s)
    tally("prefill")
    if walls is not None:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        walls["prefill_s"] = t1 - t0
    outs, toks = [logits[:, -1].float()], []
    for t in range(steps):
        nxt = (outs[-1].argmax(-1) if forced is None else forced[:, t]).to(
            torch.int32)
        toks.append(nxt)
        lg, caches = M.decode_step(
            params, cfg, nxt[:, None], caches,
            torch.full((b,), s + t, dtype=torch.int32, device=dev))
        outs.append(lg[:, 0].float())
    tally("decode")
    if walls is not None:
        torch.cuda.synchronize()
        walls["decode_s"] = time.perf_counter() - t1
    return torch.stack(toks, 1), torch.stack(outs, 1)


# the profiler's names of the flash forward and dense decode kernels
KERNEL_EVENTS = {"flash": r"\bflash_(mma_)?kernel\b",
                 "decode": r"\bdecode_kernel\b"}


def full_stub_serve(torch, cfg, params, batch, steps: int = NEW_TOKENS):
    """``stub_generate`` at full width: a warm-up at the shape, then a run
    with its walls, launches of the prefill and of the decode (each counted
    from 0; no paged decode) and peak memory, then profiled runs of the
    prefill and of the whole serve for the device's busy time (the
    decode's is the difference) and idle shares; finite logits of the
    expected shape.  The flash launches are told apart by their shape
    (``flash_calls``): the decoder's causal self-attention, and for an
    encoder-decoder the encoder's, the prefill's cross-attention and each
    decode step's at sq = 1.  An encoder-decoder's encoder alone is timed
    and profiled the same way; a profile that does not see every flash and
    decode launch of its run is taken again."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M

    b, s = batch["tokens"].shape
    stub_generate(torch, params, cfg, batch, 2)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, parts = {}, {}
    toks, logits = stub_generate(torch, params, cfg, batch, steps,
                                 walls=walls, parts=parts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    pre, dec = parts["prefill"], parts["decode"]
    counts = {name: pre[name] + dec[name] for name in NO_LAUNCHES}
    check(tuple(toks.shape) == (b, steps) and tuple(logits.shape) == (
        b, steps + 1, cfg.vocab_size), f"{cfg.name}: output shapes "
        f"{tuple(toks.shape)} {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: non-finite "
          "logits")
    flash, n_dec = stub_launches(cfg, steps)
    want = dict(NO_LAUNCHES, flash_attention=flash, decode_attention=n_dec)
    check(counts == want, f"{cfg.name}: launches {counts} != {want}")
    # each flash launch by the call it came from, read off its shape
    n, enc = cfg.num_layers, cfg.encoder_seq_len
    calls = {"self": (pre, (s, s, True), n)}
    if cfg.is_encoder_decoder:
        check(s != enc, f"{cfg.name}: a prompt of {enc} tokens cannot be "
              "told from the encoder by its flash shape")
        calls.update(encoder=(pre, (enc, enc, False), cfg.num_encoder_layers),
                     cross=(pre, (s, enc, False), n),
                     cross_sq1=(dec, (1, enc, False), n * steps))
    flash_calls = {call: part["flash_by_shape"].get(key, 0)
                   for call, (part, key, _) in calls.items()}
    check(flash_calls == {call: k for call, (_, _, k) in calls.items()}
          and sum(flash_calls.values()) == counts["flash_attention"],
          f"{cfg.name}: flash launches by call {flash_calls}; prefill "
          f"{pre['flash_by_shape']}, decode {dec['flash_by_shape']}")
    del toks, logits
    _, prefill_ms, prefill_top = profiled_ms(
        torch, lambda: M.prefill(params, cfg, batch)[0].shape, top=6,
        expect=dict(flash=pre["flash_attention"], decode=0))
    _, total_ms, top = profiled_ms(
        torch, lambda: stub_generate(torch, params, cfg, batch, steps)[
            0].shape, top=6,
        expect=dict(flash=counts["flash_attention"],
                    decode=counts["decode_attention"]))
    result = {"config": cfg.name, "rows": b, "prompt_len": s,
              "new_tokens": steps, **walls,
              "decode_step_ms": walls["decode_s"] / steps * 1e3,
              "peak_mem_gib": peak_gib, "launches": counts,
              "part_launches": {part: {**c, "flash_by_shape": {
                  str(key): k for key, k in c["flash_by_shape"].items()}}
                  for part, c in parts.items()},
              "flash_calls": flash_calls,
              "prefill_device_ms": prefill_ms, "prefill_top": prefill_top,
              "serve_top": top}
    if prefill_ms is not None and total_ms is not None:
        step_dev = (total_ms - prefill_ms) / steps
        result.update(
            decode_step_device_ms=step_dev,
            prefill_idle_share=1 - prefill_ms / (walls["prefill_s"] * 1e3),
            decode_idle_share=1 - step_dev / result["decode_step_ms"])
    if cfg.is_encoder_decoder:
        feats = batch["enc_features"]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        M._encode(params, cfg, feats)
        torch.cuda.synchronize()
        result["encoder_s"] = time.perf_counter() - t0
        enc_flash = dict(FA.shape_launches)
        check(enc_flash == {(enc, enc, False): cfg.num_encoder_layers},
              f"{cfg.name}: the encoder's flash launches {enc_flash}")
        _, enc_ms, enc_top = profiled_ms(
            torch, lambda: M._encode(params, cfg, feats).shape, top=6,
            expect=dict(flash=cfg.num_encoder_layers, decode=0))
        result.update(encoder_device_ms=enc_ms, encoder_top=enc_top)
        if enc_ms is not None:
            result["encoder_idle_share"] = 1 - enc_ms / (
                result["encoder_s"] * 1e3)
    print(f"   {cfg.name}: {b} rows x {s} tokens"
          + (f" + {enc} frames" if cfg.is_encoder_decoder
             else f" ({cfg.num_stub_patches} patches)")
          + f", {steps} steps: prefill {walls['prefill_s'] * 1e3:.2f} ms "
          f"wall / {prefill_ms} ms device, decode step "
          f"{result['decode_step_ms']:.2f} ms wall / "
          f"{result.get('decode_step_device_ms')} ms device; idle "
          f"{result.get('prefill_idle_share')} / "
          f"{result.get('decode_idle_share')}; peak {peak_gib:.2f} GiB; "
          f"launches: flash by call {flash_calls}, decode "
          f"{counts['decode_attention']}")
    if cfg.is_encoder_decoder:
        print(f"   encoder: {result['encoder_s'] * 1e3:.2f} ms wall / "
              f"{result['encoder_device_ms']} ms device, idle "
              f"{result.get('encoder_idle_share')}; top {result['encoder_top']}")
    print(f"   top device work: prefill {prefill_top}; serve {top}")
    return result


def serve_prompts(cfg, params, world, data, anchors, lib, qids):
    """The (pairs, L) int32 prompts a serve of ``qids`` builds."""
    import numpy as np
    from repro_torch.api import RouteRequest
    eng = make_engine(cfg, params, anchors, lib, world, data, "cuda")
    st = eng._prepare(RouteRequest([data.queries[q] for q in qids]), False)
    return np.asarray(st.prompts, np.int32)


def paged_vs_dense(torch, cfg, params, prompts):
    """The serve's prompts decoded ``NEW_TOKENS`` steps over a dense cache
    and over 16-token pages: tokens and (YES, NO) logits equal bit for bit
    (the paged kernel's bits are the dense kernel's on the same logical
    cache), paged decode launches a layer and step, no dense decode."""
    from repro_torch import kernels
    from repro_torch.serving import sampler
    from repro_torch.serving.kv_pool import KVPool

    b, L = prompts.shape
    dense = sampler.prefill_state(params, cfg, prompts,
                                  max_new_tokens=NEW_TOKENS)
    _, g0, d0 = sampler.decode_segment(params, cfg, dense, NEW_TOKENS)
    del dense
    pool = KVPool(b * -(-(L + NEW_TOKENS) // PAGE), PAGE)
    kernels.reset_launch_counts()
    paged = sampler.prefill_state(params, cfg, prompts,
                                  max_new_tokens=NEW_TOKENS, kv_pool=pool)
    _, g1, d1 = sampler.decode_segment(params, cfg, paged, NEW_TOKENS)
    counts = kernels.launch_counts()
    want = layer_counts(cfg)[0] * NEW_TOKENS
    check(counts["paged_decode_attention"] == want
          and counts["decode_attention"] == 0,
          f"paged {cfg.name}: launches {counts}, want {want} paged")
    check(torch.equal(g0, g1) and torch.equal(d0, d1),
          f"paged {cfg.name}: paged and dense decode differ")
    print(f"   {cfg.name} paged ({PAGE}-token pages, {pool.pages_peak} "
          f"pages) == dense bit for bit over {NEW_TOKENS} steps; "
          f"{want} paged decode launches")
    return {"launches": counts, "pages_peak": pool.pages_peak}


def stub_launches(cfg, steps: int):
    """(flash, dense decode) launches of a ``stub_generate`` run: flash a
    layer of the prefill (the encoder's layers, and the decoder's twice,
    self and cross, for an encoder-decoder) and a cross layer of each
    decode step; dense decode a layer of each step."""
    n = cfg.num_layers
    if cfg.is_encoder_decoder:
        return cfg.num_encoder_layers + 2 * n + n * steps, n * steps
    return n, n * steps


def stub_card_vs_cpu(torch, cfg, steps: int = 8):
    """The model-level stub serve (``stub_generate``) of the small ``cfg``
    on the card and on the CPU from the same seeded params and stubs: in
    f32 equal greedy tokens and logits within 2e-5; then with the params
    and stubs in bf16, the CPU's greedy tokens fed to both (teacher
    forcing, so a near-tie cannot fork the streams) and logits within
    3e-2, and the two free-running greedy streams compared: equal, or
    parting first at a step where the card's own token and the CPU's are
    within twice that tolerance on the card's logits (a near-tie, the same
    prefix on both sides).  The card's flash and decode launches must be
    ``stub_launches``."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.models.model import init_params

    result = {"config": cfg.name}
    for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        c = dataclasses.replace(cfg, dtype=dtype)
        cpu_params = init_params(c, seed=0, device="cpu")
        batch = stub_batch(torch, c, 3, 20, seed=5, device="cpu")
        toks, logits = stub_generate(torch, cpu_params, c, batch, steps)
        card_params, card_batch = _to(cpu_params, "cuda"), _to(batch, "cuda")
        kernels.reset_launch_counts()
        card_toks, card_logits = stub_generate(
            torch, card_params, c, card_batch, steps,
            forced=None if dtype == "float32" else toks.to(card_batch["tokens"].device))
        counts = kernels.launch_counts()
        err = float((card_logits.cpu() - logits).abs().max())
        check(err <= tol, f"stub {c.name} {dtype}: logits differ by {err}")
        check(bool(torch.isfinite(card_logits).all()),
              f"stub {c.name} {dtype}: non-finite logits")
        if dtype == "float32":
            check(torch.equal(card_toks.cpu(), toks),
                  f"stub {c.name}: greedy tokens differ")
        want = stub_launches(c, steps)
        check((counts["flash_attention"], counts["decode_attention"]) == want,
              f"stub {c.name} {dtype}: launches {counts}, want flash and "
              f"decode {want}")
        result[dtype] = {"logits_max_abs_err": err, "launches": counts}
        print(f"   {c.name} {dtype} stub prefill + {steps} steps: logits "
              f"max_abs_err {err:.3g} (tol {tol}), "
              + ("greedy tokens equal" if dtype == "float32" else
                 "the CPU's tokens fed to both")
              + f"; flash {want[0]}, decode {want[1]} launches")
        if dtype == "bfloat16":
            free_toks, free_logits = stub_generate(torch, card_params, c,
                                                   card_batch, steps)
            free_toks, free_logits = free_toks.cpu(), free_logits.cpu()
            parted = (free_toks != toks).any(0).nonzero().flatten()
            free = {"equal": not len(parted)}
            if len(parted):
                t = int(parted[0])
                rows = (free_toks[:, t] != toks[:, t]).nonzero().flatten()
                lg = free_logits[rows, t]
                margin = float((lg.gather(1, free_toks[rows, t, None].long())
                                - lg.gather(1, toks[rows, t, None].long()))
                               .max())
                free.update(first_parting_step=t, rows=rows.tolist(),
                            margin=margin)
                check(margin <= 2 * tol, f"stub {c.name} bf16: free-running "
                      f"streams part at step {t} with a margin of {margin} "
                      "on the card, not a near-tie")
            result[dtype]["free_running"] = free
            print(f"   {c.name} bf16 free-running greedy streams: "
                  + ("equal" if free["equal"] else
                     f"part first at step {free['first_parting_step']} "
                     f"(rows {free['rows']}), a near-tie: margin "
                     f"{free['margin']:.3g} on the card's logits"))
    return result


def layer_counts(cfg):
    """(attention layer runs, mamba layer runs) of one pass through
    ``cfg``'s stack: a shared block counts at each occurrence."""
    from repro_torch.configs.base import ATTN_KINDS
    from repro_torch.models.transformer import build_plan
    runs = [kind for unit, count in build_plan(cfg) for kind in unit * count]
    return (sum(k in (*ATTN_KINDS, "shared_attn") for k in runs),
            runs.count("mamba"))


def mla_layers(cfg) -> int:
    """MLA layers in one pass through ``cfg``'s stack."""
    from repro_torch.models.transformer import build_plan, is_mla
    return sum(is_mla(k) for unit, count in build_plan(cfg)
               for k in unit * count)


def path_launches(cfg, retrievals: int):
    """Each kernel's launches in ``retrievals`` retrievals, one prefill and
    the decode steps of one ``NEW_TOKENS`` generation through ``cfg``:
    flash and dense decode a layer of GQA attention, flash alone an MLA
    layer (its decode is plain), the SSD scan and step a mamba layer."""
    n_attn, n_mamba = layer_counts(cfg)
    return dict(NO_LAUNCHES, topk_retrieval=retrievals,
                flash_attention=n_attn + mla_layers(cfg),
                decode_attention=n_attn * NEW_TOKENS, ssd_scan=n_mamba,
                ssd_decode_step=n_mamba * NEW_TOKENS)


def tiny_card_vs_cpu(torch, cfg, world, data, anchors, lib, qids):
    """``ScopeEngine.serve`` on the small ``cfg`` with seeded weights, on
    the card (kernels) and on the CPU (plain versions): equal token
    streams, decisions and cache accounting; launch counts of the card's
    runs."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.api import FixedAlphaPolicy, RouteRequest, SetBudgetPolicy
    from repro_torch.models.model import init_params

    cpu_params = init_params(cfg, seed=0, device="cpu")
    engines = {dev: make_engine(cfg, _to(cpu_params, dev), anchors, lib,
                                world, data, dev) for dev in ("cpu", "cuda")}
    kernels.reset_launch_counts()
    # token streams of the estimator on both devices, same prompts
    st = engines["cpu"]._prepare(RouteRequest([data.queries[q]
                                               for q in qids]), False)
    streams = {}
    for dev, eng in engines.items():
        h = eng.estimator.dispatch_batch(st.prompts)
        (g, d), = [tuple(x.cpu().numpy() for x in c) for c in h.chunks]
        streams[dev] = (g, d)
    g_cpu, d_cpu = streams["cpu"]
    g_gpu, d_gpu = streams["cuda"]
    if not np.array_equal(g_cpu, g_gpu):
        bad = np.argwhere(g_cpu != g_gpu)[0]
        raise SmokeFailure(f"tiny: token streams differ first at (row, step) "
                           f"{tuple(bad)}: cpu {g_cpu[tuple(bad)]} "
                           f"cuda {g_gpu[tuple(bad)]}")
    dec_err = float(np.abs(d_cpu - d_gpu).max())
    check(dec_err <= F32_TOL, f"tiny: decision logits differ by {dec_err}")
    pool = engines["cpu"].predict(RouteRequest([data.queries[q]
                                                for q in qids]),
                                  use_cache=False)
    budget = float(pool.cost_hat.min(axis=1).sum() * 1.5)
    result = {"config": cfg.name, "tokens_compared": int(g_cpu.size),
              "dec_max_abs_err": dec_err}
    for policy in (FixedAlphaPolicy(0.7), SetBudgetPolicy(budget)):
        reps = {dev: eng.serve(data, qids, policy)
                for dev, eng in engines.items()}
        a, b = reps["cpu"], reps["cuda"]
        check([x.model for x in a.decisions] == [x.model for x in b.decisions],
              f"tiny {policy.name}: decisions differ")
        p_err = max(abs(x.p_hat - y.p_hat)
                    for x, y in zip(a.decisions, b.decisions, strict=True))
        check(p_err <= F32_TOL, f"tiny {policy.name}: p_hat differs {p_err}")
        check((a.cache_hits, a.cache_misses) == (b.cache_hits, b.cache_misses),
              f"tiny {policy.name}: cache accounting differs")
        result[policy.name] = {"p_hat_max_abs_err": p_err,
                               "models": [x.model for x in b.decisions]}
        print(f"   {policy.name}: {len(b.decisions)} decisions equal, "
              f"p_hat max_abs_err {p_err:.3g}")
    result["launches"] = launches = kernels.launch_counts()
    ran = {k for k, n in path_launches(cfg, 1).items() if n}
    check(all((launches[k] > 0) == (k in ran) for k in
              ("flash_attention", "decode_attention", "ssd_scan",
               "ssd_decode_step")),
          f"tiny {cfg.name}: launches {launches}, expected only {ran}")
    print(f"   {g_cpu.size} tokens equal, decision logits max_abs_err "
          f"{dec_err:.3g}; card launches {result['launches']}")
    return result


def tiny_moe_configs():
    """The small MoE configs of the CPU tests (``tests/test_torch_moe.py``,
    ``tests/test_torch_mla.py``): qwen3-moe-235b-a22b's and
    deepseek-v2-lite-16b's ``reduced()`` (2 layers, d 256, 4 experts of
    512, top-2; qwen3-moe's 4 heads of 64 on 4 with qk-norm, deepseek's
    dense MLA first layer, then MLA + MoE with one shared expert, MLA at
    latent 64, q / k 48, v 32); f32."""
    from repro_torch.configs import get_config
    return [get_config(MOE_Q[1:]).reduced(), get_config(MLA[1:]).reduced()]


def tiny_moe_card_vs_cpu(torch, cfg, world, data, anchors, lib, qids):
    """``tiny_card_vs_cpu`` and the stream (whole-retire and dense refill;
    paged refill too where the config pages) of a small MoE ``cfg``, card
    against CPU, with every router call's smallest margin between a
    token's k-th and (k + 1)-th probability recorded: where a choice flips
    between the devices, the margin it flipped across shows.  Nothing is
    loosened for it: tokens and decisions must be equal."""
    import numpy as np
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.kv_pool import check_paged_support

    try:
        check_paged_support(cfg)
        modes = STREAM_MODES
    except ValueError:
        modes = STREAM_MODES[:2]
    moe_mod.records = []
    try:
        batch = tiny_card_vs_cpu(torch, cfg, world, data, anchors, lib, qids)
        batch_gaps = [float(r["gap"]) for r in moe_mod.records]
        moe_mod.records = []
        stream = tiny_stream_card_vs_cpu(torch, world, data, anchors, lib,
                                         cfg, modes)
        stream_gaps = [float(r["gap"]) for r in moe_mod.records]
    finally:
        moe_mod.records = None
    print(f"   {cfg.name}: {len(batch_gaps)} router calls in the batch "
          f"serves (card and cpu), smallest k-th / (k+1)-th margin "
          f"{min(batch_gaps):.3e}; per call: "
          + " ".join(f"{g:.1e}" for g in batch_gaps[:60]))
    print(f"   {cfg.name}: {len(stream_gaps)} router calls in the streams, "
          f"smallest margin {min(stream_gaps):.3e}, the 5 smallest "
          f"{sorted(stream_gaps)[:5]}")
    return {"batch": batch, "stream": stream,
            "router_gaps": {"batch": batch_gaps, "stream": stream_gaps},
            "smallest_gap": float(np.min(batch_gaps + stream_gaps))}


def moe_prefill(torch, cfg, params, prompts):
    """One prefill of the serve's prompts with each ``moe_forward`` call in
    a profiler range: each MoE layer's dropped choices (of the b * s * k it
    routes) and smallest router margin, and the MoE's share of the
    prefill's device time (the kernels under the ranges over every device
    event but the ranges themselves)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import build_plan, is_moe
    from repro_torch.serving import sampler

    inner = moe_mod.moe_forward

    def ranged(*a, **kw):
        with record_function("moe_forward"):
            return inner(*a, **kw)

    moe_mod.moe_forward, moe_mod.records = ranged, []
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sampler.prefill_state(params, cfg, prompts, max_new_tokens=1)
            torch.cuda.synchronize()
        recs = moe_mod.records
    finally:
        moe_mod.moe_forward, moe_mod.records = inner, None
    dropped = [int(r["dropped"]) for r in recs]
    gaps = [float(r["gap"]) for r in recs]
    events = prof.events()
    total_us = sum(e.device_time_total for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.name != "moe_forward")
    moe_us = sum(e.device_time_total for e in events
                 if e.device_type == DeviceType.CPU
                 and e.name == "moe_forward")
    choices = prompts.size * cfg.num_experts_per_tok
    check(len(recs) == sum(is_moe(k) for unit, count in build_plan(cfg)
                           for k in unit * count),
          f"{cfg.name}: {len(recs)} MoE calls in a prefill")
    share = moe_us / total_us if total_us > 0 else None
    print(f"   {cfg.name} prefill MoE: "
          + (f"{moe_us / 1e3:.2f} of {total_us / 1e3:.2f} ms device time "
             f"({share:.3f})" if share is not None else
             "device time not measured (no device events)")
          + f"; dropped choices per layer (of {choices}): {dropped}; "
          f"smallest router margin {min(gaps):.3e}")
    return {"moe_ms": moe_us / 1e3, "prefill_device_ms": total_us / 1e3,
            "moe_share": share, "dropped_per_layer": dropped,
            "choices_per_layer": choices, "router_gaps": gaps}


def full_params(torch, cfg, min_params: float):
    """``cfg``'s random weights, seeded, on the card."""
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"   init {n_params / 1e9:.3f} B params in "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_params > min_params, f"{cfg.name} has {n_params} params")
    return params, n_params


def full_width(torch, cfg, world, data, anchors, lib, qids, params,
               n_params):
    """``ScopeEngine.serve`` on ``cfg`` at full width: a cold and a warm
    serve with launch counts read around them, then the estimator's
    prefill / decode split and the device's busy time on the same 56
    prompts."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.api import FixedAlphaPolicy, RouteRequest, SetBudgetPolicy
    from repro_torch.serving import sampler

    # warm-up on a throwaway engine (cuBLAS handles, library loads)
    warm = make_engine(cfg, params, anchors, lib, world, data, "cuda")
    warm.serve(data, qids[:1], FixedAlphaPolicy(0.7))
    del warm

    engine = make_engine(cfg, params, anchors, lib, world, data, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rep_a = engine.serve(data, qids, FixedAlphaPolicy(0.7))     # cold cache
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    pool = engine.predict(RouteRequest([data.queries[q] for q in qids]))
    budget = float(pool.cost_hat.min(axis=1).sum() * 1.5)
    t0 = time.perf_counter()
    rep_b = engine.serve(data, qids, SetBudgetPolicy(budget))   # warm cache
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    pairs = len(qids) * len(data.models)
    print(f"   launches {counts}")
    # three retrievals: two serves and the budget probe; one prefill and
    # 12 decode steps of every layer, for the one cold serve: flash and
    # decode attention an attention layer (each occurrence of a shared
    # block), one SSD scan a mamba layer of the prefill and one SSD decode
    # step a mamba layer and step
    want = path_launches(cfg, 3)
    check(counts == want, f"launch counts {counts} != {want}")
    check(rep_a.cache_misses == pairs and rep_b.cache_hits == pairs,
          f"cache accounting {rep_a.cache_misses}/{rep_b.cache_hits}")
    for rep in (rep_a, rep_b):
        check(len(rep.decisions) == len(qids), "one decision per query")
        check(all(np.isfinite([d.p_hat, d.cost_hat]).all()
                  and 0.0 <= d.p_hat <= 1.0 for d in rep.decisions),
              "non-finite or out-of-range estimates")
    check(np.isfinite(pool.p_hat).all() and pool.p_hat.shape == (
        len(qids), len(data.models)), "pool predictions malformed")
    check(rep_a.overhead_tokens > 0, "the cold serve decoded no tokens")

    # prefill / decode split of the estimator on the same 56 prompts
    st = engine._prepare(RouteRequest([data.queries[q] for q in qids]),
                         False)
    prompts = np.asarray(st.prompts, np.int32)
    times = {"prefill_s": [], "decode_s": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = sampler.prefill_state(params, cfg, prompts,
                                      max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        check(bool(torch.isfinite(state.last_logits).all()),
              "non-finite prefill logits")
        _, gen, dec = sampler.decode_segment(params, cfg, state,
                                             NEW_TOKENS)
        g, d = sampler.to_host(gen, dec)
        t2 = time.perf_counter()
        times["prefill_s"].append(t1 - t0)
        times["decode_s"].append(t2 - t1)
    check(g.shape == (pairs, NEW_TOKENS) and np.isfinite(d).all(),
          "generation output malformed")
    busy = device_busy(torch, params, cfg, prompts)
    prefill_s, decode_s = min(times["prefill_s"]), min(times["decode_s"])
    step_ms = decode_s / NEW_TOKENS * 1e3
    result = {
        "config": cfg.name, "params": n_params, "pairs": pairs,
        "prompt_len": int(prompts.shape[1]), "new_tokens": NEW_TOKENS,
        "serve_cold_s": t_cold, "serve_warm_s": t_warm,
        "prefill_s": prefill_s, "decode_s": decode_s,
        "decode_step_ms": step_ms, "device_busy": busy,
        "prefill_idle_share": (None if busy is None else
                               1 - busy["prefill_ms"] / (prefill_s * 1e3)),
        "decode_idle_share": (None if busy is None else
                              1 - busy["decode_step_ms"] / step_ms),
        "peak_mem_gib": peak_gib, "launches": counts,
        "well_formed_frac": float(pool.well_formed.mean()),
    }
    if busy is not None:
        print(f"   device busy: prefill {busy['prefill_ms']:.2f} ms (idle "
              f"share {result['prefill_idle_share']:.3f}), decode step "
              f"{busy['decode_step_ms']:.2f} ms (idle share "
              f"{result['decode_idle_share']:.3f}); top ops: prefill "
              f"{busy['prefill_top']}, decode {busy['top']}")
    print(f"   serve cold {t_cold:.3f} s, warm {t_warm:.4f} s; prefill "
          f"{result['prefill_s']:.4f} s, decode {result['decode_s']:.4f} s "
          f"({result['decode_step_ms']:.2f} ms/step); peak "
          f"{peak_gib:.2f} GiB")
    return result


# ---------------------------------------------------------------------------
# phase 6a: the lint on the card
# ---------------------------------------------------------------------------
LINT_STEPS, LINT_PAGE = 4, 16


def lint_launches(cfg, unit: str):
    """The kernel launches of one runtime-pass unit's window: a decode
    segment launches its decode kernel a layer and step, and a refill
    segment's prefill the flash kernel a layer; tier-0 runs no kernel."""
    n_attn, _ = layer_counts(cfg)
    if unit == "tier0_forward":
        return {}
    decode = "paged_decode_attention" if unit.startswith("paged") else \
        "decode_attention"
    want = {decode: n_attn * LINT_STEPS}
    if "refill" in unit:
        want["flash_attention"] = n_attn
    return want


def lint_phase(torch, cfg, params, rows: int, prompt_len: int, smi: str):
    """scopelint-torch on the card: the runtime pass's five units at full
    width on ``params`` (every check of the module docstring's phase 6a),
    the static pass over the checkout's ``src/repro_torch`` and the
    self-test."""
    from repro_torch.analysis import runtime_pass, scan_paths
    from repro_torch.analysis.runner import iter_py_files
    from repro_torch.analysis.selftest import run_self_test

    t0 = time.perf_counter()
    units = runtime_pass.registered()
    reports = runtime_pass.run_runtime_pass(
        cfg, params, rows=rows, prompt_len=prompt_len, steps=LINT_STEPS,
        page_size=LINT_PAGE)
    out = {"units": {}}
    for rep in reports:
        print(f"   {rep.name}: {rep.ops} ops, syncs {rep.syncs_before} "
              f"before / {rep.syncs_after} after the first launch (op "
              f"#{rep.first_launch}), launches {rep.launches}, "
              f"{rep.seconds:.3f} s  [{smi}]")
        for f in rep.findings:
            print(f"     {f.render()}")
        check(rep.device.startswith("cuda"), f"{rep.name} ran on "
              f"{rep.device}")
        check(not rep.findings, f"lint unit {rep.name}: "
              f"{[f.message for f in rep.findings]}")
        check(rep.syncs_after == 0 and
              rep.syncs_before == units[rep.name].syncs,
              f"lint unit {rep.name}: syncs {rep.syncs_before} / "
              f"{rep.syncs_after}, registry {units[rep.name].syncs}")
        want = lint_launches(cfg, rep.name)
        check(rep.launches == want,
              f"lint unit {rep.name}: launches {rep.launches} != {want}")
        out["units"][rep.name] = {
            "ops": rep.ops, "first_launch": rep.first_launch,
            "syncs_before": rep.syncs_before, "syncs_after": rep.syncs_after,
            "launches": rep.launches, "seconds": rep.seconds}
    check(sorted(out["units"]) == sorted(units),
          f"units run {sorted(out['units'])}")
    runtime_s = time.perf_counter() - t0
    pkg = str(ROOT / "src" / "repro_torch")
    n_files = len(list(iter_py_files([pkg])))
    check(n_files > 50, f"the static pass reads {n_files} files of {pkg}")
    findings = scan_paths([pkg])
    hard = [f.render() for f in findings if not f.suppressed]
    check(not hard, f"static findings {hard}")
    failures = run_self_test()
    check(not failures, f"lint self-test {failures}")
    out.update(runtime_s=runtime_s, files=n_files, static_findings=len(hard),
               suppressed=len(findings) - len(hard),
               seconds=time.perf_counter() - t0)
    print(f"   runtime pass {runtime_s:.2f} s; static pass over {n_files} "
          f"files: 0 findings ({out['suppressed']} suppressed); self-test "
          f"green; "
          f"{out['seconds']:.2f} s in all")
    return out


# ---------------------------------------------------------------------------
# phases 7/8: the streaming serve stack (predict_stream / serve_stream with
# slot refill, dense and block-paged KV)
# ---------------------------------------------------------------------------
def tick_sizes(n_queries: int, seed: int = 0, max_tick: int = 8):
    """Deterministic ragged traffic: tick sizes in [1, max_tick] (a copy of
    benchmarks/bench_serve_throughput.py::_tick_sizes)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes, left = [], n_queries
    while left > 0:
        s = int(rng.integers(1, max_tick + 1))
        sizes.append(min(s, left))
        left -= sizes[-1]
    return sizes


def stream_ticks(data, n_queries: int):
    """The first ``n_queries`` test queries, cut into ragged ticks."""
    qids = [int(q) for q in data.test_qids[:n_queries]]
    ticks, i = [], 0
    for size in tick_sizes(n_queries, seed=0, max_tick=3):
        ticks.append(qids[i: i + size])
        i += size
    return ticks


class StreamProbe:
    """While installed: counts the model's prefill and decode-step calls
    and keeps every host copy the serve path makes (token ids and decision
    logits of each decode segment), by wrapping the module attributes the
    sampler and the estimator call through."""

    def __enter__(self):
        from repro_torch.models import model as M
        from repro_torch.serving import sampler
        self.prefills, self.decode_steps, self.segments = 0, 0, []
        self._saved = (M.prefill, M.decode_step, sampler.to_host)
        prefill, decode_step, to_host = self._saved

        def counted_prefill(*a, **kw):
            self.prefills += 1
            return prefill(*a, **kw)

        def counted_decode_step(*a, **kw):
            self.decode_steps += 1
            return decode_step(*a, **kw)

        def kept_to_host(*a, **kw):
            out = to_host(*a, **kw)
            self.segments.append((out[0].copy(), out[1].copy()))
            return out

        M.prefill, M.decode_step, sampler.to_host = (
            counted_prefill, counted_decode_step, kept_to_host)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as M
        from repro_torch.serving import sampler
        M.prefill, M.decode_step, sampler.to_host = self._saved
        return False


def same_segments(a, b, what: str, tol: float = 0.0):
    """Equal token ids in every decode segment (or parsed window) of two
    runs, decision logits within ``tol``."""
    import numpy as np
    check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} segments")
    err = 0.0
    for i, ((ga, da), (gb, db)) in enumerate(zip(a, b)):
        check(ga.shape == gb.shape and np.array_equal(ga, gb),
              f"{what}: token streams differ in segment {i}")
        err = max(err, float(np.abs(da - db).max()) if da.size else 0.0)
    check(err <= tol, f"{what}: decision logits differ by {err}")
    return err


STAT_FIELDS = ("emitted", "microbatches", "slots_refilled",
               "slot_steps_total", "slot_steps_active", "refill_steps_saved",
               "pages_peak", "kv_peak_tokens", "admissions_deferred_on_pages",
               "admissions_deferred_on_horizon")


STREAM_MODES = (("whole-retire", {}), ("dense", dict(refill=True)),
                ("paged", dict(refill=True, kv_paged=True, kv_page_size=8)))


def tiny_stream_card_vs_cpu(torch, world, data, anchors, lib, cfg=None,
                            modes=STREAM_MODES):
    """``predict_stream`` on ``cfg`` (scope-tiny by default) with seeded
    weights — whole-retire, and slot refill over a dense and a paged
    (8-token pages) KV cache, or the ``modes`` given — on the card and on
    the CPU: equal token streams, parsed fields, decisions and scheduler
    counters; confidences within the float32 tolerance."""
    import numpy as np
    from repro_torch.api import FixedAlphaPolicy, RouteRequest
    from repro_torch.configs.scope_estimator import TINY
    from repro_torch.models.model import init_params
    from repro_torch.serving.scheduler import BucketConfig, MicrobatchScheduler

    cfg = cfg or TINY
    cpu_params = init_params(cfg, seed=0, device="cpu")
    params = {"cpu": cpu_params, "cuda": _to(cpu_params, "cuda")}
    ticks = stream_ticks(data, STREAM_QUERIES)
    policy = FixedAlphaPolicy(0.6)
    result = {}
    for mode, kw in modes:
        runs = {}
        for dev in ("cpu", "cuda"):
            eng = make_engine(cfg, params[dev], anchors, lib, world, data,
                              dev, segment_len=SEGMENT, **kw)
            sched = MicrobatchScheduler(BucketConfig(STREAM_BUCKETS))
            with StreamProbe() as probe:
                pools = list(eng.predict_stream(
                    (RouteRequest([data.queries[q] for q in t])
                     for t in ticks), scheduler=sched, use_cache=False))
            choices = [policy.decide(p, eng).choices for p in pools]
            runs[dev] = (pools, choices, sched.stats, probe.segments)
        (pc, cc, sc, gc), (pg, cg, sg, gg) = runs["cpu"], runs["cuda"]
        dec_err = same_segments(gc, gg, f"tiny {mode} stream", F32_TOL)
        p_err = 0.0
        for a, b in zip(pc, pg, strict=True):
            for f in ("y_hat", "len_hat", "well_formed", "pred_overhead"):
                check(np.array_equal(getattr(a, f), getattr(b, f)),
                      f"tiny {mode} stream: {f} differs card vs cpu")
            p_err = max(p_err, float(np.abs(a.p_hat - b.p_hat).max()))
        check(p_err <= F32_TOL, f"tiny {mode} stream: p_hat differs {p_err}")
        check(all(np.array_equal(a, b) for a, b in zip(cc, cg, strict=True)),
              f"tiny {mode} stream: decisions differ")
        stats = {f: (getattr(sc, f), getattr(sg, f)) for f in STAT_FIELDS}
        check(all(a == b for a, b in stats.values()),
              f"tiny {mode} stream: scheduler counters differ {stats}")
        result[mode] = {"segments": len(gg), "dec_max_abs_err": dec_err,
                        "p_hat_max_abs_err": p_err,
                        "stats": {f: v[1] for f, v in stats.items()}}
        print(f"   {mode}: {len(ticks)} ticks, {len(gg)} segments equal, "
              f"decisions equal, p_hat max_abs_err {p_err:.3g}, counters "
              f"{result[mode]['stats']}")
    return result


def full_stream(torch, world, data, anchors, lib, params):
    """``serve_stream`` on scope-qwen3-4b at full width: refill over the
    block-paged KV (the paged kernel), then over a dense cache with the
    same admission schedule (the dense kernel), then over a dense cache at
    the reference's default horizon.  The first two must agree bit for
    bit; launch counts are read around each run."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.api import FixedAlphaPolicy
    from repro_torch.configs.scope_estimator import CONFIG
    from repro_torch.serving.scheduler import BucketConfig, MicrobatchScheduler

    ticks = stream_ticks(data, STREAM_QUERIES)
    policy = FixedAlphaPolicy(0.6)
    L = CONFIG.num_layers
    # first: a window of segments on one 16-slot state, paged and dense,
    # which also warms the stream's shapes before the timed runs below
    window = segment_window(torch, params, data, ticks, anchors, lib, world)

    def run(name, **kw):
        eng = make_engine(CONFIG, params, anchors, lib, world, data, "cuda",
                          refill=True, segment_len=SEGMENT, **kw)
        sched = MicrobatchScheduler(BucketConfig(STREAM_BUCKETS))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with StreamProbe() as probe:
            t0 = time.perf_counter()
            reports = list(eng.serve_stream(data, ticks, policy,
                                            scheduler=sched, use_cache=False))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        st = sched.stats
        out = {"wall_s": wall, "launches": counts,
               "prefill_calls": probe.prefills,
               "decode_steps": probe.decode_steps,
               "segments": len(probe.segments),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "stats": {f: getattr(st, f) for f in STAT_FIELDS}}
        check(len(reports) == len(ticks) and all(
            len(r.decisions) == len(t) for r, t in zip(reports, ticks)),
            f"{name}: one report per tick, one decision per query")
        check(all(np.isfinite([d.p_hat, d.cost_hat]).all()
                  and 0.0 <= d.p_hat <= 1.0
                  for r in reports for d in r.decisions),
              f"{name}: non-finite or out-of-range estimates")
        check(st.emitted == STREAM_QUERIES * len(data.models),
              f"{name}: {st.emitted} prompts emitted")
        print(f"   {name}: {wall:.3f} s wall, {out['segments']} segments, "
              f"{out['decode_steps']} decode steps, {out['prefill_calls']} "
              f"prefills, launches {counts}, kv_peak_tokens "
              f"{st.kv_peak_tokens}, pages_peak {st.pages_peak}, peak "
              f"{out['peak_mem_gib']:.2f} GiB")
        return reports, probe.segments, out

    rep_p, seg_p, paged = run("paged", kv_paged=True, kv_page_size=PAGE)
    want = dict(NO_LAUNCHES, topk_retrieval=len(ticks),
                flash_attention=L * paged["prefill_calls"],
                paged_decode_attention=L * paged["decode_steps"])
    check(paged["launches"] == want,
          f"paged launches {paged['launches']} != {want}")
    # a dense slot state deep enough to serve the whole stream admits on
    # the same boundaries as the paged one (whose pool never defers)
    rep_d, seg_d, dense = run("dense, matched horizon",
                              refill_horizon=paged["decode_steps"])
    want = dict(want, decode_attention=L * dense["decode_steps"],
                paged_decode_attention=0,
                flash_attention=L * dense["prefill_calls"])
    check(dense["launches"] == want,
          f"dense launches {dense['launches']} != {want}")
    check(dense["decode_steps"] == paged["decode_steps"],
          "dense and paged schedules differ")
    same_segments(seg_p, seg_d, "full-width paged vs dense stream")
    for a, b in zip(rep_p, rep_d, strict=True):
        check([d.model for d in a.decisions] == [d.model for d in b.decisions]
              and [d.p_hat for d in a.decisions]
              == [d.p_hat for d in b.decisions],
              "full-width paged vs dense stream: decisions differ")
    print(f"   paged and dense streams: {len(seg_p)} segments of tokens "
          f"equal, {sum(len(r.decisions) for r in rep_p)} decisions equal")
    _, _, default = run("dense, default horizon")
    return {"config": CONFIG.name, "ticks": [len(t) for t in ticks],
            "pairs": STREAM_QUERIES * len(data.models), "paged": paged,
            "dense_matched": dense, "dense_default": default,
            "window": window}


def segment_window(torch, params, data, ticks, anchors, lib, world,
                   n_seg: int = NEW_TOKENS // SEGMENT):
    """A window of decode segments on one full 16-slot state, paged and
    dense, after one untimed warm-up window: host ms per segment (launch +
    sync) and the device's busy time over the same segments from the
    profiler (CUDA activity), whose ratio is the idle share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import RouteRequest
    from repro_torch.configs.scope_estimator import CONFIG
    from repro_torch.serving.kv_pool import KVPool

    eng = make_engine(CONFIG, params, anchors, lib, world, data, "cuda")
    st = eng._prepare(RouteRequest([data.queries[q] for t in ticks
                                    for q in t][:3]), False)
    prompts = np.asarray(st.prompts[:STREAM_BUCKETS[-1]], np.int32)
    b, width = prompts.shape
    est = eng.estimator

    def open_run(paged):
        if not paged:
            return est.open_slots(prompts, segment_len=SEGMENT)
        pool = KVPool(b * -(-(width + NEW_TOKENS) // PAGE), PAGE)
        return est.open_slots(prompts, segment_len=SEGMENT, kv_pool=pool)

    out = {}
    for name, paged in (("paged", True), ("dense", False)):
        run = open_run(paged)
        for _ in range(n_seg):
            run.launch()
            run.sync()
        run = open_run(paged)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_seg):
            run.launch()
            run.sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_seg
        run = open_run(paged)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n_seg):
                run.launch()
                run.sync()
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy_us = sum(e.self_device_time_total for e in events)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
        res = {"rows": b, "segment_ms": wall_ms,
               "device_ms_per_segment": busy_us / 1e3 / n_seg or None,
               "top": [(e.key[:48], round(e.self_device_time_total
                                          / max(busy_us, 1), 3))
                       for e in top]}
        res["idle_share"] = (None if not busy_us else
                             1 - res["device_ms_per_segment"] / wall_ms)
        out[name] = res
        print(f"   {name} window: {b} slots x {SEGMENT} steps: "
              f"{wall_ms:.2f} ms per segment, device busy "
              f"{res['device_ms_per_segment']} ms, idle share "
              f"{res['idle_share']}; top {res['top']}")
    return out


def device_busy(torch, params, cfg, prompts, steps: int = 4):
    """Device time of one prefill and of a decode step, summed over every
    kernel the profiler saw (``torch.profiler``, CUDA activity), and the
    top operators by device time.  Compared with the unprofiled wall time
    it gives the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import sampler

    def dev_us(events):
        return sum(e.self_device_time_total for e in events)

    def top_ops(events, total, k):
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:k]
        return [(e.key[:100], round(e.self_device_time_total / total, 3))
                for e in top]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state = sampler.prefill_state(params, cfg, prompts,
                                      max_new_tokens=steps)
        torch.cuda.synchronize()
    prefill_events = prof.key_averages()
    prefill_us = dev_us(prefill_events)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sampler.decode_segment(params, cfg, state, steps)
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = dev_us(events)
    if prefill_us <= 0 or total <= 0:       # no CUPTI device activity
        print("   profiler recorded no device time: idle share not measured")
        return None
    return {"prefill_ms": prefill_us / 1e3,
            "decode_step_ms": total / steps / 1e3,
            "prefill_top": top_ops(prefill_events, prefill_us, 6),
            "top": top_ops(events, total, 6)}


# ---------------------------------------------------------------------------
# phases 13/14: two-tier routing (the tier-0 gate) and drift-aware
# self-healing (outcome monitor, model_drift fault, live hot-swap)
# ---------------------------------------------------------------------------
class GateProbe:
    """Wraps an engine's ``_gate_tier0``: per call, the missing pairs before
    and after the gate (the escalated ones), the features, and the call's
    host wall time (the gate ends in a device-to-host copy, so the wall
    covers its device work)."""

    def __init__(self, engine):
        self.calls = []
        inner = engine._gate_tier0

        def gate(st, feats):
            before = st.missing.copy()
            t0 = time.perf_counter()
            inner(st, feats)
            wall = time.perf_counter() - t0
            self.calls.append({"missing": before,
                               "escalated": st.missing.copy(),
                               "feats": feats, "wall_s": wall})
        engine._gate_tier0 = gate

    def split(self):
        """(answered, escalated) (query row, model column) pairs of each
        gated request."""
        out = []
        for c in self.calls:
            esc = {tuple(x) for x in c["escalated"]}
            out.append((sorted({tuple(x) for x in c["missing"]} - esc),
                        sorted(esc)))
        return out


class ParseProbe:
    """While installed: each completed slot row's own window of the decode
    buffer (tokens and decision logits), by its request tag — exactly what
    ``SlotRun.parse_completed`` parses.  Slot rows that are retired or were
    never filled keep decoding filler from the trash page, which duplicate
    index writes leave with unspecified content on the card; nothing reads
    those rows, so runs are compared on the parsed windows."""

    def __enter__(self):
        from repro_torch.core.estimator import SlotRun
        self.rows = {}
        self._saved = SlotRun.parse_completed
        saved, rows = self._saved, self.rows

        def parse_completed(run, completed):
            for r, slot in completed:
                end = min(slot.start + run.budget, run.steps_done)
                rows[slot.tag] = (run._gen[r, slot.start:end].copy(),
                                  run._dec[r, slot.start:end].copy())
            return saved(run, completed)

        SlotRun.parse_completed = parse_completed
        return self

    def __exit__(self, *exc):
        from repro_torch.core.estimator import SlotRun
        SlotRun.parse_completed = self._saved
        return False

    def windows(self):
        """The windows in tag order (request serials in submit order)."""
        return [self.rows[k] for k in sorted(self.rows)]


def midpoint_threshold(conf):
    """A gate threshold between the two adjacent sorted head confidences
    with the widest gap in the middle half, never at a pair's own
    confidence: both sides of the gate are non-empty, and no pair sits
    within float32 noise of it."""
    import numpy as np
    c = np.sort(np.asarray(conf, np.float64).ravel())
    lo, hi = len(c) // 4, 3 * len(c) // 4
    i = lo + int(np.argmax(np.diff(c[lo:hi + 1])))
    check(c[i + 1] - c[i] > 1e-4,
          f"no gap between head confidences near the median: {c[lo:hi]}")
    return float((c[i] + c[i + 1]) / 2)


def head_confidence(engine_fn, data, ticks):
    """The head's confidence max(p, 1 - p) on every (query, model) pair of
    the ticks: a threshold-0 engine answers every pair from the head, so
    its p_hat is the head's calibrated p."""
    import numpy as np
    from repro_torch.api import RouteRequest
    eng = engine_fn(0.0)
    pool = eng.predict(RouteRequest([data.queries[q] for t in ticks
                                     for q in t]), use_cache=False)
    return np.maximum(pool.p_hat, 1.0 - pool.p_hat), pool, eng


def tiny_tiers_card_vs_cpu(torch, world, data, anchors, lib):
    """scope-tiny with seeded weights and a seeded tier-0 head, on the card
    and on the CPU: ``predict_stream`` over paged slot refill with the gate
    at a midpoint threshold (equal answered and escalated pair sets, equal
    escalated token streams, decisions and tier ledger); a dispatch fault
    with ``max_retries=0`` on the whole-retire path (equal
    ``tier0_fallbacks`` and p); and on the card a ``hot_swap`` at a tick
    boundary to a second seeded estimator, whose post-swap ticks must
    equal a fresh engine's on the new weights bit for bit."""
    import numpy as np
    from repro_torch.api import FixedAlphaPolicy, RouteRequest
    from repro_torch.configs.scope_estimator import TINY
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.models import tier0 as T0
    from repro_torch.models.model import init_params
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    from repro_torch.serving.scheduler import BucketConfig, MicrobatchScheduler

    cpu_params = init_params(TINY, seed=0, device="cpu")
    params = {"cpu": cpu_params, "cuda": _to(cpu_params, "cuda")}
    cpu_head = T0.init_tier0(torch.Generator().manual_seed(0), device="cpu")
    heads = {"cpu": T0.Tier0Head(cpu_head),
             "cuda": T0.Tier0Head(_to(cpu_head, "cuda"))}
    ticks = stream_ticks(data, STREAM_QUERIES)
    policy = FixedAlphaPolicy(0.6)
    conf, _, _ = head_confidence(
        lambda thr: make_engine(TINY, params["cpu"], anchors, lib, world,
                                data, "cpu", tier0=heads["cpu"],
                                escalation_threshold=thr), data, ticks)
    thr = midpoint_threshold(conf)
    paged = dict(refill=True, kv_paged=True, kv_page_size=8,
                 segment_len=SEGMENT)

    def engine(dev, **kw):
        return make_engine(TINY, params[dev], anchors, lib, world, data, dev,
                           tier0=heads[dev], escalation_threshold=thr, **kw)

    def requests():
        return (RouteRequest([data.queries[q] for q in t]) for t in ticks)

    runs = {}
    for dev in ("cpu", "cuda"):
        eng = engine(dev, **paged)
        gate = GateProbe(eng)
        sched = MicrobatchScheduler(BucketConfig(STREAM_BUCKETS))
        with ParseProbe() as probe:
            pools = list(eng.predict_stream(requests(), scheduler=sched,
                                            use_cache=False))
        runs[dev] = (pools, [policy.decide(p, eng).choices for p in pools],
                     sched.stats, probe.windows(), gate.split())
    (pc, cc, sc, gc, splc), (pg, cg, sg, gg, splg) = runs["cpu"], runs["cuda"]
    check(splc == splg, "tiny tiers: answered/escalated pairs differ card "
          "vs cpu")
    check(len(gg) == sg.escalated, f"tiny tiers: {len(gg)} parsed rows, "
          f"{sg.escalated} escalated")
    dec_err = same_segments(gc, gg, "tiny tiers: escalated streams", F32_TOL)
    p_err = max(float(np.abs(a.p_hat - b.p_hat).max())
                for a, b in zip(pc, pg, strict=True))
    check(p_err <= F32_TOL, f"tiny tiers: p_hat differs {p_err}")
    for a, b in zip(pc, pg, strict=True):
        for f in ("y_hat", "len_hat", "well_formed", "pred_overhead",
                  "status"):
            check(np.array_equal(getattr(a, f), getattr(b, f)),
                  f"tiny tiers: {f} differs card vs cpu")
    check(all(np.array_equal(a, b) for a, b in zip(cc, cg, strict=True)),
          "tiny tiers: decisions differ")
    tiers = sg.as_dict()["tiers"]
    check(sc.as_dict()["tiers"] == tiers,
          f"tiny tiers: ledgers differ {sc.as_dict()['tiers']} vs {tiers}")
    check(sg.tier0_answered > 0 and sg.escalated > 0
          and sg.submitted == sg.escalated
          and sg.tier0_answered + sg.escalated
          == STREAM_QUERIES * len(data.models),
          f"tiny tiers: ledger {tiers}, submitted {sg.submitted}")
    print(f"   threshold {thr:.6f}: {tiers}; {len(gg)} escalated token "
          f"streams equal, decisions equal, p_hat max_abs_err {p_err:.3g}")

    # the fallback rung: the first microbatch's dispatch fails and, with no
    # retry, its rows are answered from their stashed tier-0 rows
    fb = {}
    for dev in ("cpu", "cuda"):
        eng = engine(dev, max_retries=0,
                     fault_plan=FaultPlan([FaultSpec("dispatch", 0)]))
        sched = MicrobatchScheduler(BucketConfig(STREAM_BUCKETS))
        pools = list(eng.predict_stream(requests(), scheduler=sched,
                                        use_cache=False))
        fb[dev] = (np.concatenate([p.p_hat.ravel() for p in pools]),
                   sched.stats.tier0_fallbacks, sched.stats.quarantined)
    fb_err = float(np.abs(fb["cpu"][0] - fb["cuda"][0]).max())
    check(fb["cpu"][1:] == fb["cuda"][1:] and fb["cuda"][1] > 0
          and fb["cuda"][1] == fb["cuda"][2],
          f"tiny tiers fallback: (fallbacks, quarantined) cpu {fb['cpu'][1:]}"
          f" cuda {fb['cuda'][1:]}")
    check(fb_err <= F32_TOL, f"tiny tiers fallback: p_hat differs {fb_err}")
    print(f"   dispatch fault, max_retries 0: {fb['cuda'][1]} tier-0 "
          f"fallbacks on both, p_hat max_abs_err {fb_err:.3g}")

    # hot_swap at a tick boundary: every tick emitted at once and decoded
    # in one segment of the whole budget, so it drains before the next
    params_b = init_params(TINY, seed=1, device="cuda")
    swap_at = len(ticks) // 2
    one_seg = dict(paged, segment_len=NEW_TOKENS)

    def serve(eng, ticks_, swap=False):
        sched = MicrobatchScheduler(BucketConfig(STREAM_BUCKETS),
                                    max_queue_age=0.0)
        reports = []
        with ParseProbe() as probe:
            for i, r in enumerate(eng.serve_stream(data, ticks_, policy,
                                                   scheduler=sched,
                                                   use_cache=False)):
                reports.append(r)
                if swap and i == swap_at - 1:
                    probe.rows.clear()
                    eng.hot_swap(ReasoningEstimator(
                        TINY, params_b, max_new_tokens=NEW_TOKENS), "v1",
                        tier0=heads["cuda"])
        return reports, probe.windows(), sched.stats

    swapped, seg_s, st_s = serve(engine("cuda", **one_seg), ticks, swap=True)
    fresh = make_engine(TINY, params_b, anchors, lib, world, data, "cuda",
                        tier0=heads["cuda"], escalation_threshold=thr,
                        **one_seg)
    want, seg_f, _ = serve(fresh, ticks[swap_at:])
    check(len(seg_s) > 0, "tiny hot_swap: no post-swap decode")
    same_segments(seg_s, seg_f, "tiny hot_swap vs fresh engine")
    for a, b in zip(swapped[swap_at:], want, strict=True):
        check([(d.model, d.p_hat, d.cost_hat) for d in a.decisions]
              == [(d.model, d.p_hat, d.cost_hat) for d in b.decisions]
              and a.overhead_tokens == b.overhead_tokens,
              "tiny hot_swap: post-swap ticks differ from a fresh engine")
    check(st_s.hot_swaps == 1, f"tiny hot_swap: hot_swaps {st_s.hot_swaps}")
    print(f"   hot_swap after tick {swap_at}: {len(ticks) - swap_at} ticks, "
          f"{len(seg_s)} token streams equal a fresh engine's bit for bit")
    return {"threshold": thr, "tiers": tiers, "dec_max_abs_err": dec_err,
            "p_hat_max_abs_err": p_err, "escalated_streams": len(gg),
            "fallbacks": fb["cuda"][1], "fallback_p_max_abs_err": fb_err,
            "hot_swap_streams": len(seg_s)}


def full_tiers(torch, world, data, anchors, lib, smi):
    """``serve_stream`` over the paged KV on scope-qwen3-4b at full width
    (phase 8's 112 pairs in the same ragged ticks) with the tier-0 gate on
    at the median confidence of the head's probe, ``drift_detect`` on, a
    ``model_drift`` fault armed, and one ``hot_swap`` after the fifth tick
    to a second seeded full-width weight set (the same head re-stamped).
    Checks the tier ledger, the launch counts and finite outputs; reports
    the gate's wall and device time per request, the stream's wall and
    idle share, and peak memory."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.api import FixedAlphaPolicy
    from repro_torch.configs.scope_estimator import CONFIG
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.models import tier0 as T0
    from repro_torch.models.model import init_params
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    from repro_torch.serving.scheduler import BucketConfig, MicrobatchScheduler

    L = CONFIG.num_layers
    ticks = stream_ticks(data, STREAM_QUERIES)
    pairs = STREAM_QUERIES * len(data.models)
    policy = FixedAlphaPolicy(0.6)
    params_a, _ = full_params(torch, CONFIG, 3.9e9)
    params_b = init_params(CONFIG, seed=1, device="cuda")
    head = T0.Tier0Head(T0.init_tier0(
        torch.Generator(device="cuda").manual_seed(0), device="cuda"))

    def engine(thr, **kw):
        return make_engine(CONFIG, params_a, anchors, lib, world, data,
                           "cuda", tier0=head, escalation_threshold=thr, **kw)

    conf, probe_pool, probe_eng = head_confidence(engine, data, ticks)
    thr = float(np.median(conf))
    counts = np.bincount(policy.decide(probe_pool, probe_eng).choices,
                         minlength=len(data.models))
    victim = data.models[int(np.argmax(counts))]
    swap_at = 5

    def run(profiled: bool):
        eng = engine(thr, refill=True, segment_len=SEGMENT, kv_paged=True,
                     kv_page_size=PAGE, drift_detect=True,
                     fault_plan=FaultPlan([FaultSpec(
                         "model_drift", 8, arg=1.0, model=victim)]))
        gate = GateProbe(eng)
        sched = MicrobatchScheduler(BucketConfig(STREAM_BUCKETS))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        prof = (profile(activities=[ProfilerActivity.CUDA]) if profiled
                else contextlib.nullcontext())
        with StreamProbe() as probe, prof:
            t0 = time.perf_counter()
            reports = []
            for i, r in enumerate(eng.serve_stream(data, ticks, policy,
                                                   scheduler=sched,
                                                   use_cache=False)):
                reports.append(r)
                if i == swap_at - 1:
                    eng.hot_swap(ReasoningEstimator(
                        CONFIG, params_b, max_new_tokens=NEW_TOKENS), "v1",
                        tier0=head)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_ms = (sum(e.self_device_time_total for e in prof.key_averages())
                   / 1e3 if profiled else None)
        return dict(eng=eng, gate=gate, stats=sched.stats, reports=reports,
                    probe=probe, wall_s=wall, busy_ms=busy_ms,
                    launches=kernels.launch_counts(),
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

    main = run(profiled=False)
    st, probe = main["stats"], main["probe"]
    tiers, drift = st.as_dict()["tiers"], st.as_dict()["drift"]
    print(f"   threshold {thr:.6f} (median head confidence), drift on "
          f"{victim}: tiers {tiers}; drift {drift}")
    check(st.tier0_answered + st.escalated == pairs,
          f"full tiers: answered {st.tier0_answered} + escalated "
          f"{st.escalated} != {pairs}")
    check(st.tier0_answered > 0 and st.escalated > 0,
          f"full tiers: one side of the gate is empty {tiers}")
    check(st.submitted == st.escalated,
          f"full tiers: submitted {st.submitted} != escalated {st.escalated}")
    check(st.tier0_decode_tokens_saved == st.tier0_answered * NEW_TOKENS,
          f"full tiers: tokens saved {st.tier0_decode_tokens_saved}")
    check(st.hot_swaps == 1, f"full tiers: hot_swaps {st.hot_swaps}")
    check(st.replay_buffer_len == STREAM_QUERIES,
          f"full tiers: replay buffer {st.replay_buffer_len} rows")
    want = dict(NO_LAUNCHES, topk_retrieval=len(ticks),
                flash_attention=L * probe.prefills,
                paged_decode_attention=L * probe.decode_steps)
    check(main["launches"] == want,
          f"full tiers: launches {main['launches']} != {want}")
    check(probe.decode_steps > 0
          and all(np.isfinite(d).all() for _, d in probe.segments),
          "full tiers: no decode or non-finite decision logits")
    check(len(main["reports"]) == len(ticks) and all(
        len(r.decisions) == len(t) and all(
            np.isfinite(d.p_hat) and 0.0 <= d.p_hat <= 1.0
            for d in r.decisions)
        for r, t in zip(main["reports"], ticks)),
        "full tiers: reports malformed")

    # the gate alone: the same calls replayed on the head, unprofiled for
    # the wall and under the profiler for the device time
    feats = [c["feats"] for c in main["gate"].calls]
    for f in feats:                          # warm
        head.predict_features(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in feats:
        head.predict_features(f)
    gate_wall_ms = (time.perf_counter() - t0) * 1e3 / len(feats)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for f in feats:
            head.predict_features(f)
        torch.cuda.synchronize()
    gate_dev_ms = sum(e.self_device_time_total
                      for e in prof.key_averages()) / 1e3 / len(feats)
    in_stream_ms = float(np.mean([c["wall_s"] for c in main["gate"].calls])
                         ) * 1e3

    shadow = run(profiled=True)
    check(shadow["stats"].as_dict()["tiers"] == tiers,
          "full tiers: the profiled run gated differently")
    idle = (None if not shadow["busy_ms"] else
            1 - shadow["busy_ms"] / (main["wall_s"] * 1e3))
    out = {"config": CONFIG.name, "card": smi, "pairs": pairs,
           "ticks": [len(t) for t in ticks], "threshold": thr,
           "drift_model": victim, "tiers": tiers, "drift": drift,
           "gate_requests": len(feats),
           "gate_pairs": [len(f) for f in feats],
           "gate_wall_ms_per_request": gate_wall_ms,
           "gate_wall_ms_per_request_in_stream": in_stream_ms,
           "gate_device_ms_per_request": gate_dev_ms or None,
           "stream_wall_s": main["wall_s"],
           "stream_device_busy_ms": shadow["busy_ms"] or None,
           "stream_idle_share": idle, "peak_mem_gib": main["peak_gib"],
           "launches": main["launches"], "prefill_calls": probe.prefills,
           "decode_steps": probe.decode_steps,
           "segments": len(probe.segments)}
    print(f"   gate: {len(feats)} requests, {gate_wall_ms:.3f} ms wall "
          f"({in_stream_ms:.3f} ms in the stream), {gate_dev_ms:.4f} ms "
          f"device per request; stream {main['wall_s']:.3f} s wall, device "
          f"busy {shadow['busy_ms']} ms, idle share {idle}; "
          f"{probe.decode_steps} decode steps, {probe.prefills} prefills, "
          f"launches {main['launches']}, peak {main['peak_gib']:.2f} GiB "
          f"({smi})")
    return out


# ---------------------------------------------------------------------------
# phases 15-17: training (SFT and GRPO through the flash forward and
# backward kernels) and the train / serve CLIs
# ---------------------------------------------------------------------------
class StepProbe:
    """While installed: each ``grpo_step``'s batch (tokens, mask,
    advantages, old and reference log-probs) and loss."""

    def __enter__(self):
        from repro_torch.training import grpo
        self.steps = []
        self._saved = grpo.grpo_step
        saved, steps = self._saved, self.steps

        def grpo_step(params, cfg, opt_state, batch, *args):
            out = saved(params, cfg, opt_state, batch, *args)
            steps.append({"batch": {k: v.cpu() for k, v in batch.items()},
                          "loss": float(out[2]),
                          "metrics": {k: float(v) for k, v in
                                      out[3].items()}})
            return out

        grpo.grpo_step = grpo_step
        return self

    def __exit__(self, *exc):
        from repro_torch.training import grpo
        grpo.grpo_step = self._saved
        return False


def grpo_trainer(torch, cfg, params, device, *, tasks, group, temperature,
                 seed=0):
    """A GRPO trainer on a fresh world (``World.embed`` draws from the
    world's generator, so two trainers compared build two worlds)."""
    from repro_torch.core.retrieval import AnchorRetriever
    from repro_torch.training.grpo import GRPOConfig, GRPOTrainer
    world, data, anchors, lib = build_world()
    return GRPOTrainer(
        cfg, params, data, lib, AnchorRetriever(anchors, device=device),
        gcfg=GRPOConfig(group_size=group, tasks_per_step=tasks,
                        temperature=temperature, max_new_tokens=NEW_TOKENS),
        seed=seed, generator=torch.Generator(device=device).manual_seed(seed))


def train_calls(cfg, s: int):
    """{(sq, sk, causal): flash calls} of one forward pass of ``cfg`` over
    ``s``-token sequences: a causal call an attention or MLA layer (a
    shared block's at each occurrence); an encoder-decoder's encoder
    layers also one each, non-causal over its frames, and its decoder
    layers a cross-attention call each, the ``s`` rows over the frames."""
    from collections import Counter
    n_attn, _ = layer_counts(cfg)
    calls = Counter({(s, s, True): n_attn + mla_layers(cfg)})
    if cfg.is_encoder_decoder:
        frames = cfg.encoder_seq_len
        calls[(frames, frames, False)] += cfg.num_encoder_layers
        calls[(s, frames, False)] += n_attn
    return +calls


def train_launches(cfg, steps: int, s: int):
    """Each kernel's launches in ``steps`` SFT steps of ``cfg`` over
    ``s``-token sequences with one checkpoint a layer, and the flash
    forward's and backward's launches by (sq, sk, causal)
    (``train_calls``): every flash call runs in the forward and again in
    its layer's recompute, and its backward once; a mamba layer two scans
    and one SSD backward."""
    from collections import Counter
    calls = train_calls(cfg, s)
    n, n_mamba = sum(calls.values()), layer_counts(cfg)[1]
    counts = dict(NO_LAUNCHES, flash_attention=2 * n * steps,
                  flash_attention_bwd=n * steps,
                  ssd_scan=2 * n_mamba * steps, ssd_scan_bwd=n_mamba * steps)
    return (counts, Counter({k: 2 * v * steps for k, v in calls.items()}),
            Counter({k: v * steps for k, v in calls.items()}))


def train_counts():
    """This run's launches: (each kernel's, the flash forward's and
    backward's by (sq, sk, causal)), as ``train_launches`` gives them."""
    from collections import Counter
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as FA
    return (kernels.launch_counts(), Counter(FA.shape_launches),
            Counter(FA.bwd_shape_launches))


def sft_card_vs_cpu(torch, cfg, ds, cpu_params):
    """Ten SFT steps of ``cfg`` from ``cpu_params`` on the card and on the
    CPU through ``train_sft`` (a multimodal config's steps with its stub
    inputs, ``pipeline.with_stubs``): losses within 1e-4, the first within
    2e-5; the card's launches those of ``train_launches``.  Returns
    (trained params by device, losses by device, the largest loss
    difference, the card's launches)."""
    from repro_torch import kernels
    from repro_torch.training.sft import train_sft

    trained, losses, counts = {}, {}, {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        trained[dev], losses[dev] = train_sft(
            _to(cpu_params, dev), cfg, ds, steps=SFT_STEPS_TINY,
            batch_size=32)
        counts[dev] = train_counts()
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"],
                                         strict=True))
    check(abs(losses["cpu"][0] - losses["cuda"][0]) <= F32_TOL,
          f"{cfg.name} sft: first loss {losses['cpu'][0]} vs "
          f"{losses['cuda'][0]}")
    check(err <= 1e-4, f"{cfg.name} sft: losses differ by {err}")
    # a VLM's patches stand in front of the text (with_stubs)
    want = train_launches(cfg, SFT_STEPS_TINY,
                          ds["tokens"].shape[1] + cfg.num_stub_patches)
    check(counts["cuda"] == want,
          f"{cfg.name} sft launches {counts['cuda']} != {want}")
    print(f"   sft {SFT_STEPS_TINY} steps: losses {losses['cuda'][0]:.6f} -> "
          f"{losses['cuda'][-1]:.6f}, card vs cpu max_abs_err {err:.3g}; "
          f"card launches {counts['cuda'][0]}")
    return trained, losses, err, counts["cuda"][0]


def grpo_card_vs_cpu(torch, cfg, cpu_params):
    """One greedy GRPO step of the text-only ``cfg`` from ``cpu_params`` on
    the card and on the CPU: equal rollout tokens, advantages and rewards;
    loss, pg and kl within 2e-5."""
    runs = {}
    for dev in ("cpu", "cuda"):
        trainer = grpo_trainer(torch, cfg, _to(cpu_params, dev), dev,
                               tasks=4, group=2, temperature=0.0)
        with StepProbe() as probe:
            info = trainer.rollout_step()
        runs[dev] = (info, probe.steps[0])
    (ia, sa), (ib, sb) = runs["cpu"], runs["cuda"]
    check(torch.equal(sa["batch"]["tokens"], sb["batch"]["tokens"]),
          f"{cfg.name} grpo: greedy rollouts differ")
    check(torch.equal(sa["batch"]["adv"], sb["batch"]["adv"])
          and ia["reward"] == ib["reward"]
          and ia["format_rate"] == ib["format_rate"],
          f"{cfg.name} grpo: rewards or advantages differ")
    err = max(abs(sa["loss"] - sb["loss"]),
              *(abs(sa["metrics"][k] - sb["metrics"][k])
                for k in ("pg", "kl")))
    check(err <= F32_TOL, f"{cfg.name} grpo: loss/pg/kl differ by {err}")
    print(f"   greedy grpo step: {tuple(sb['batch']['tokens'].shape)} rollout "
          f"tokens equal, reward {ib['reward']:.4f} format_rate "
          f"{ib['format_rate']:.3f}, loss {sb['loss']:.6g} (max_abs_err "
          f"{err:.3g})")
    return {"grpo_max_abs_err": err, "grpo_cuda": ib}


def profiled_ms(torch, fn, top: int = 8, expect=None):
    """(result, device ms summed over every kernel the profiler saw, or None
    when CUPTI reports no device activity, and the ``top`` kernels by
    device time as (name, ms, launches)).  Given ``expect`` ({kernel of
    KERNEL_EVENTS: launches}), a profile whose events of each kernel do
    not number its launches has lost events: ``fn`` is profiled again, and
    after three such profiles the phase fails."""
    from torch.profiler import ProfilerActivity, profile
    attempts = 3
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        seen = {name: sum(e.count for e in events
                          if re.search(KERNEL_EVENTS[name], e.key))
                for name in expect or {}}
        if not any(e.self_device_time_total > 0 for e in events) or \
                seen == (expect or {}):
            break
        print(f"   profile {attempt} saw kernel events {seen}, want "
              f"{expect}: events lost")
        check(attempt < attempts, f"{attempts} profiles lost kernel events: "
              f"saw {seen}, want {expect}")
    us = sum(e.self_device_time_total for e in events)
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return out, (us / 1e3 if us > 0 else None), [
        (e.key[:90], round(e.self_device_time_total / 1e3, 3), e.count)
        for e in ranked]


def sft_steps(torch, cfg, params, ds, batch_size: int = SFT_BATCH):
    """``SFT_STEPS_FULL`` SFT steps of ``batch_size`` sequences on
    ``cfg``'s ``params`` (trained in place; AdamW, lr 1e-5; a multimodal
    config's batches with its stub inputs, ``pipeline.with_stubs``), the
    last one under the profiler: each step's loss, accuracy, wall and
    device time, the launches (``train_launches``: one checkpoint a layer;
    the flash calls by shape), peak memory, finite losses and params.  The
    optimizer state is freed on return."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.data.pipeline import batches, with_stubs
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.sft import sft_step

    opt_cfg = AdamWConfig(lr=1e-5, warmup_steps=2, total_steps=100)
    opt_state = adamw_init(params)
    it = batches(ds, batch_size, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    steps = []
    for i in range(SFT_STEPS_FULL):
        batch = with_stubs(next(it), cfg, seed=i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == SFT_STEPS_FULL - 1:        # the last step under the profiler
            out, dev_ms, top = profiled_ms(
                torch, lambda b=batch, p=params, s=opt_state: sft_step(
                    p, cfg, s, b, opt_cfg))
        else:
            out = sft_step(params, cfg, opt_state, batch, opt_cfg)
            torch.cuda.synchronize()
            dev_ms = None
        wall = time.perf_counter() - t0
        params, opt_state, loss, metrics = out
        steps.append({"loss": float(loss), "acc": float(metrics["acc"]),
                      "wall_s": wall, "device_ms": dev_ms})
        print(f"   sft step {i + 1}: loss {float(loss):.4f} acc "
              f"{float(metrics['acc']):.4f} wall {wall:.3f} s"
              + ("" if dev_ms is None else f" device {dev_ms:.1f} ms"))
    counts, fwd_shapes, bwd_shapes = train_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = train_launches(cfg, SFT_STEPS_FULL, batch["tokens"].shape[1])
    check((counts, fwd_shapes, bwd_shapes) == want,
          f"{cfg.name} sft launches {counts}, flash by shape {fwd_shapes} / "
          f"{bwd_shapes} != {want}")
    check(all(np.isfinite(st["loss"]) for st in steps),
          f"{cfg.name}: non-finite SFT loss")
    check(all(bool(torch.isfinite(t).all()) for t in _leaves(params)),
          f"{cfg.name}: non-finite params after SFT")
    del out, opt_state                   # the moments (30 GiB for qwen)
    release(torch)
    print(f"   sft batch {tuple(batch['tokens'].shape)}; launches {counts}; "
          f"peak {peak:.2f} GiB; top device work of the profiled step "
          f"(name, ms, calls): {top}")
    return {"sft_batch": list(batch["tokens"].shape), "sft_steps": steps,
            "sft_launches": counts, "sft_peak_gib": peak, "sft_top": top,
            "sft_bwd_shapes": {str(k): v for k, v in bwd_shapes.items()}}


def full_train(torch, ds):
    """scope-qwen3-4b at full width from seeded random weights: three SFT
    steps of 64 sequences (``sft_steps``; launches: 2 x 36 forward flash
    calls a step, one a layer in the forward and one in its checkpoint's
    recompute, and 36 backward calls), then one GRPO step (16 tasks x group
    4, 12 new tokens, temperature 1): loss, reward, format rate, step wall
    and device time, peak memory."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs.scope_estimator import CONFIG

    params, n_params = full_params(torch, CONFIG, 3.9e9)
    L = CONFIG.num_layers
    sft = sft_steps(torch, CONFIG, params, ds)

    trainer = grpo_trainer(torch, CONFIG, params, "cuda", tasks=16, group=4,
                           temperature=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with StepProbe() as probe:
        info, grpo_dev_ms, grpo_top = profiled_ms(torch,
                                                  trainer.rollout_step)
    grpo_counts = kernels.launch_counts()
    grpo_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    info2 = trainer.rollout_step()                  # unprofiled, for wall
    torch.cuda.synchronize()
    grpo_wall = time.perf_counter() - t0
    grpo_peak = max(grpo_peak, torch.cuda.max_memory_allocated() / 2 ** 30)
    tokens = probe.steps[0]["batch"]["tokens"]
    check(tuple(tokens.shape) == (64, tokens.shape[1])
          and np.isfinite([info["loss"], info["kl"], info2["loss"]]).all(),
          f"grpo step malformed: {tuple(tokens.shape)} {info}")
    # one prefill and 12 decode steps of the rollouts, two no-grad
    # forwards (old and reference log-probs), the loss's forward and its
    # recompute: 36 x 5 forward flash calls, 36 backward calls
    check(grpo_counts["flash_attention"] == 5 * L
          and grpo_counts["flash_attention_bwd"] == L
          and grpo_counts["decode_attention"] == L * NEW_TOKENS,
          f"grpo launches {grpo_counts}")
    print(f"   grpo step: rollouts {tuple(tokens.shape)}, reward "
          f"{info['reward']:.4f} format_rate {info['format_rate']:.3f} loss "
          f"{info['loss']:.6g} kl {info['kl']:.3g}; device "
          f"{grpo_dev_ms} ms (profiled), wall {grpo_wall:.3f} s (second "
          f"step, unprofiled); launches {grpo_counts}; peak "
          f"{grpo_peak:.2f} GiB; top device work (name, ms, calls): "
          f"{grpo_top}")
    del trainer, params
    release(torch)
    return {"config": CONFIG.name, "params": n_params, **sft,
            "grpo_top": grpo_top,
            "grpo": info, "grpo_second": info2,
            "grpo_rollouts": list(tokens.shape),
            "grpo_device_ms": grpo_dev_ms, "grpo_wall_s": grpo_wall,
            "grpo_launches": grpo_counts, "grpo_peak_gib": grpo_peak}


def tiny_grads_card_vs_cpu(torch, cfg, ds, grpo: bool = False):
    """The small ``cfg`` (f32) from the same seeded port params on the card
    and on the CPU: the loss and every gradient leaf of one SFT batch (a
    multimodal config's with its stub inputs; loss within 2e-5, each leaf
    within 1e-4 of that leaf's largest magnitude: the two backward passes
    sum in other orders, and on the card the MoE's index ops with
    atomics), then ten SFT steps (``sft_card_vs_cpu``) and, with ``grpo``,
    one greedy GRPO step (``grpo_card_vs_cpu``); the card's launches.  At
    57 tokens the small SSM configs' chunk is 3: the SSD backward runs 19
    chunks with the state terms."""
    from repro_torch.data.pipeline import batches, with_stubs
    from repro_torch.io import flatten
    from repro_torch import kernels
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import value_and_grad

    cpu_params = M.init_params(cfg, seed=0, device="cpu")
    batch = with_stubs(next(batches(ds, 32, seed=0, device="cpu")), cfg,
                       seed=0)
    runs = {}
    for dev in ("cpu", "cuda"):
        b = {k: v.to(dev) for k, v in batch.items()}
        kernels.reset_launch_counts()
        loss, _, grads = value_and_grad(lambda p, b=b: M.loss_fn(p, cfg, b),
                                        _to(cpu_params, dev))
        runs[dev] = (float(loss), flatten(grads), train_counts())
    (lc, gc, _), (lg, gg, counts) = runs["cpu"], runs["cuda"]
    check(abs(lc - lg) <= F32_TOL, f"{cfg.name}: loss {lc} vs {lg}")
    check(list(gc) == list(gg), f"{cfg.name}: gradient trees differ")
    worst = 0.0
    for key, w in gc.items():
        top = max(w.abs().max().item(), 1e-30)
        err = (gg[key].cpu().float() - w.float()).abs().max().item() / top
        check(err <= 1e-4 and top > 1e-30,
              f"{cfg.name} grad {key}: err {err} x max|want|, max {top}")
        worst = max(worst, err)
    want = train_launches(cfg, 1, batch["tokens"].shape[1])
    check(counts == want, f"{cfg.name} loss launches {counts} != {want}")
    print(f"   {cfg.name}: loss {lg:.6f} (cpu {lc:.6f}); {len(gc)} gradient "
          f"leaves, worst err {worst:.3g} x the leaf's max; launches "
          f"{counts[0]}, flash by (sq, sk, causal) {dict(counts[1])}")

    trained, losses, err, counts = sft_card_vs_cpu(torch, cfg, ds,
                                                   cpu_params)
    out = {"loss": lg, "grad_worst_rel": worst, "sft_losses": losses,
           "sft_max_abs_err": err, "launches": counts}
    if grpo:
        out.update(grpo_card_vs_cpu(torch, cfg, trained["cpu"]))
    return out


def grads_vs_plain(torch, cfg, params, ds):
    """Every gradient leaf of one SFT batch of ``cfg`` with the SSD scan
    backward kernel against the same loss with its plain version
    (``ssd_scan_bwd_plain``, float32 on the card): the worst leaf's max
    |diff| over its max |plain|, and the share of elements whose signs
    differ, which AdamW's first, sign-like steps follow.  Both run in the
    bf16 model, whose rounding sets the difference (~3e-2 of a leaf's max
    at mamba2-1.3b): held within 0.1."""
    from repro_torch import io
    from repro_torch.data.pipeline import batches
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models.model import loss_fn
    from repro_torch.training.optimizer import value_and_grad

    batch = next(batches(ds, SFT_BATCH, seed=0, device="cuda"))

    def leaves():
        return io.flatten(value_and_grad(lambda p: loss_fn(p, cfg, batch),
                                         params)[2])

    before = SS.bwd_launches
    got = leaves()
    check(SS.bwd_launches > before,
          f"{cfg.name}: the kernel pass launched no SSD backward kernel")
    kernel = SS.ssd_scan_bwd_cuda
    SS.ssd_scan_bwd_cuda = lambda x, dt, A, B, C, dy, dstate, states, *, \
        chunk: SS.ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate, chunk=chunk)
    before = SS.bwd_launches
    try:
        want = leaves()
    finally:
        SS.ssd_scan_bwd_cuda = kernel
    check(SS.bwd_launches == before,
          f"{cfg.name}: the plain pass launched the SSD backward kernel")
    worst, name, flips, total = 0.0, None, 0, 0
    for key, w in want.items():
        g, w = got[key].float(), w.float()
        check(bool(torch.isfinite(g).all()), f"{cfg.name} {key}: non-finite")
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if rel >= worst:
            worst, name = rel, key
        flips += int(((g > 0) != (w > 0)).sum())
        total += w.numel()
    del got, want
    release(torch)
    print(f"   gradient leaves, SSD backward kernel vs plain (one batch): "
          f"worst {worst:.3g} of its leaf's max ({name}); signs differing "
          f"{flips / total:.3g} of {total} elements")
    check(worst <= 0.1, f"{cfg.name}: leaf {name} {worst} > 0.1")
    return {"worst_leaf": worst, "worst_leaf_name": name,
            "sign_flip_share": flips / total}


def full_ssm_train(torch, cfg, ds, min_params: float):
    """``cfg`` at full width from seeded random weights: its gradient
    leaves with the SSD backward kernel against its plain version
    (``grads_vs_plain``), then ``sft_steps`` (one checkpoint a layer, so
    two scans and one SSD backward a mamba layer a step, and for a hybrid
    two flash forwards and one backward at each shared-block occurrence);
    the weights freed after."""
    params, n_params = full_params(torch, cfg, min_params)
    vs_plain = grads_vs_plain(torch, cfg, params, ds)
    sft = sft_steps(torch, cfg, params, ds)
    del params
    release(torch)
    return {"config": cfg.name, "num_layers": cfg.num_layers,
            "params": n_params, "grads_vs_plain": vs_plain, **sft}


def full_family_train(torch, name, least, layers, batch, ds):
    """``name`` at full width from seeded random weights, cut to its first
    ``layers`` layers where given: ``sft_steps`` of ``batch`` sequences
    (one checkpoint a layer; the flash forward twice and its backward
    once a layer, by shape); the weights freed after."""
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(name)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    if layers is not None:
        print(f"   cut: {name} at full width (d {cfg.d_model}, "
              f"{cfg.num_heads} heads on {cfg.num_kv_heads}) and {layers} of "
              f"its {full.num_layers} layers: every layer's weights, "
              "gradients and AdamW moments do not fit the card")
    params, n_params = full_params(torch, cfg, least)
    sft = sft_steps(torch, cfg, params, ds, batch)
    del params
    release(torch)
    return {"config": name, "num_layers": cfg.num_layers,
            "params": n_params, **sft}


# ---------------------------------------------------------------------------
# phase 22: the planning path, every (arch, input shape) step on the card
# ---------------------------------------------------------------------------
# (arch, shape) -> (num_layers, rows) of its card run, None = the config's
# depth / the shape's batch.  Each step runs at its shape's own seq_len; the
# cuts keep it within one card and a few seconds: train_4k and prefill_32k
# one row (a row's float32 logits at gemma2's 256000-token vocabulary and
# 32768 positions are 33.5 GB), at 2 layers (zamba2: 6, its first
# shared-block occurrence; qwen3-moe: 1, ~2.5 B params a layer); decode_32k
# at its 128 rows and 2 layers (zamba2: 32 rows, its shared block's cache
# of 32 heads of 112 is 60 GB at 128 rows); long_500k at full depth
PLAN_LAYERS = {"zamba2-7b": 6, "qwen3-moe-235b-a22b": 1}
PLAN_ROWS = {("zamba2-7b", "decode_32k"): 32}
# the planning phase's kernel rows: row -> (kernel, the runs whose launches
# it counts: shape, archs or None for all)
PLAN_ROWS_KERNELS = {
    "flash_attention@train_4k": ("flash_attention", "train_4k", None),
    "flash_attention@prefill_32k": ("flash_attention", "prefill_32k", None),
    "flash_attention@prefill_32k/gemma2-9b": ("flash_attention",
                                              "prefill_32k", ("gemma2-9b",)),
    "flash_attention_bwd@train_4k": ("flash_attention_bwd", "train_4k",
                                     None),
    "decode_attention@decode_32k": ("decode_attention", "decode_32k", None),
    "decode_attention@long_500k/gemma2-9b": ("decode_attention", "long_500k",
                                             ("gemma2-9b",)),
    "ssd_scan@prefill_32k": ("ssd_scan", "prefill_32k", None),
    "ssd_scan_bwd@train_4k": ("ssd_scan_bwd", "train_4k", None),
}
LONG_KEYS, LONG_ROWS, RING = 32768, 256, 4096


def plan_cut(arch: str, shape: str):
    """(num_layers, rows) of a card run; None keeps the config's depth or
    the shape's batch."""
    if shape == "long_500k":
        return None, None
    rows = (1 if shape in ("train_4k", "prefill_32k")
            else PLAN_ROWS.get((arch, shape)))
    return PLAN_LAYERS.get(arch, 2), rows


def path_kernels(cfg, mode: str):
    """The kernels a step of ``mode`` on ``cfg`` must launch on the card."""
    ssm = cfg.has_ssm()
    attn = not cfg.is_attention_free() or cfg.shared_attn_every > 0
    if mode == "train":
        return ((("flash_attention", "flash_attention_bwd") if attn else ())
                + (("ssd_scan", "ssd_scan_bwd") if ssm else ()))
    if mode == "prefill":
        return (("flash_attention",) if attn else ()) + (
            ("ssd_scan",) if ssm else ())
    gqa = attn and not cfg.has_mla()
    return ((("decode_attention",) if gqa else ())
            + (("flash_attention",) if cfg.is_encoder_decoder else ())
            + (("ssd_decode_step",) if ssm else ()))


def planning_runs(torch, only=None):
    """Every pair's host plan (40 rows: 34 ok, 6 skipped with the
    reference's reason), then each of the 34 steps once on the card
    through ``launch.dryrun.run_one`` at its shape's seq_len and the cuts
    of ``plan_cut``, the launch counts set to 0 just before each and read
    just after; each step's output finite and of its shape, each kernel of
    its path launched.  ``only``: the (arch, shape) pairs to run (all
    34 by default)."""
    from repro_torch import kernels
    from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as S
    plans = [D.plan(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
    for row in plans:
        D.print_row(row)
    ok = [(r["arch"], r["shape"]) for r in plans if r["status"] == "ok"]
    skipped = [r for r in plans if r["status"] == "skipped"]
    check(len(ok) == 34 and len(skipped) == 6 and all(
        r["reason"] == "full-attention arch: long_500k requires "
                       "sub-quadratic attention" for r in skipped),
          f"plan: {len(ok)} ok, {len(skipped)} skipped")
    runs = []
    for arch, shape in ok:
        if only is not None and (arch, shape) not in only:
            continue
        layers, rows = plan_cut(arch, shape)
        release(torch)
        kernels.reset_launch_counts()
        row = D.run_one(arch, shape, num_layers=layers, rows=rows)
        counts = kernels.launch_counts()
        r = row["run"]
        cfg = S.resolved_config(get_config(arch), INPUT_SHAPES[shape])
        mode = INPUT_SHAPES[shape].mode
        want = {"train": [], "prefill": [r["rows"], r["seq_len"],
                                         cfg.vocab_size],
                "decode": [r["rows"], 1, cfg.vocab_size]}[mode]
        check(r["finite"] and r["output_shape"] == want,
              f"{arch} x {shape}: output {r['output_shape']} (want {want}),"
              f" finite {r['finite']}")
        check(r["device_ms"] is not None, f"{arch} x {shape}: the profiler "
              "saw no device time")
        missing = [k for k in path_kernels(cfg, mode) if not counts[k]]
        check(not missing, f"{arch} x {shape}: {missing} never launched")
        row["launches"] = {k: v for k, v in counts.items() if v}
        print(f"   launches {row['launches']}")
        runs.append(row)
    release(torch)
    return {"plans": plans, "runs": runs}


def long_checks(torch):
    """The kernels at the input shapes' lengths against their plain
    versions on the card (a generator of its own, seed 40), bf16 within 3e-2
    x min(1, max|want|) (outputs of many keys sit far below 1) or, for
    gradients, x max(1, max|want|), each case two launches bitwise equal:
    flash at 4096 x 4096 causal (scope-qwen3-4b's 32 heads on 8 of 128);
    flash over 32768 keys on the last 256 query rows (q_offset; the plain
    version cannot hold 32768^2 scores), and so at gemma2-9b's heads of 256
    with its window of 4096 and softcap 50; the flash backward at 4096
    through the autograd Function against autograd of the plain version;
    the dense decode over 32768 keys (full and ragged rows); gemma2-9b's
    4096-slot ring short of the window, full, just wrapped and wrapped at
    position 32767, against its plain version and the windowed history;
    the SSD scan (y within 3e-2, the f32 state within 2e-5, each element x
    max(1, |want|)) and its backward (dx, dA within 3e-2, the f32 d(dt),
    dB, dC within 1e-4, x max(1, max|want|)) at mamba2-1.3b's heads over
    4096 and 32768 tokens, against the plain version in float64.  Returns
    {row: max_abs_err} for the phase's kernel rows."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SS
    gen = torch.Generator(device="cuda").manual_seed(40)
    bf = torch.bfloat16
    errs = {}

    def rnd(*shape, dt=bf):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    def view(b, s, h, d):
        return rnd(b, s, h, d).transpose(1, 2)

    def compare(name, got, want, tol, scale="rel", row=None):
        torch.cuda.synchronize()
        w = want.float() if want.dtype != torch.float64 else want
        diff = (got.to(w.dtype) - w).abs()
        err = diff.max().item()
        top = w.abs().max().item()
        if scale == "each":
            bad = (diff / w.abs().clamp(min=1.0)).max().item()
        else:
            bad = err / {"rel": max(min(1.0, top), 1e-30),
                         "max": max(1.0, top)}[scale]
        finite = bool(torch.isfinite(got.float()).all())
        print(f"   {name}: max_abs_err {err:.3g} (tol {tol} x "
              f"{ {'rel': 'min(1, max|want|)', 'max': 'max(1, max|want|)', 'each': 'max(1, |want|) each'}[scale]}, "
              f"max|want| {top:.3g})")
        check(finite and bad <= tol, f"{name}: err {bad} > {tol} or "
              "non-finite")
        if row:
            errs[row] = max(errs.get(row, 0.0), err)

    def same(name, a, b):
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b, strict=True)),
              f"{name}: two launches differ")
        print(f"   {name}: two launches bitwise equal")

    # flash forward: 4096 x 4096 causal; the last 256 rows over 32768 keys
    cases = [("flash 4096 causal", 1, 32, 8, 4096, 4096, 128, {}, 0,
              "flash_attention@train_4k"),
             ("flash 32768 keys, last 256 rows", 1, 32, 8, LONG_ROWS,
              LONG_KEYS, 128, {}, LONG_KEYS - LONG_ROWS,
              "flash_attention@prefill_32k"),
             ("flash 32768 keys, gemma2-9b window 4096 softcap 50", 1, 16, 8,
              LONG_ROWS, LONG_KEYS, 256, dict(window=RING, softcap=50.0),
              LONG_KEYS - LONG_ROWS, "flash_attention@prefill_32k/gemma2-9b")]
    for name, b, hq, hkv, sq, sk, d, kw, off, row in cases:
        q, k, v = view(b, sq, hq, d), view(b, sk, hkv, d), view(b, sk, hkv, d)
        got = FA.flash_attention_cuda(q, k, v, q_offset=off, **kw)
        compare(name, got, FA.flash_attention_plain(q, k, v, q_offset=off,
                                                    **kw), BF16_TOL, row=row)
        same(name, (got,), (FA.flash_attention_cuda(q, k, v, q_offset=off,
                                                     **kw),))
        del q, k, v, got
        release(torch)

    # the flash backward at 4096, as a loss reaches it
    q, k, v = (view(1, 4096, h, 128).requires_grad_(True) for h in (32, 8, 8))
    dout = rnd(1, 32, 4096, 128)
    before = FA.bwd_launches
    got = torch.autograd.grad(FA.flash_attention(q, k, v), (q, k, v), dout)
    check(FA.bwd_launches == before + 1, "flash bwd 4096: no backward launch")
    want = torch.autograd.grad(FA.flash_attention_plain(q, k, v), (q, k, v),
                               dout)
    for n, g, w in zip("qkv", got, want, strict=True):
        compare(f"flash bwd 4096 causal d{n}", g, w, BF16_TOL, scale="max",
                row="flash_attention_bwd@train_4k")
    with torch.no_grad():
        out, lse = FA.flash_attention_cuda(q, k, v, return_lse=True)
        same("flash bwd 4096", FA.flash_attention_bwd_cuda(
            q, k, v, out, dout, lse), FA.flash_attention_bwd_cuda(
            q, k, v, out, dout, lse))
    del q, k, v, dout, got, want, out, lse
    release(torch)

    # the dense decode over 32768 keys: full rows and ragged ones
    qd = rnd(4, 32, 1, 128)
    kc, vc = rnd(4, 8, LONG_KEYS, 128), rnd(4, 8, LONG_KEYS, 128)
    for lens in ([LONG_KEYS] * 4, [LONG_KEYS, 30000, 4097, 17]):
        lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = DA.decode_attention_cuda(qd, kc, vc, lens)
        name = f"decode 32768 keys, lens {lens.tolist()}"
        compare(name, got, DA.decode_attention_plain(qd, kc, vc, lens),
                BF16_TOL, row="decode_attention@decode_32k")
        same(name, (got,), (DA.decode_attention_cuda(qd, kc, vc, lens),))
    del qd, kc, vc

    # gemma2-9b's ring of 4096 slots: short, full, just wrapped, far
    pos = torch.tensor([1000, RING - 1, RING, LONG_KEYS - 1],
                       dtype=torch.int32, device="cuda")
    b, hq, hkv, d, cap = pos.numel(), 16, 8, 256, 50.0
    full_k, full_v = rnd(b, hkv, LONG_KEYS, d), rnd(b, hkv, LONG_KEYS, d)
    ring_k = torch.zeros(b, hkv, RING, d, dtype=bf, device="cuda")
    ring_v = torch.zeros_like(ring_k)
    for i, p in enumerate(pos.tolist()):
        keep = torch.arange(max(0, p - RING + 1), p + 1, device="cuda")
        ring_k[i, :, keep % RING] = full_k[i, :, keep]
        ring_v[i, :, keep % RING] = full_v[i, :, keep]
    q = rnd(b, hq, 1, d)
    lens = torch.clamp(pos + 1, max=RING)
    got = DA.decode_attention_cuda(q, ring_k, ring_v, lens, softcap=cap)
    name = f"decode ring 4096 d256 softcap, pos {pos.tolist()}"
    compare(name, got, DA.decode_attention_plain(q, ring_k, ring_v, lens,
                                                 softcap=cap), BF16_TOL,
            row="decode_attention@long_500k/gemma2-9b")
    compare(f"{name} vs the windowed history", got, DA.decode_attention_plain(
        q, full_k, full_v, pos + 1, window=RING, softcap=cap), BF16_TOL)
    same(name, (got,), (DA.decode_attention_cuda(q, ring_k, ring_v, lens,
                                                 softcap=cap),))
    del full_k, full_v, ring_k, ring_v, q
    release(torch)

    # the SSD scan and its backward over 4096 and 32768 tokens, mamba2's
    # 64 heads of 64, state 128, chunk 128, x the conv output's bf16 slice
    for l in (4096, LONG_KEYS):
        x, dtv, A, B, C = ssd_inputs(torch, gen, 1, l, 64, 64, 128, 1.0, bf,
                                     conv_layout=True)
        got = SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=128)
        with torch.no_grad():
            yw, sw = ref.ssd(*(t.double() for t in (x, dtv, A, B, C)),
                             chunk=128)
        name = f"ssd {l} tokens"
        compare(f"{name} y", got[0], yw, BF16_TOL, scale="each",
                row="ssd_scan@prefill_32k")
        compare(f"{name} state", got[1], sw, F32_TOL, scale="each")
        same(name, got, SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=128))
        del yw, sw, got
        dy = rnd(1, l, 64, 64)
        leaves = [t.detach().requires_grad_(True) for t in (x, dtv, A, B, C)]
        before = SS.bwd_launches
        y, _ = SS.ssd_scan(*leaves, chunk=128)
        grads = torch.autograd.grad(y, leaves, dy)
        check(SS.bwd_launches == before + 1, f"{name}: no backward launch")
        del y
        wit = SS.ssd_scan_bwd_plain(
            *(t.double() for t in (x, dtv, A, B, C, dy)), None, chunk=128)
        for part, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), grads, wit,
                              strict=True):
            compare(f"{name} bwd {part}", g, w,
                    SPLIT_TOL if g.dtype == torch.float32 else BF16_TOL,
                    scale="max", row="ssd_scan_bwd@train_4k")
        del wit
        with torch.no_grad():
            _, _, states = SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=128,
                                            save_states=True)
            same(f"{name} bwd", SS.ssd_scan_bwd_cuda(
                x, dtv, A, B, C, dy, None, states, chunk=128),
                SS.ssd_scan_bwd_cuda(x, dtv, A, B, C, dy, None, states,
                                     chunk=128))
        del x, dtv, A, B, C, dy, leaves, grads, states
        release(torch)
    return errs


def long_timings(torch):
    """Each kernel at the input shapes' lengths (a generator of its own,
    seed 41; bf16; q, k, v the model's views), its plain version and its
    yardstick (SDPA, or ``softcap_library`` with a softcap), by device time
    in CUDA-graph replays, beside its bound: the rows of
    ``PLAN_ROWS_KERNELS``.  The 32768-key flash rows are timed on their
    last 256 query rows (the plain version cannot hold 32768^2 scores); the
    kernel and SDPA over all 32768 query rows are timed beside them."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SS
    gen = torch.Generator(device="cuda").manual_seed(41)
    bf = torch.bfloat16
    out = {}

    def view(b, s, h, d):
        return torch.randn(b, s, h, d, generator=gen, device="cuda").to(
            bf).transpose(1, 2)

    def show(row, t):
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"   {row}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f}, library {lib}, bound "
              f"{t['bound_ms']:.4f} ({t['bound_by']}); {t['shape']}")

    flash = [("flash_attention@train_4k", 32, 8, 4096, 4096, 128, {}, 0, 5),
             ("flash_attention@prefill_32k", 32, 8, LONG_ROWS, LONG_KEYS,
              128, {}, LONG_KEYS - LONG_ROWS, 5),
             ("flash_attention@prefill_32k/gemma2-9b", 16, 8, LONG_ROWS,
              LONG_KEYS, 256, dict(window=RING, softcap=50.0),
              LONG_KEYS - LONG_ROWS, 5)]
    for row, hq, hkv, sq, sk, d, kw, off, iters in flash:
        q, k, v = view(1, sq, hq, d), view(1, sk, hkv, d), view(1, sk, hkv, d)
        cap, window = kw.get("softcap", 0.0), kw.get("window", 0)
        plain = (lambda: FA.flash_attention_plain(q, k, v, q_offset=off,
                                                  **kw))
        if cap:
            library = softcap_library(torch, cap, q, k, v, window=window,
                                      q_offset=off)
            err = (library().float() - plain().float()).abs().max().item()
            print(f"   {row}: flex_attention vs plain {err:.3e}")
            check(err <= BF16_TOL, f"{row}: flex_attention differs by {err}")
            call = ("flex_attention (torch.compile), score_mod softcap * "
                    "tanh(s / softcap), causal window block mask")
        else:
            mask = None
            if off:
                mask = (torch.arange(sq, device="cuda")[:, None] + off
                        >= torch.arange(sk, device="cuda")[None])
            library = (lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=mask is None, attn_mask=mask,
                enable_gqa=True))
            call = "scaled_dot_product_attention"
        t = dict(times(torch, lambda: FA.flash_attention_cuda(
            q, k, v, q_offset=off, **kw), plain, library, iters),
            library_call=call,
            shape=f"q (1,{hq},{sq},{d}) kv (1,{hkv},{sk},{d}) bf16 causal"
                  + (f" q_offset {off}" if off else "")
                  + (f" window {window} softcap {cap:g}" if cap else ""))
        # keys a query row attends (causal from q_offset, within the
        # window), and the keys some row needs, read once
        pairs = sum(min(off + i + 1, window or off + i + 1)
                    for i in range(sq))
        needed = min(sk, off + sq) - (max(0, off - window + 1) if window
                                      else 0)
        t["bound_ms"], t["bound_by"] = bound(
            2 * (2 * q.numel() + 2 * hkv * needed * d),
            4 * d * pairs * hq, "bfloat16")
        out[row] = t
        show(row, t)
        del q, k, v
        release(torch)
    # the full 32768 x 32768 causal prefill of one row: the kernel and SDPA
    q, k, v = (view(1, LONG_KEYS, h, 128) for h in (32, 8, 8))
    full = dict(
        ms=device_ms(torch, lambda: FA.flash_attention_cuda(q, k, v), 1, 2),
        library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 1, 2))
    pairs = LONG_KEYS * (LONG_KEYS + 1) // 2
    full["bound_ms"], full["bound_by"] = bound(
        2 * (q.numel() + k.numel() + v.numel() + q.numel()),
        4 * 128 * pairs * 32, "bfloat16")
    out["flash_attention@prefill_32k"]["full_32768"] = full
    print(f"   flash 32768 x 32768 causal, 32 heads on 8 of 128: kernel "
          f"{full['ms']:.3f} ms, SDPA {full['library_ms']:.3f}, bound "
          f"{full['bound_ms']:.3f}")
    del q, k, v
    release(torch)

    # the flash backward at 4096: the kernel in graph replays, its plain
    # version's and SDPA's backward (autograd, which a graph does not
    # capture) by CUDA events around back-to-back calls of milliseconds
    # each, where the host's launches hide under the device's work.  Late
    # in this script the profiler's sums lose events here (the kernel's
    # summed to a quarter of its graph replays in three profiles running)
    row = "flash_attention_bwd@train_4k"
    q, k, v = (view(1, 4096, h, 128).requires_grad_(True)
               for h in (32, 8, 8))
    dout = torch.randn(1, 32, 4096, 128, generator=gen,
                       device="cuda").to(bf)
    with torch.no_grad():
        o, lse = FA.flash_attention_cuda(q, k, v, return_lse=True)

    def grads(y):
        return lambda: torch.autograd.grad(y, (q, k, v), dout,
                                           retain_graph=True)

    t = dict(ms=device_ms(torch, lambda: FA.flash_attention_bwd_cuda(
                 q, k, v, o, dout, lse), 20),
             plain_ms=eager_ms(torch, grads(FA.flash_attention_plain(
                 q, k, v)), 5),
             library_ms=eager_ms(torch, grads(F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, enable_gqa=True)), 20),
             library_call="backward of scaled_dot_product_attention (GQA, "
                          "causal); plain_ms and library_ms by CUDA events "
                          "around back-to-back calls",
             shape="q (1,32,4096,128) k, v (1,8,4096,128) bf16 causal, "
                   "views of (b, s, h, d); out, dO (b, hq, s, d); lse f32")
    # q, k, v, o, dO and lse read once, dq, dk, dv written once; per
    # attending (query, key) pair and q-head 6d + 4dv FLOPs
    t["bound_ms"], t["bound_by"] = bound(
        2 * (2 * q.numel() + 4 * k.numel() + 2 * o.numel())
        + 4 * lse.numel(), 4096 * 4097 // 2 * 32 * 10 * 128, "bfloat16")
    out[row] = t
    show(row, t)
    del q, k, v, dout, o, lse
    release(torch)

    # the dense decode over 32768 keys, 8 rows; gemma2-9b's ring
    for row, b, hq, hkv, S, d, cap in (
            ("decode_attention@decode_32k", 8, 32, 8, LONG_KEYS, 128, 0.0),
            ("decode_attention@long_500k/gemma2-9b", 1, 16, 8, RING, 256,
             50.0)):
        qd = torch.randn(b, hq, 1, d, generator=gen, device="cuda").to(bf)
        kc = torch.randn(b, hkv, S, d, generator=gen, device="cuda").to(bf)
        vc = torch.randn(b, hkv, S, d, generator=gen, device="cuda").to(bf)
        lens = torch.full((b,), S, dtype=torch.int32, device="cuda")
        kw = dict(softcap=cap) if cap else {}
        plain = (lambda: DA.decode_attention_plain(qd, kc, vc, lens, **kw))
        if cap:
            library = softcap_library(torch, cap, qd, kc, vc, lens)
            err = (library().float() - plain().float()).abs().max().item()
            check(err <= BF16_TOL, f"{row}: flex_attention differs by {err}")
            call = "flex_attention (torch.compile), valid-length block mask"
        else:
            library = (lambda: F.scaled_dot_product_attention(
                qd, kc, vc, enable_gqa=True))
            call = "scaled_dot_product_attention"
        t = dict(times(torch, lambda: DA.decode_attention_cuda(
            qd, kc, vc, lens, **kw), plain, library, 20),
            library_call=call,
            shape=f"q ({b},{hq},1,{d}) cache ({b},{hkv},{S},{d}) bf16 "
                  f"cache_len {S}" + (f" softcap {cap:g}" if cap else ""))
        t["bound_ms"], t["bound_by"] = bound(
            2 * (2 * qd.numel() + 2 * b * hkv * S * d) + 4 * b,
            4 * d * b * S * hq, "bfloat16")
        out[row] = t
        show(row, t)
        del qd, kc, vc
        release(torch)

    # the SSD scan over 32768 tokens and its backward over 4096, mamba2's
    for row, l in (("ssd_scan@prefill_32k", LONG_KEYS),
                   ("ssd_scan_bwd@train_4k", 4096)):
        x, dtv, A, B, C = ssd_inputs(torch, gen, 1, l, 64, 64, 128, 1.0, bf,
                                     conv_layout=True)
        shape = (f"x (1,{l},64,64) bf16 conv-output slice, dt, B, C f32, "
                 "state 128, chunk 128")
        if row.startswith("ssd_scan@"):
            t = dict(times(torch, lambda: SS.ssd_scan_cuda(
                x, dtv, A, B, C, chunk=128), lambda: ref.ssd(
                x, dtv, A, B, C, chunk=128), None, 5), shape=shape)
            work = ssd_work(1, l, 64, 64, 128, 128, 2, 2)
        else:
            dy = torch.randn(1, l, 64, 64, generator=gen,
                             device="cuda").to(bf)
            with torch.no_grad():
                _, _, states = SS.ssd_scan_cuda(x, dtv, A, B, C, chunk=128,
                                                save_states=True)
            t = dict(times(torch, lambda: SS.ssd_scan_bwd_cuda(
                x, dtv, A, B, C, dy, None, states, chunk=128),
                lambda: SS.ssd_scan_bwd_plain(x, dtv, A, B, C, dy,
                                              chunk=128), None, 5),
                shape=shape + ", dy bf16")
            work = ssd_bwd_work(1, l, 64, 64, 128, 128, 2, 2)
        t["library_call"] = "none: no single PyTorch call computes it"
        t["bound_ms"], t["bound_by"] = bound(*work, "float32")
        out[row] = t
        show(row, t)
        del x, dtv, A, B, C
        release(torch)
    return out


def plan_launches(runs):
    """Each planning row's launches: its kernel's count over the runs of
    its shape (and archs)."""
    out = {}
    for row, (kernel, shape, archs) in PLAN_ROWS_KERNELS.items():
        out[row] = sum(r["launches"].get(kernel, 0) for r in runs
                       if r["shape"] == shape
                       and (archs is None or r["arch"] in archs))
        check(out[row] > 0, f"{row}: {kernel} never launched on its path")
    return out


def clis():
    """``python -m repro_torch.launch.train`` on scope-tiny (the card by
    default), then ``python -m repro_torch.launch.serve --checkpoint`` on
    what it saved: both exit 0; the serve report is the reference's JSON."""
    import os
    ck = OUT_DIR / "cli_scope_tiny"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for name, args in (
            ("train", ["repro_torch.launch.train", "--size", "tiny",
                       "--queries", "200", "--anchors", "80", "--sft-steps",
                       "40", "--sft-examples", "1200", "--grpo-steps", "2",
                       "--out", str(ck)]),
            ("serve", ["repro_torch.launch.serve", "--checkpoint", str(ck),
                       "--queries", "8"])):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", *args], env=env,
                             capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        print("\n".join(f"   {name}| {line}" for line in
                        out.stdout.strip().splitlines()[-6:]))
        check(out.returncode == 0, f"{name} CLI exit {out.returncode}: "
              f"{out.stderr[-2000:]}")
        runs[name] = {"wall_s": wall, "stdout_tail": out.stdout[-2000:]}
    report = json.loads(out.stdout[out.stdout.index("{"):])
    check(report["cache"]["misses"] == 8 * 7
          and 0.0 <= report["accuracy"] <= 1.0,
          f"serve CLI report malformed: {report}")
    return runs


# ---------------------------------------------------------------------------
# phase 23: scope-qwen3-4b over a serve mesh (torch.distributed, NCCL)
# ---------------------------------------------------------------------------
MESH_STREAM_QUERIES = 8
MESH_KERNELS = ("topk_retrieval", "flash_attention", "decode_attention")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def decisions(report):
    return [(d.query_id, d.model, d.p_hat, d.cost_hat, d.status)
            for d in report.decisions]


def mesh_serve(torch, engine, data, qids):
    """One cold ``serve`` of ``qids``: (decisions, the pool's parsed fields
    read back from the prediction cache, launch counts, wall s, peak GiB
    allocated over the serve)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.api import FixedAlphaPolicy, RouteRequest
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rep = engine.serve(data, qids, FixedAlphaPolicy(0.7))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = kernels.launch_counts()
    pool = engine.predict(RouteRequest([data.queries[q] for q in qids]))
    fields = {f: np.asarray(getattr(pool, f)).tolist() for f in (
        "y_hat", "len_hat", "well_formed", "p_hat", "pred_overhead")}
    return decisions(rep), fields, counts, wall, peak


def mesh_phase(torch, world, data, anchors, lib, qids, smi):
    """scope-qwen3-4b at full width served through ``ReasoningEstimator.
    shard`` over a world-1 NCCL serve mesh, held bit for bit to the
    unsharded engine on the same weights and inputs: one batch's tokens and
    decision logits, the batch serve (P1 C1 C2 P2 walls), a dense and a
    paged refill stream, launch counts; ``launch.serve --mesh`` under
    ``torch.distributed.run``; the batch serve at world min(cards, 4)
    where the machine has more than one card."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.api import FixedAlphaPolicy, RouteRequest
    from repro_torch.configs.scope_estimator import CONFIG
    from repro_torch.launch.mesh import init_distributed, make_serve_mesh
    from repro_torch.serving import sampler
    from repro_torch.serving.scheduler import BucketConfig, MicrobatchScheduler

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    os.environ.update(env)
    dev = init_distributed()
    out = {"smi": smi}
    try:
        check(dev == torch.device("cuda:0") and dist.get_backend() == "nccl"
              and dist.get_world_size() == 1,
              f"process group on {dev} over {dist.get_backend()}")
        mesh = make_serve_mesh()
        out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))
        check(tuple(mesh.shape) == (1, 1), f"serve mesh {out['mesh']}")
        params, _ = full_params(torch, CONFIG, 3.9e9)

        def engine(sharded, **kw):
            gc.collect()            # the last engine's sharded weights
            eng = make_engine(CONFIG, params, anchors, lib, world, data,
                              "cuda", **kw)
            if sharded:
                eng.estimator.shard(mesh)
            return eng

        # one batch through dispatch_batch: tokens and decision logits
        probe = engine(False)
        st = probe._prepare(RouteRequest([data.queries[q] for q in qids]),
                            False)
        prompts = np.asarray(st.prompts, np.int32)
        host = {}
        for sharded in (False, True):
            est = engine(sharded).estimator
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            host[sharded] = sampler.to_host(
                *est.dispatch_batch(prompts).chunks[0]) + (
                kernels.launch_counts(),)
            del est
        (g0, d0, c0), (g1, d1, c1) = host[False], host[True]
        check(np.array_equal(g0, g1) and np.array_equal(
            d0.view(np.uint32), d1.view(np.uint32)),
            "mesh: tokens or decision logits differ from the unsharded")
        check(c0 == c1 and all(c1[k] > 0 for k in ("flash_attention",
                                                    "decode_attention")),
              f"mesh: batch launches {c1} vs {c0}")
        print(f"   {len(prompts)} rows x {g0.shape[1]} tokens and decision "
              f"logits bit for bit; launches {c1}")

        # the batch serve, alternated: P1 C1 C2 P2
        runs = [(s, mesh_serve(torch, engine(s), data, qids))
                for s in (False, True, True, False)]
        want = runs[0][1]
        for s, got in runs[1:]:
            check(got[0] == want[0], "mesh: serve decisions differ")
            check(got[1] == want[1], "mesh: parsed fields differ")
            check(got[2] == want[2], f"mesh: serve launches {got[2]} vs "
                  f"{want[2]}")
        check(all(want[2][k] > 0 for k in MESH_KERNELS),
              f"mesh: a kernel of the serve never launched: {want[2]}")
        walls = {"unsharded": [r[3] for s, r in runs if not s],
                 "sharded": [r[3] for s, r in runs if s]}
        peaks = {"unsharded": [r[4] for s, r in runs if not s],
                 "sharded": [r[4] for s, r in runs if s]}
        out["serve"] = {"walls_s": walls, "peak_gib": peaks,
                        "launches": want[2],
                        "pairs": len(want[1]["y_hat"]) * len(
                            want[1]["y_hat"][0])}
        print(f"   serve P1 C1 C2 P2: {runs[0][1][3]:.4f} "
              f"{runs[1][1][3]:.4f} {runs[2][1][3]:.4f} "
              f"{runs[3][1][3]:.4f} s, peak {runs[0][1][4]:.2f} "
              f"{runs[1][1][4]:.2f} {runs[2][1][4]:.2f} {runs[3][1][4]:.2f} "
              f"GiB; decisions, parsed fields and launches {want[2]} equal "
              f"({smi})")

        # a dense and a paged refill stream
        ticks = stream_ticks(data, MESH_STREAM_QUERIES)
        policy = FixedAlphaPolicy(0.6)
        out["streams"] = {}
        for mode, kw in (("dense", {}), ("paged", dict(
                kv_paged=True, kv_page_size=PAGE))):
            res = {}
            for sharded in (False, True):
                eng = engine(sharded, refill=True, segment_len=SEGMENT, **kw)
                sched = MicrobatchScheduler(BucketConfig(STREAM_BUCKETS))
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                with StreamProbe() as seen, ParseProbe() as parsed:
                    t0 = time.perf_counter()
                    reports = list(eng.serve_stream(
                        data, ticks, policy, scheduler=sched,
                        use_cache=False))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                res[sharded] = (reports, parsed.windows(), len(seen.segments),
                                kernels.launch_counts(), wall,
                                {f: getattr(sched.stats, f)
                                 for f in STAT_FIELDS})
                del eng
            (r0, s0, n0, c0, w0, st0), (r1, s1, n1, c1, w1, st1) = (
                res[False], res[True])
            check(n0 == n1, f"mesh {mode} stream: {n1} segments vs {n0}")
            # each request's own window: rows that retired or never filled
            # decode filler nothing reads (from the trash page, paged)
            same_segments(s0, s1, f"mesh {mode} stream")
            check([decisions(r) for r in r0] == [decisions(r) for r in r1],
                  f"mesh {mode} stream: decisions differ")
            kernel = "paged_decode_attention" if kw else "decode_attention"
            check(c0 == c1 and c1[kernel] > 0 and c1["flash_attention"] > 0,
                  f"mesh {mode} stream: launches {c1} vs {c0}")
            check(st0 == st1, f"mesh {mode} stream: stats {st1} vs {st0}")
            out["streams"][mode] = {"walls_s": {"unsharded": w0,
                                                "sharded": w1},
                                    "segments": n1, "launches": c1,
                                    "stats": st1}
            print(f"   {mode} refill stream: {n1} segments, {len(s1)} "
                  f"requests' windows of tokens and logits bit for bit, "
                  f"decisions and stats equal, "
                  f"launches {c1}; wall unsharded {w0:.3f} s, sharded "
                  f"{w1:.3f} s")
        del params, probe
        release(torch)
        out["cli"] = mesh_cli()
    finally:
        dist.destroy_process_group()
        for var in env:
            os.environ.pop(var, None)
    n = min(torch.cuda.device_count(), 4)
    if n > 1:
        out["world"] = mesh_world(n, want)
    else:
        print("   one card: the sharded serve ran at world 1 only")
    return out


def mesh_cli():
    """``python -m torch.distributed.run --nproc-per-node 1 -m
    repro_torch.launch.serve --mesh`` on a scope-tiny checkpoint written
    here: exit 0, and the report of the same serve run in this process
    without a mesh, but for the mesh line."""
    import contextlib
    import io
    from repro_torch.configs.scope_estimator import TINY
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params
    from repro_torch.training import checkpoint
    ck = OUT_DIR / "mesh_scope_tiny.npz"
    checkpoint.save(str(ck), init_params(TINY, seed=0, device="cpu"))
    args = ["--checkpoint", str(ck), "--queries", "8"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(serve.main(args) == 0, "serve without a mesh failed")
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "1", "--master-port", str(free_port()), "-m",
         "repro_torch.launch.serve", *args, "--mesh"],
        env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"serve --mesh exit {res.returncode}: "
          f"{res.stderr[-2000:]}")
    lines = res.stdout.splitlines()
    mesh_line = "# estimator sharded over {'data': 1, 'model': 1}"
    check(mesh_line in lines, f"serve --mesh printed no mesh line: "
          f"{res.stdout[-1000:]}")
    got = "\n".join(x for x in lines if x != mesh_line) + "\n"
    check(got == buf.getvalue(), "serve --mesh report differs:\n"
          f"{got}\nvs\n{buf.getvalue()}")
    print(f"   launch.serve --mesh under torch.distributed.run: the "
          f"unsharded report, {wall:.1f} s")
    ck.unlink()
    return {"wall_s": wall}


def mesh_world(n, want):
    """The batch serve at world ``n`` over NCCL, one process a card
    (``chip_smoke.py --mesh-rank``), held to world 1's decisions, parsed
    fields and launch counts."""
    path = OUT_DIR / "mesh_world.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(n), "--master-port", str(free_port()),
         str(Path(__file__).resolve()),
         "--mesh-rank", str(path)], env=env, capture_output=True, text=True,
        timeout=600)
    check(res.returncode == 0, f"world {n} serve exit {res.returncode}: "
          f"{res.stderr[-3000:]}")
    got = json.loads(path.read_text())
    check(got["decisions"] == [list(d) for d in want[0]],
          f"world {n}: decisions differ from world 1")
    check(got["fields"] == want[1], f"world {n}: parsed fields differ")
    check(got["launches"] == want[2], f"world {n}: launches "
          f"{got['launches']} vs {want[2]}")
    print(f"   world {n}: decisions, parsed fields and launches equal to "
          f"world 1, {time.perf_counter() - t0:.1f} s")
    return {"world": n, "launches": got["launches"]}


def mesh_rank(path: str) -> int:
    """One rank of ``mesh_world``: scope-qwen3-4b's seeded weights sharded
    over every rank, one cold serve; rank 0 writes what it returned."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.scope_estimator import CONFIG
    from repro_torch.launch.mesh import init_distributed, make_serve_mesh
    from repro_torch.models.model import init_params
    dev = init_distributed()
    try:
        world, data, anchors, lib = build_world()
        qids = [int(q) for q in data.test_qids[:N_QUERIES]]
        engine = make_engine(CONFIG, init_params(CONFIG, seed=0, device=dev),
                             anchors, lib, world, data, dev)
        engine.estimator.shard(make_serve_mesh())
        dec, fields, counts, *_ = mesh_serve(torch, engine, data, qids)
        if dist.get_rank() == 0:
            Path(path).write_text(json.dumps(
                {"decisions": dec, "fields": fields, "launches": counts}))
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# phase 24: training over a device mesh (FSDP on data, TP on model)
# ---------------------------------------------------------------------------
MESH_TRAIN_STEPS = 3
# the FSDP runs at world n: each config at the depth it trains at on one
# card (FAMILY_TRAIN's gemma2-9b; phase 20's zamba2-7b, 12 mamba layers),
# then at full depth (42 layers; 81 mamba layers)
FSDP_TRAIN = (("gemma2-9b", 16, 3.9e9), ("zamba2-7b", 12, 1.2e9))
# the MoE run at world n (``moe_grpo_rank``): deepseek-v2-lite-16b at its
# one-card depth (FAMILY_TRAIN's), against rank 0's card alone, then at
# full depth (27 layers, 15.5 B params), its batch split over data
MOE_FSDP = ("deepseek-v2-lite-16b", 7)
# qwen3-moe-235b-a22b over FSDP (n, 1) at more layers than one card trains
# (1 of 94): 2, at 21.44 GiB a card on four H100s
MOE_OVER_CARDS = 2
# GRPO over a mesh on world 1's rollouts, from the same fresh weights: the
# largest and the median |difference| of a generated token's log-prob
# from world 1's (nats), and of a gradient leaf over its largest |value|.
# On four H100s TP's lie within 0.063 (median 1.7e-4) and 0.021, FSDP's
# within 0 and 0.019; compared after unequal steps, they lay 18.6 (median
# 1.86) and 0.757 apart
GRPO_LP_TOL, GRPO_GRAD_TOL = (0.25, 0.05), 0.25
# scope-qwen3-4b's attention heads (q, kv)
QWEN_HEADS = (32, 8)


class HeadProbe:
    """While installed: the heads of every call the model makes through
    ``kernels.ops`` (which wraps each kernel), by kernel: (q-heads,
    kv-heads) of every flash, dense and paged decode call, the heads of
    every SSD scan (x (b, l, h, p)) and decode step (x (b, h, p))."""

    NAMES = ("flash_attention", "decode_attention", "paged_decode_attention",
             "ssd", "ssd_decode_step")
    HEADS = {"ssd": lambda a: (a[0].shape[2],),
             "ssd_decode_step": lambda a: (a[1].shape[1],)}

    def __enter__(self):
        from collections import Counter
        from repro_torch.kernels import ops
        self.heads = {n: Counter() for n in self.NAMES}
        self._saved = {n: getattr(ops, n) for n in self.NAMES}
        for n, fn in self._saved.items():
            key = self.HEADS.get(n, lambda a: (a[0].shape[1], a[1].shape[1]))

            def wrapped(*a, _fn=fn, _n=n, _key=key, **kw):
                self.heads[_n][_key(a)] += 1
                return _fn(*a, **kw)
            setattr(ops, n, wrapped)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for n, fn in self._saved.items():
            setattr(ops, n, fn)
        return False

    def seen(self):
        return {n: {"/".join(map(str, h)): c for h, c in sorted(cnt.items())}
                for n, cnt in self.heads.items() if cnt}


def sft_dataset():
    """The SFT examples of the training phases (``main``'s, from a world
    of their own)."""
    from repro_torch.core.retrieval import AnchorRetriever
    from repro_torch.training.sft import build_sft_dataset
    _, data, anchors, lib = build_world()
    return build_sft_dataset(data, lib, AnchorRetriever(anchors,
                                                        device="cpu"),
                             max_examples=320, seed=0)


def mesh_sft(torch, cfg, params, ds, batch_size: int = SFT_BATCH):
    """``MESH_TRAIN_STEPS`` SFT steps of ``params`` (plain or sharded),
    ``train_sft``'s batches and stub seeds, one ``sft_step`` at a time:
    losses, the MoE load-balance ``aux``, each step's wall, the launches,
    peak GiB, the final params and the AdamW state (each rank's
    blocks)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.data.pipeline import batches, with_stubs
    from repro_torch.distributed import collectives as coll
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.sft import sft_step

    opt_cfg = AdamWConfig(lr=1e-5, warmup_steps=2, total_steps=100)
    state = adamw_init(params)
    it = batches(ds, batch_size, seed=0,
                 device=coll.local(params["embed"]).device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, aux, walls = [], [], []
    for i in range(MESH_TRAIN_STEPS):
        batch = with_stubs(next(it), cfg, seed=i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, metrics = sft_step(params, cfg, state, batch,
                                                opt_cfg)
        losses.append(float(loss))
        aux.append(float(metrics["aux"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(all(np.isfinite(losses)), f"{cfg.name}: non-finite loss {losses}")
    return dict(losses=losses, aux=aux, walls_s=walls,
                launches=kernels.launch_counts(),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                params=params, state=state)


class StandInParse:
    """While installed: ``tokenizer.parse_prediction`` reads every rollout
    as well formed, its first token's parity the verdict and its second
    token's the length bucket.  Random weights emit no parsable rollout, so
    every reward and advantage would be 0 and a GRPO step's gradient
    nothing but the KL term's; with this stand-in the sampled rollouts of a
    group score differently and the step's policy gradient is not 0."""

    def __enter__(self):
        from repro_torch.data import tokenizer as tok
        self._saved = tok.parse_prediction

        def parse(tokens):
            t = [int(x) for x in tokens]
            return {"y_hat": t[0] % 2,
                    "len_hat": tok.len_from_bucket(t[1] % tok.NUM_LEN_BUCKETS),
                    "well_formed": True}

        tok.parse_prediction = parse
        return self

    def __exit__(self, *exc):
        from repro_torch.data import tokenizer as tok
        tok.parse_prediction = self._saved
        return False


def mesh_grpo(torch, cfg, params, device="cuda", after=None,
              temperatures=(0.0, 1.0)):
    """GRPO rollout steps of ``params`` (plain or sharded) on one trainer,
    ``full_train``'s 16 tasks x 4 rollouts of ``NEW_TOKENS`` scored under
    ``StandInParse``: a greedy step and then a sampled one
    (``temperatures``).  Each step's batch (on the host), loss, pg, kl,
    reward, wall, launches and peak GiB, and ``after(i, params, step)`` of
    the params after step i (every rank of a mesh calls it)."""
    import dataclasses
    from repro_torch import kernels
    trainer = grpo_trainer(torch, cfg, params, device, tasks=16, group=4,
                           temperature=0.0)
    steps = []
    for i, temperature in enumerate(temperatures):
        trainer.gcfg = dataclasses.replace(trainer.gcfg,
                                           temperature=temperature)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with StepProbe() as probe, StandInParse():
            info = trainer.rollout_step()
        torch.cuda.synchronize()
        step, = probe.steps
        rec = {"temperature": temperature,
               "wall_s": time.perf_counter() - t0,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": kernels.launch_counts(),
               "batch": step["batch"], "loss": step["loss"],
               **step["metrics"], "reward": info["reward"],
               "format_rate": info["format_rate"]}
        check(all(map(math.isfinite, (rec["loss"], rec["pg"], rec["kl"]))),
              f"{cfg.name} grpo: non-finite {rec}")
        if after is not None:
            rec["after"] = after(i, trainer.params, rec)
        steps.append(rec)
    del trainer
    return steps


def same_bits(torch, a, b) -> bool:
    from repro_torch.distributed import collectives as coll
    return all(torch.equal(coll.local(x).cpu(), coll.local(y).cpu())
               for x, y in zip(_leaves(a), _leaves(b), strict=True))


def rank_bytes(tree) -> int:
    """The bytes of this rank's blocks of ``tree``."""
    from repro_torch.distributed import collectives as coll
    return sum(coll.local(t).numel() * t.element_size()
               for t in _leaves(tree))


def spec_bytes(mesh, cfg, dtype=None) -> int:
    """``sharding.local_bytes`` of ``cfg``'s params (in ``dtype`` when
    given: the AdamW moments' float32) under ``param_specs``."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.io import tree_map
    from repro_torch.launch.specs import abstract_params
    meta = abstract_params(cfg)
    if dtype is not None:
        meta = tree_map(lambda t: torch.empty(t.shape, dtype=dtype,
                                              device="meta"), meta)
    return shd.local_bytes(mesh, meta, shd.param_specs(mesh, meta))


def stream_decisions(torch, engine, data, ticks):
    """The decisions of a refill stream over ``ticks`` and its launches."""
    from repro_torch import kernels
    from repro_torch.api import FixedAlphaPolicy
    from repro_torch.serving.scheduler import BucketConfig, MicrobatchScheduler
    sched = MicrobatchScheduler(BucketConfig(STREAM_BUCKETS))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    reports = list(engine.serve_stream(data, ticks, FixedAlphaPolicy(0.6),
                                       scheduler=sched, use_cache=False))
    torch.cuda.synchronize()
    return [decisions(r) for r in reports], kernels.launch_counts()


def close_decisions(got, want, tol: float) -> bool:
    """Equal but for p_hat, which agrees within ``tol``."""
    got, want = [list(d) for d in got], [list(d) for d in want]
    return len(got) == len(want) and all(
        g[:2] == w[:2] and g[3:] == w[3:] and abs(g[2] - w[2]) <= tol
        for g, w in zip(got, want, strict=True))


def close_fields(got, want, tol: float) -> bool:
    import numpy as np
    return got.keys() == want.keys() and all(
        (np.abs(np.asarray(got[k]) - np.asarray(want[k])).max() <= tol)
        if k == "p_hat" else got[k] == want[k] for k in want)


def mesh_train_phase(torch, world, data, anchors, lib, qids, L: int, ds,
                     smi):
    """Training over a world-1 NCCL mesh: scope-qwen3-4b at full width
    sharded by ``ReasoningEstimator.shard(make_host_mesh())``, three SFT
    steps, a greedy and a sampled GRPO step (``mesh_grpo_world1``) and a
    batch serve, then mamba2-1.3b and zamba2-7b served and trained
    (``mesh_ssm_world1``), held bit for bit to the unsharded runs on the
    same weights and batches (losses, every param leaf, launches, rollouts,
    decisions and parsed fields); walls and peaks beside the unsharded.
    On a machine with more cards, world min(cards, 4) after it
    (``mesh_train_world``), against the world-1 runs made here."""
    from repro_torch.configs import get_config
    from repro_torch.configs.scope_estimator import CONFIG
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.launch.mesh import make_host_mesh

    n = min(torch.cuda.device_count(), 4)
    out, refs = {"smi": smi}, {}
    with world1_group():
        mesh = make_host_mesh()
        check(tuple(mesh.shape) == (1, 1), f"host mesh {tuple(mesh.shape)}")
        runs = {}
        for sharded in (False, True):
            params, _ = full_params(torch, CONFIG, 3.9e9)
            if sharded:
                params = ReasoningEstimator(CONFIG, params).shard(mesh).params
            res = mesh_sft(torch, CONFIG, params, ds)
            del params
            res["params"] = _to(res["params"], "cpu") if not sharded \
                else res["params"]
            res.pop("state")
            runs[sharded] = res
            release(torch)
        one, sh = runs[False], runs[True]
        check(sh["losses"] == one["losses"],
              f"mesh train: losses {sh['losses']} vs {one['losses']}")
        check(same_bits(torch, sh["params"], one["params"]),
              "mesh train: a param leaf differs from the unsharded run")
        check(sh["launches"] == one["launches"]
              and sh["launches"]["flash_attention_bwd"] > 0,
              f"mesh train: launches {sh['launches']} vs {one['launches']}")
        for r in runs.values():
            r.pop("params")
        release(torch)
        out["sft"] = runs = {"unsharded": one, "sharded": sh}
        print(f"   {MESH_TRAIN_STEPS} SFT steps of {SFT_BATCH} sequences: "
              f"losses {sh['losses']} and every param leaf bit for bit; "
              f"launches {sh['launches']}; step walls unsharded "
              f"{[round(w, 4) for w in one['walls_s']]} s, sharded "
              f"{[round(w, 4) for w in sh['walls_s']]} s; peak "
              f"{one['peak_gib']:.2f} / {sh['peak_gib']:.2f} GiB ({smi})")

        out["grpo"] = mesh_grpo_world1(torch, mesh)

        served = {}
        for sharded in (False, True):
            params, _ = full_params(torch, CONFIG, 3.9e9)
            engine = make_engine(CONFIG, params, anchors, lib, world, data,
                                 "cuda")
            if sharded:
                engine.estimator.shard(mesh)
            del params
            served[sharded] = mesh_serve(torch, engine, data, qids)
            if n > 1 and not sharded:
                ticks = stream_ticks(data, MESH_STREAM_QUERIES)
                refs["streams"] = {}
                for mode, kw in (("dense", {}), ("paged", dict(
                        kv_paged=True, kv_page_size=PAGE))):
                    eng = make_engine(CONFIG, engine.estimator.params,
                                      anchors, lib, world, data, "cuda",
                                      refill=True, segment_len=SEGMENT, **kw)
                    refs["streams"][mode] = stream_decisions(
                        torch, eng, data, ticks)[0]
                    del eng
            del engine
            release(torch)
        (d0, f0, c0, w0, p0), (d1, f1, c1, w1, p1) = served[False], \
            served[True]
        check(d1 == d0 and f1 == f0 and c1 == c0,
              "mesh train: the sharded batch serve differs from the "
              "unsharded")
        out["serve"] = {"walls_s": {"unsharded": w0, "sharded": w1},
                        "peak_gib": {"unsharded": p0, "sharded": p1},
                        "launches": c1}
        print(f"   batch serve: decisions, parsed fields and launches {c1} "
              f"bit for bit; wall {w0:.4f} / {w1:.4f} s, peak {p0:.2f} / "
              f"{p1:.2f} GiB")
        out["ssm"] = mesh_ssm_world1(
            torch, mesh, world, data, anchors, lib, qids, L, ds,
            OUT_DIR / SSM_REFS if n > 1 else None)
        if n > 1:
            refs["prompt_len"] = L
            refs["serve"] = {"decisions": d0, "fields": f0}
            refs["sft"] = one["losses"]
            refs["fsdp"] = {}
            for name, layers, least in FSDP_TRAIN:
                import dataclasses
                cfg = dataclasses.replace(get_config(name),
                                          num_layers=layers)
                params, _ = full_params(torch, cfg, least)
                res = mesh_sft(torch, cfg, params, ds)
                refs["fsdp"][name] = {k: res[k] for k in ("losses", "aux")}
                del params, res
                release(torch)
    if n > 1:
        out["world"] = mesh_train_world(n, refs)
    else:
        print("   one card: the sharded training ran at world 1 only")
    return out


@contextlib.contextmanager
def world1_group():
    """This process as a world-1 NCCL group, torn down after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    os.environ.update(env)
    init_distributed()
    try:
        yield
    finally:
        dist.destroy_process_group()
        for var in env:
            os.environ.pop(var, None)


def mesh_ssm_phase(torch, world, data, anchors, lib, qids, L: int, ds, smi):
    """Phase 24 alone (``--mesh-phase ssm``): the SSM backbones over a
    world-1 NCCL mesh (``mesh_ssm_world1``), then on a machine with more
    cards ``mesh_train_world``'s SSM job over min(cards, 4) of them."""
    from repro_torch.launch.mesh import make_host_mesh
    n = min(torch.cuda.device_count(), 4)
    with world1_group():
        out = {"smi": smi, "ssm": mesh_ssm_world1(
            torch, make_host_mesh(), world, data, anchors, lib, qids, L, ds,
            OUT_DIR / SSM_REFS if n > 1 else None)}
    if n > 1:
        out["world"] = {"ssm": world_job(n, "ssm", [
            "--mesh-ssm-rank", str(OUT_DIR / SSM_REFS)])}
    return out


def mesh_mla_phase(smi):
    """Phase 24's MLA job alone (``--mesh-phase mla``): on a machine with
    more cards ``mesh_train_world``'s ``--mesh-mla-rank`` over min(cards,
    4) of them, which computes its own world 1 on rank 0's card."""
    import torch
    n = min(torch.cuda.device_count(), 4)
    out = {"smi": smi}
    if n > 1:
        out["world"] = {"mla": world_job(n, "mla", ["--mesh-mla-rank"])}
    else:
        print("   one card: MLA over TP needs more cards")
    return out


def mesh_cross_phase(smi):
    """Phase 24's whisper job alone (``--mesh-phase cross``): on a machine
    with more cards ``mesh_train_world``'s ``--mesh-cross-rank`` over
    min(cards, 4) of them, which computes its own world 1 on rank 0's
    card."""
    import torch
    n = min(torch.cuda.device_count(), 4)
    out = {"smi": smi}
    if n > 1:
        out["world"] = {"cross": world_job(n, "cross",
                                           ["--mesh-cross-rank"])}
    else:
        print("   one card: whisper over TP needs more cards")
    return out


def mesh_grpo_world1(torch, mesh):
    """scope-qwen3-4b's greedy and sampled GRPO steps (``mesh_grpo``)
    unsharded and sharded on the world-1 ``mesh``, each from fresh seeded
    weights: the sharded run's rollout tokens, loss, pg, kl, reward,
    launches and every param leaf after each step bit for bit the
    unsharded's.  Returns both runs' figures."""
    from repro_torch.configs.scope_estimator import CONFIG
    from repro_torch.core.estimator import ReasoningEstimator
    runs = {}
    for sharded in (False, True):
        params, _ = full_params(torch, CONFIG, 3.9e9)
        if sharded:
            params = ReasoningEstimator(CONFIG, params).shard(mesh).params
            want = runs[False]

            def after(i, p, step):
                return same_bits(torch, p, want[i]["after"])
        else:
            def after(i, p, step):
                return _to(p, "cpu")
        runs[sharded] = mesh_grpo(torch, CONFIG, params, after=after)
        del params
        release(torch)
    one, sh = runs[False], runs[True]
    for a, b in zip(one, sh, strict=True):
        what = "greedy" if a["temperature"] == 0 else "sampled"
        check(all(torch.equal(a["batch"][k], b["batch"][k])
                  for k in a["batch"]),
              f"mesh grpo {what}: the sharded rollouts, advantages or "
              "log-probs differ")
        check(all(a[k] == b[k] for k in ("loss", "pg", "kl", "reward",
                                         "launches")),
              f"mesh grpo {what}: {b} vs {a}")
        check(b["after"] is True,
              f"mesh grpo {what}: a param leaf differs from the unsharded")
        # full_train's count: the rollouts' prefill and decode steps, the
        # old and reference log-probs, the loss and its recompute
        L = CONFIG.num_layers
        got = b["launches"]
        check(got["flash_attention"] == 5 * L
              and got["flash_attention_bwd"] == L
              and got["decode_attention"] == L * NEW_TOKENS
              and got["topk_retrieval"] >= 1,
              f"mesh grpo {what}: launches {got}")
        print(f"   GRPO {what} step, {tuple(a['batch']['tokens'].shape)} "
              f"rollouts: tokens, advantages (|adv| max "
              f"{float(a['batch']['adv'].abs().max()):.3g}), log-probs, "
              f"loss {a['loss']:.6g}, pg {a['pg']:.6g}, kl "
              f"{a['kl']:.3g}, reward {a['reward']:.4f}, launches "
              f"{a['launches']} and every param leaf bit for bit; wall "
              f"unsharded {a['wall_s']:.3f} s, sharded {b['wall_s']:.3f} s; "
              f"peak {a['peak_gib']:.2f} / {b['peak_gib']:.2f} GiB")

    def figures(steps):
        return [{k: v for k, v in st.items() if k not in ("batch", "after")}
                for st in steps]
    return {"unsharded": figures(one), "sharded": figures(sh)}


# ---------------------------------------------------------------------------
# phase 24, the SSM backbones: Mamba's SSD heads split over ``model``
# ---------------------------------------------------------------------------
# (config, the depth its SFT steps run at (None: full depth), the fewest
# params of its full-depth and of its SFT weights, a shallow depth):
# mamba2-1.3b trains at full depth on one card, zamba2-7b at phase 20's 12
# mamba layers; both serve at full depth.  The shallow cut (2 layers;
# zamba2's first unit: 6 mamba layers and the tied block) is where TP's
# gradients can be held tightly: with random weights each layer amplifies a
# difference, and at full depth world 1's own bf16 logits and gradients lie
# 0.3-0.8 of their largest from the same weights' float32 run
SSM_MESH = (("mamba2-1.3b", None, 1.3e9, 1.3e9, 2),
            ("zamba2-7b", 12, 6.5e9, 1.2e9, 6))
# TP (1, n) against world 1 from the same seeded weights, at both depths,
# each measured against world 1's own distance from the same weights'
# float32 run (the bf16 model's distance from exact arithmetic):
#  * one batch's prefill logits: their root mean square |difference| from
#    float32's, over float32's root mean square, at most SSM_F32_RATIO
#    times world 1's;
#  * each leaf of the first SFT step's gradient: its largest |difference|
#    from world 1's over world 1's largest |value|, at most
#    (1 + SSM_F32_RATIO) times world 1's distance from float32 for that
#    leaf, plus SSM_GRAD_FLOOR (by the triangle inequality, what is left if
#    TP lies no further than SSM_F32_RATIO times world 1's from float32).
# A leaf whose limit is SSM_BLIND or more could hold a quarter of its sum
# or none (a reduce-scatter missing on four cards) and pass: at the shallow
# cut no leaf may be so, at full depth such leaves are listed as blind.
# Readings on four H100s (deterministic, equal in two runs) of TP's and
# world 1's logits from float32 (root mean square): mamba2-1.3b 0.2744 /
# 0.2644, at its shallow cut 0.01321 / 0.01319; zamba2-7b 0.3819 / 0.3488,
# 0.04093 / 0.03716.  Gradient leaves' largest distance from world 1's,
# beside world 1's own from float32 for that leaf: mamba2-1.3b 0.758 /
# 0.764, shallow 0.0118 (world 1's largest 0.064); zamba2-7b 0.387 / 0.191,
# shallow 0.269 / 0.229
SSM_F32_RATIO = 1.5
SSM_GRAD_FLOOR = 0.05
SSM_BLIND = 0.75
SSM_REFS = "mesh_ssm_refs.pt"


def ssm_cfg(name, layers=None):
    """``name``'s config, cut to ``layers`` layers where given (an
    encoder-decoder's encoder to as many)."""
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(name)
    if layers is None:
        return full
    enc = {"num_encoder_layers": layers} if full.is_encoder_decoder else {}
    return dataclasses.replace(full, num_layers=layers, **enc)


def logit_batch(torch, cfg, L: int, dev):
    """The batch whose prefill logits TP is held to: 8 rows of L tokens of
    ``default_rng(33)``, with the stubs ``cfg`` reads (``with_stubs``,
    seed 33: an encoder-decoder's frames)."""
    import numpy as np
    from repro_torch.data.pipeline import with_stubs
    toks = np.random.default_rng(33).integers(3, cfg.vocab_size, (8, L))
    return with_stubs({"tokens": torch.as_tensor(toks, dtype=torch.int64,
                                                 device=dev)}, cfg, seed=33)


def as_float32(batch):
    """``batch`` with its floating columns (the stubs) in float32."""
    return {k: v.float() if v.is_floating_point() else v
            for k, v in batch.items()}


def ssm_logits(torch, cfg, params, L: int):
    """(the prefill logits of ``logit_batch`` under ``params``, and
    under the same weights in float32 computing in float32: the bf16
    model's own distance from exact arithmetic, the yardstick of TP's),
    on the host."""
    import dataclasses
    from repro_torch.io import tree_map
    from repro_torch.models import model as M
    batch = logit_batch(torch, cfg, L, "cuda")
    with torch.no_grad():
        logits = M.prefill(params, cfg, batch)[0].cpu()
        p32 = tree_map(lambda t: t.float(), params)
        logits32 = M.prefill(p32, dataclasses.replace(cfg, dtype="float32"),
                             as_float32(batch))[0].cpu()
    del p32
    release(torch)
    return logits, logits32


def logit_dist(a, b) -> dict:
    """How far logits ``a`` lie from ``b``: the largest and the root mean
    square |difference| over ``b``'s largest |value| and its root mean
    square, and the share of positions whose argmax agrees."""
    a, b = a.float(), b.float()
    d = a - b
    return {"max_rel": (d.abs().max() / b.abs().max()).item(),
            "rms_rel": (d.square().mean().sqrt()
                        / b.square().mean().sqrt()).item(),
            "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean()
            .item()}


def ssm_grads(torch, cfg, params, ds):
    """(``first_grads``' gradient tree at ``params`` on the host, and each
    leaf's largest |difference| from the gradient under the same weights
    in float32 computing in float32, over that leaf's largest |value|: the
    bf16 model's own distance from exact arithmetic, the yardstick of
    TP's)."""
    import dataclasses
    from repro_torch.io import flatten, tree_map
    _, grads = first_grads(torch, cfg, params, ds)
    host = _to(grads, "cpu")
    p32 = tree_map(lambda t: t.float(), params)
    _, g32 = first_grads(torch, dataclasses.replace(cfg, dtype="float32"),
                         p32, ds)
    del p32
    errs = {}
    for (key, g), w in zip(flatten(grads).items(), flatten(g32).values(),
                           strict=True):
        errs[key] = ((g.float() - w).abs().max()
                     / w.abs().max().clamp(min=1e-30)).item()
    del grads, g32
    release(torch)
    return host, errs


def first_grads(torch, cfg, params, ds):
    """The gradient of the loss on ``mesh_sft``'s first batch (its stubs
    too) at ``params``, plain or sharded: (loss, the gradient tree)."""
    from repro_torch.data.pipeline import batches, with_stubs
    from repro_torch.distributed import collectives as coll
    from repro_torch.models.model import loss_fn
    from repro_torch.training.optimizer import value_and_grad
    batch = with_stubs(next(batches(
        ds, SFT_BATCH, seed=0, device=coll.local(params["embed"]).device)),
        cfg, seed=0)
    loss, _, grads = value_and_grad(lambda p: loss_fn(p, cfg, batch), params)
    return float(loss), grads


def mesh_ssm_world1(torch, mesh, world, data, anchors, lib, qids, L, ds,
                    refs_path=None):
    """mamba2-1.3b and zamba2-7b over the world-1 ``mesh``: a batch serve at
    full depth and ``MESH_TRAIN_STEPS`` SFT steps (``SSM_MESH``'s depths),
    each sharded and unsharded from the same seeded weights, bit for bit
    (decisions, parsed fields and launches; losses, every param leaf and
    launches).  With ``refs_path`` (more cards run after) world 1's figures
    that the TP job holds its own to are saved there (``torch.save``): the
    serve's decisions, fields and launches, one batch's prefill logits
    (``logit_batch``), the SFT losses and the first step's gradient
    leaves."""
    from repro_torch.core.estimator import ReasoningEstimator
    out, refs = {}, {}
    for name, layers, least, cut_least, shallow in SSM_MESH:
        full = ssm_cfg(name)
        ref = refs[name] = {}
        if refs_path is not None:
            cut = ssm_cfg(name, shallow)
            params, _ = full_params(torch, cut, 0.0)
            logits, logits32 = ssm_logits(torch, cut, params, L)
            grads, grads_vs_f32 = ssm_grads(torch, cut, params, ds)
            ref["shallow"] = {"logits": logits, "logits_f32": logits32,
                              "grads": grads, "grads_vs_f32": grads_vs_f32}
            del params
            release(torch)
        served = {}
        for sharded in (False, True):
            params, _ = full_params(torch, full, least)
            if refs_path is not None and not sharded:
                ref["logits"], ref["logits_f32"] = ssm_logits(
                    torch, full, params, L)
            engine = make_engine(full, params, anchors, lib, world, data,
                                 "cuda")
            if sharded:
                engine.estimator.shard(mesh)
            del params
            served[sharded] = mesh_serve(torch, engine, data, qids)
            del engine
            release(torch)
        (d0, f0, c0, w0, p0), (d1, f1, c1, w1, p1) = served[False], \
            served[True]
        check(d1 == d0 and f1 == f0 and c1 == c0,
              f"{name} world 1: the sharded batch serve differs")
        ref["serve"] = {"decisions": d0, "fields": f0, "launches": c0}
        print(f"   {name} batch serve at world 1: decisions, parsed fields "
              f"and launches {c1} bit for bit; wall {w0:.4f} / {w1:.4f} s, "
              f"peak {p0:.2f} / {p1:.2f} GiB")
        cfg = ssm_cfg(name, layers)
        runs = {}
        for sharded in (False, True):
            params, _ = full_params(torch, cfg, cut_least)
            if sharded:
                params = ReasoningEstimator(cfg, params).shard(mesh).params
            elif refs_path is not None:
                ref["grads"], ref["grads_vs_f32"] = ssm_grads(torch, cfg,
                                                              params, ds)
            res = mesh_sft(torch, cfg, params, ds)
            del params
            res["params"] = (res["params"] if sharded
                             else _to(res["params"], "cpu"))
            res.pop("state")
            runs[sharded] = res
            release(torch)
        one, sh = runs[False], runs[True]
        check(sh["losses"] == one["losses"]
              and same_bits(torch, sh["params"], one["params"])
              and sh["launches"] == one["launches"]
              and sh["launches"]["ssd_scan_bwd"] > 0,
              f"{name} world 1: the sharded SFT steps differ: losses "
              f"{sh['losses']} vs {one['losses']}, launches "
              f"{sh['launches']} vs {one['launches']}")
        for r in runs.values():
            r.pop("params")
        release(torch)
        ref["sft"] = one["losses"]
        print(f"   {name}@{cfg.num_layers} {MESH_TRAIN_STEPS} SFT steps at "
              f"world 1: losses {sh['losses']} and every param leaf bit for "
              f"bit; launches {sh['launches']}; step walls unsharded "
              f"{[round(w, 4) for w in one['walls_s']]} s, sharded "
              f"{[round(w, 4) for w in sh['walls_s']]} s; peak "
              f"{one['peak_gib']:.2f} / {sh['peak_gib']:.2f} GiB")
        out[name] = {"serve": {"walls_s": [w0, w1], "peak_gib": [p0, p1],
                               "launches": c1},
                     "sft": {"unsharded": one, "sharded": sh}}
    if refs_path is not None:
        refs["prompt_len"] = L
        torch.save(refs, refs_path)
    return out


def ssm_tp_kernel_rows(torch, n: int, L: int, s_train: int):
    """The SSD kernels at the heads a rank of a (1, n) mesh computes
    (``ssd_rows``, each held to its plain version in float64):
    mamba2-1.3b's 64 / n heads of 64 at state 128 and zamba2-7b's 112 / n
    at state 64."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    rows = {}
    for config, heads, state in (("mamba2-1.3b", 64, 128),
                                 ("zamba2-7b", 112, 64)):
        rows.update(ssd_rows(torch, gen, 56, heads // n, state, L, s_train,
                             f"@tp{n}/{config}", check64=True))
    return rows


def grad_dist(errs, f32) -> dict:
    """The largest and the median of per-leaf gradient errors ``errs``
    (rank 0's ``leaf_errs``), the leaf of the largest, and world 1's own
    per-leaf distances from float32 ``f32`` (``ssm_grads``) beside."""
    import numpy as np
    worst = max(errs, key=errs.get)
    return {"max": errs[worst], "leaf": worst,
            "median": float(np.median(list(errs.values()))),
            "world1_vs_float32": {
                "max": max(f32.values()), "leaf": max(f32, key=f32.get),
                "median": float(np.median(list(f32.values()))),
                "at_worst": f32[worst]}}


def logit_gate(logits, ref, what: str) -> dict:
    """TP's prefill ``logits`` beside world 1's ``ref`` (``ssm_logits``):
    each from the other and from float32's; TP's root mean square distance
    from float32's checked against ``SSM_F32_RATIO`` times world 1's."""
    out = {"tp_vs_world1": logit_dist(logits, ref["logits"]),
           "tp_vs_float32": logit_dist(logits, ref["logits_f32"]),
           "world1_vs_float32": logit_dist(ref["logits"], ref["logits_f32"])}
    out["limit"] = SSM_F32_RATIO * out["world1_vs_float32"]["rms_rel"]
    check(out["tp_vs_float32"]["rms_rel"] <= out["limit"],
          f"{what}: TP prefill logits {out}")
    return out


def grad_gate(errs, f32, what: str, shallow: bool) -> dict:
    """Rank 0's per-leaf gradient distances from world 1 ``errs``
    (``leaf_errs``), each checked against (1 + ``SSM_F32_RATIO``) times
    world 1's own distance from float32 for the leaf ``f32``
    (``ssm_grads``) plus ``SSM_GRAD_FLOOR``; ``grad_dist``'s summary, the
    largest share of its limit a leaf takes, and the leaves whose limit is
    ``SSM_BLIND`` or more (none allowed where ``shallow``)."""
    limit = {k: (1 + SSM_F32_RATIO) * f32[k] + SSM_GRAD_FLOOR for k in errs}
    out = dict(grad_dist(errs, f32), leaves=len(errs),
               share=max(errs[k] / limit[k] for k in errs),
               blind=sorted(k for k in errs if limit[k] >= SSM_BLIND))
    over = {k: (errs[k], limit[k]) for k in errs if errs[k] > limit[k]}
    check(not over, f"{what}: gradient leaves beyond their limits "
          f"(distance, limit) {over}")
    check(not (shallow and out["blind"]), f"{what}: the gate cannot see "
          f"leaves {out['blind']}")
    return out


def shallow_tp(torch, name, depth, mesh, ref, L, ds, dev, rank):
    """``name`` at the shallow ``depth`` from seeded weights over TP
    ``mesh``: one batch's prefill logits and the first SFT step's gradient
    leaves against world 1's ``ref`` (``mesh_ssm_world1``, ``mla_world1``),
    gated by ``logit_gate`` and ``grad_gate``.  The gradient is checked on
    rank 0, the logits on every rank that holds ``ref`` (None elsewhere)."""
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.models import model as M
    from repro_torch.models.model import init_params
    cfg = ssm_cfg(name, depth)
    params = ReasoningEstimator(cfg, init_params(cfg, seed=0, device=dev)) \
        .shard(mesh).params
    with torch.no_grad():
        logits = M.prefill(params, cfg, logit_batch(
            torch, cfg, L, dev))[0].cpu()
    out = {} if ref is None else {
        "logits": logit_gate(logits, ref, f"{name}@{depth}")}
    del logits
    _, grads = first_grads(torch, cfg, params, ds)
    errs = leaf_errs(torch, grads, ref["grads"] if rank == 0 else None, dev,
                     rank, scaled=True)
    del grads, params
    release(torch)
    if rank == 0:
        out["grads"] = grad_gate(errs, ref["grads_vs_f32"], f"{name}@{depth}",
                                 shallow=True)
    return out


def mesh_ssm_rank(refs_path: str, path: str) -> int:
    """One rank of ``mesh_train_world``'s third job: mamba2-1.3b and
    zamba2-7b over TP (1, n), each Mamba layer on h / n SSD heads, held to
    world 1's figures ``refs_path`` (``mesh_ssm_world1``) from the same
    seeded weights: the batch serve at full depth (decisions and parsed
    fields within 3e-2, launches equal), one batch's prefill logits, the
    heads of every SSD scan, decode step and attention call, the decode
    caches' local shapes, the rank's param bytes against ``local_bytes``;
    the logits and first-step gradient leaves at the shallow cut
    (``shallow_tp``); then at ``SSM_MESH``'s SFT depth the first
    step's gradient leaves and ``MESH_TRAIN_STEPS`` SFT steps (losses
    within 3e-2 relative), with every card's peak.  Logits and gradients
    are gated by ``logit_gate`` and ``grad_gate``.  Rank 0 adds the SSD kernels' rows at a
    rank's heads (``ssm_tp_kernel_rows``) and writes what it found."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import init_distributed, make_serve_mesh
    from repro_torch.models import model as M
    from repro_torch.models.model import init_params
    dev = init_distributed()
    n, rank = dist.get_world_size(), dist.get_rank()
    refs = torch.load(refs_path, map_location="cpu", mmap=True,
                      weights_only=False)
    out = {"world": n, "smi": nvidia_smi(), "mesh": [1, n]}
    t0 = time.perf_counter()

    def say(msg):
        if rank == 0:
            print(f"   [world {n} ssm, {time.perf_counter() - t0:.0f} s] "
                  f"{msg}", flush=True)

    def by_rank(x: float):
        got = [torch.zeros((), device=dev) for _ in range(n)]
        dist.all_gather(got, torch.zeros((), device=dev) + x)
        return [float(v) for v in got]

    try:
        world, data, anchors, lib = build_world()
        qids = [int(q) for q in data.test_qids[:N_QUERIES]]
        ds = sft_dataset()
        L = int(refs["prompt_len"])
        mesh = make_serve_mesh(n_data=1, n_model=n)
        for name, layers, _, _, shallow in SSM_MESH:
            full = ssm_cfg(name)
            ref = refs[name]
            res = out[name] = {}
            split = coll.model_split(full, mesh)
            check(split.ssm, f"{name}: Mamba computes whole on (1, {n}): "
                  f"{split}")
            h, din, state = (full.resolved_ssm_heads, full.d_inner,
                             full.ssm_state)
            plain = init_params(full, seed=0, device=dev)
            with HeadProbe() as probe:
                eng = make_engine(full, plain, anchors, lib, world, data, dev)
                eng.estimator.shard(mesh)
                del plain
                pbytes = rank_bytes(eng.estimator.params)
                want_bytes = spec_bytes(mesh, full)
                check(pbytes == want_bytes, f"{name} TP param bytes "
                      f"{pbytes} vs local_bytes {want_bytes}")
                dec, fields, counts, wall, peak = mesh_serve(torch, eng,
                                                             data, qids)
                with torch.no_grad():
                    logits = M.prefill(eng.estimator.params, full,
                                       logit_batch(torch, full, L,
                                                   dev))[0]
                run = eng.estimator.open_slots(np.full((4, L), 5, np.int32))
                caches = {f"{j}/{k}": list(t.shape) for seg in
                          run.state.caches for j, unit in seg.items()
                          for k, t in unit.items()}
                del run, eng
            check(close_decisions(dec, ref["serve"]["decisions"], BF16_TOL)
                  and close_fields(fields, ref["serve"]["fields"], BF16_TOL),
                  f"{name} TP world {n}: the batch serve differs from world "
                  "1")
            check(counts == ref["serve"]["launches"],
                  f"{name} TP launches {counts} vs world 1 "
                  f"{ref['serve']['launches']}")
            gate = logit_gate(logits.cpu(), ref, name)
            del logits
            seen = probe.seen()
            check(list(seen["ssd"]) == [str(h // n)]
                  and list(seen["ssd_decode_step"]) == [str(h // n)],
                  f"{name} TP SSD heads {seen}, want {h // n}")
            if full.shared_attn_every:      # zamba2's tied block
                attn = f"{full.num_heads // n}/{full.num_kv_heads // n}"
                check(all(list(seen.get(k, {})) == [attn] for k in
                          ("flash_attention", "decode_attention")),
                      f"{name} TP attention heads {seen}, want {attn}")
            ssm = [v for k, v in caches.items() if k.endswith("/ssm")]
            conv = [v for k, v in caches.items() if k.endswith("/conv")]
            check(ssm and conv and all(
                v[2:] == [h // n, full.ssm_head_dim, state] for v in ssm)
                and all(v[2:] == [full.ssm_conv_width - 1,
                                  din // n + 2 * state] for v in conv),
                f"{name} TP decode caches {caches}")
            res.update(serve_launches=counts, serve_wall_s=wall,
                       serve_peak_gib=by_rank(peak), heads=seen,
                       caches=caches, param_bytes=pbytes, logits=gate)
            say(f"{name} TP (1, {n}): batch serve equal to world 1 (p_hat "
                f"within {BF16_TOL}), launches {counts}; prefill logits "
                f"{gate}; SSD at {h // n} "
                f"heads: {seen}; caches "
                f"{sorted(set(map(tuple, ssm + conv)))}; param bytes "
                f"{pbytes}; serve wall {wall:.4f} s, peaks "
                f"{res['serve_peak_gib']} GiB")
            release(torch)

            res["shallow"] = shallow_tp(torch, name, shallow, mesh, ref[
                "shallow"], L, ds, dev, rank)
            say(f"{name}@{shallow} TP (1, {n}): {res['shallow']}")

            cfg = ssm_cfg(name, layers)
            plain = init_params(cfg, seed=0, device=dev)
            params = ReasoningEstimator(cfg, plain).shard(mesh).params
            del plain
            release(torch)
            with HeadProbe() as probe:
                loss, grads = first_grads(torch, cfg, params, ds)
                errs = leaf_errs(torch, grads, ref["grads"] if rank == 0
                                 else None, dev, rank, scaled=True)
                del grads
                release(torch)
                sft = mesh_sft(torch, cfg, params, ds)
            sbytes = rank_bytes(sft["state"].mu) + rank_bytes(sft["state"].nu)
            del params, sft["params"], sft["state"]
            release(torch)
            rel = max(abs(a - b) / abs(b) for a, b in zip(
                sft["losses"], ref["sft"], strict=True))
            check(rel <= BF16_TOL, f"{name} TP SFT losses {sft['losses']} "
                  f"vs world 1 {ref['sft']}")
            if rank == 0:
                res["grad_errs"] = grad_gate(errs, ref["grads_vs_f32"],
                                             f"{name}@{cfg.num_layers}",
                                             shallow=False)
            sft_heads = probe.seen()
            check(list(sft_heads["ssd"]) == [str(h // n)],
                  f"{name} TP SFT SSD heads {sft_heads}")
            sft["peak_gib_by_rank"] = by_rank(sft["peak_gib"])
            res.update(sft=sft, sft_rel_err=rel, sft_heads=sft_heads,
                       sft_layers=cfg.num_layers, adamw_bytes=sbytes,
                       first_loss=loss)
            say(f"{name}@{cfg.num_layers} TP SFT: losses {sft['losses']} "
                f"(world 1 {ref['sft']}, {rel:.2e} rel); first-step "
                f"gradient leaves {res.get('grad_errs')} of their largest "
                f"from world 1's; step walls "
                f"{[round(w, 3) for w in sft['walls_s']]} s, peak by rank "
                f"{sft['peak_gib_by_rank']} GiB, launches {sft['launches']}")
        if rank == 0:
            t1 = time.perf_counter()
            out["kernels"] = ssm_tp_kernel_rows(torch, n, L,
                                                ds["tokens"].shape[1])
            say(f"SSD kernel rows at a rank's heads: "
                f"{time.perf_counter() - t1:.1f} s")
        dist.barrier()
        out["job_s"] = time.perf_counter() - t0
        say(f"the job: {out['job_s']:.1f} s")
        if rank == 0:
            Path(path).write_text(json.dumps(out, default=str))
    finally:
        dist.destroy_process_group()
    return 0


# deepseek-v2-lite-16b over TP (1, n) (``mesh_mla_rank``): each MLA layer
# on 16 / n heads, its latent whole on every rank.  Held to world 1 on
# rank 0's card from the same seeded weights: the batch serve at full depth
# (27 layers), one batch's prefill logits and the first SFT step's
# gradient leaves at MLA_SHALLOW layers (the dense MLA layer and one MLA +
# MoE layer), the gradient leaves and MESH_TRAIN_STEPS SFT steps at
# MOE_FSDP's depth; logits and gradients gated as the SSM job's
# (``logit_gate``, ``grad_gate``)
MLA_SHALLOW = 2


def mla_world1(torch, world, data, anchors, lib, qids, L: int, ds) -> dict:
    """deepseek-v2-lite-16b on this card alone (rank 0 of ``mesh_mla_rank``
    while the others wait), from seeded weights: at ``MLA_SHALLOW`` layers
    the prefill logits and the first step's gradient leaves, each beside the
    same weights' in float32 (``ssm_logits``, ``ssm_grads``); the batch
    serve at full depth (decisions, parsed fields, launches, wall, peak);
    at ``MOE_FSDP``'s depth the first step's gradient leaves (and float32's)
    and ``mesh_sft``'s steps."""
    name, layers = MOE_FSDP
    cut = ssm_cfg(name, MLA_SHALLOW)
    params, _ = full_params(torch, cut, 0.0)
    logits, logits32 = ssm_logits(torch, cut, params, L)
    grads, grads_vs_f32 = ssm_grads(torch, cut, params, ds)
    ref = {"shallow": {"logits": logits, "logits_f32": logits32,
                       "grads": grads, "grads_vs_f32": grads_vs_f32}}
    del params
    release(torch)
    full = ssm_cfg(name)
    params, _ = full_params(torch, full, 15e9)
    engine = make_engine(full, params, anchors, lib, world, data, "cuda")
    del params
    dec, fields, counts, wall, peak = mesh_serve(torch, engine, data, qids)
    del engine
    release(torch)
    ref["serve"] = {"decisions": dec, "fields": fields, "launches": counts,
                    "wall_s": wall, "peak_gib": peak}
    cfg = ssm_cfg(name, layers)
    params, _ = full_params(torch, cfg, 3e9)
    ref["grads"], ref["grads_vs_f32"] = ssm_grads(torch, cfg, params, ds)
    sft = mesh_sft(torch, cfg, params, ds)
    del params, sft["params"], sft["state"]
    release(torch)
    ref["sft"] = sft
    return ref


def mla_tp_kernel_rows(torch, n: int, L: int, s_train: int):
    """The flash forward and backward at the heads a rank of a (1, n) mesh
    computes for deepseek-v2-lite-16b's MLA (16 / n heads at g 1, q / k
    192, v 128, the scale 192 ** -0.5 as ``mla_full`` passes it), as rows
    2d and 7d at 16 heads: each against its plain version on the card (max
    |err|), its time, bound and yardstick."""
    from repro_torch.kernels import flash_attention as FA
    h, tag = 16 // n, f"@tp{n}/deepseek-v2-lite-16b"
    kw = dict(scale=192 ** -0.5)
    rows = attention_timings(torch, L, 0.0, shapes=(
        (tag, h, h, (192, 128), 0.0, SERVE_FLASH),))
    gen = torch.Generator(device="cuda").manual_seed(36)
    bwd = "flash_attention_bwd" + tag
    rows[bwd] = bwd_timing(torch, gen, s_train, hq=h, hkv=h, d=192, dv=128,
                           label=bwd, **kw)

    def view(b, s, w):
        return torch.randn(b, s, h, w, generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    q, k, v = view(56, L, 192), view(56, L, 192), view(56, L, 128)
    errs = {"flash_attention": err(FA.flash_attention_cuda(q, k, v, **kw),
                                   FA.flash_attention_plain(q, k, v, **kw))}
    q, k, v = (view(SFT_BATCH, s_train, w).requires_grad_(True)
               for w in (192, 192, 128))
    dout = view(SFT_BATCH, s_train, 128).contiguous()
    with torch.no_grad():
        out, lse = FA.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = FA.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    want = torch.autograd.grad(FA.flash_attention_plain(q, k, v, **kw),
                               (q, k, v), dout)
    errs["flash_attention_bwd"] = max(err(a, b) for a, b in zip(
        got, want, strict=True))
    # gradients reach ~10, where one bf16 step is 0.06 (bwd_checks' scale)
    scale = {"flash_attention_bwd": max(1.0, max(
        w.float().abs().max().item() for w in want))}
    for name, e in errs.items():
        check(e <= BF16_TOL * scale.get(name, 1.0),
              f"{name}{tag}: {e:.3e} from its plain version")
        rows[name + tag]["max_abs_err"] = e
    release(torch)
    return rows


def mesh_mla_rank(path: str) -> int:
    """One rank of ``mesh_train_world``'s fourth job, which needs nothing
    from the parent: deepseek-v2-lite-16b with each MLA layer on 16 / n
    heads over TP (1, n), held to world 1 on rank 0's card from the same
    seeded weights (``mla_world1``; the other ranks wait): the batch serve
    at full depth (decisions and parsed fields within 3e-2, launches
    equal), the heads of every flash call, the latent decode caches whole,
    the rank's param bytes against ``local_bytes``; the logits and
    first-step gradient leaves at ``MLA_SHALLOW`` layers (``shallow_tp``);
    at ``MOE_FSDP``'s depth the first step's gradient leaves and
    ``MESH_TRAIN_STEPS`` SFT steps (losses within 3e-2 relative), with
    every card's peak.  Rank 0 adds the flash kernels' rows at a rank's
    heads (``mla_tp_kernel_rows``) and writes what it found."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import init_distributed, make_serve_mesh
    from repro_torch.models.model import init_params
    dev = init_distributed()
    n, rank = dist.get_world_size(), dist.get_rank()
    out = {"world": n, "smi": nvidia_smi(), "mesh": [1, n]}
    t0 = time.perf_counter()

    def say(msg):
        if rank == 0:
            print(f"   [world {n} mla, {time.perf_counter() - t0:.0f} s] "
                  f"{msg}", flush=True)

    def by_rank(x: float):
        got = [torch.zeros((), device=dev) for _ in range(n)]
        dist.all_gather(got, torch.zeros((), device=dev) + x)
        return [float(v) for v in got]

    try:
        world, data, anchors, lib = build_world()
        qids = [int(q) for q in data.test_qids[:N_QUERIES]]
        L = prompt_len(world, data, anchors, lib, qids)
        ds = sft_dataset()
        name, layers = MOE_FSDP
        ref = None
        if rank == 0:
            ref = mla_world1(torch, world, data, anchors, lib, qids, L, ds)
            one = ref["serve"]
            out["world1"] = {"serve": {k: one[k] for k in (
                "launches", "wall_s", "peak_gib")}, "sft": ref["sft"]}
            say(f"{name} world 1 on rank 0's card: batch serve launches "
                f"{one['launches']}, wall {one['wall_s']:.4f} s, peak "
                f"{one['peak_gib']:.2f} GiB; {name}@{layers} SFT losses "
                f"{ref['sft']['losses']}, step walls "
                f"{[round(w, 3) for w in ref['sft']['walls_s']]} s, peak "
                f"{ref['sft']['peak_gib']:.2f} GiB")
        # world 1's serve and losses on every rank
        small = [None if ref is None else {"serve": ref["serve"],
                                           "sft": ref["sft"]["losses"]}]
        dist.broadcast_object_list(small, src=0)
        small = small[0]
        mesh = make_serve_mesh(n_data=1, n_model=n)
        full = ssm_cfg(name)
        split = coll.model_split(full, mesh)
        check(split.attn, f"{name}: MLA computes whole on (1, {n}): {split}")
        h = full.num_heads // n
        heads = f"{h}/{h}"
        plain = init_params(full, seed=0, device=dev)
        with HeadProbe() as probe:
            eng = make_engine(full, plain, anchors, lib, world, data, dev)
            eng.estimator.shard(mesh)
            del plain
            pbytes = rank_bytes(eng.estimator.params)
            want_bytes = spec_bytes(mesh, full)
            check(pbytes == want_bytes, f"{name} TP param bytes {pbytes} vs "
                  f"local_bytes {want_bytes}")
            dec, fields, counts, wall, peak = mesh_serve(torch, eng, data,
                                                         qids)
            run = eng.estimator.open_slots(np.full((4, L), 5, np.int32))
            caches = {f"{i}/{j}/{k}": list(t.shape) for i, seg in
                      enumerate(run.state.caches) for j, unit in seg.items()
                      for k, t in unit.items()}
            del run, eng
        release(torch)
        check(close_decisions(dec, small["serve"]["decisions"], BF16_TOL)
              and close_fields(fields, small["serve"]["fields"], BF16_TOL),
              f"{name} TP world {n}: the batch serve differs from world 1")
        check(counts == small["serve"]["launches"],
              f"{name} TP launches {counts} vs world 1 "
              f"{small['serve']['launches']}")
        seen = probe.seen()
        check(list(seen) == ["flash_attention"]
              and list(seen["flash_attention"]) == [heads],
              f"{name} TP attention heads {seen}, want flash at {heads}")
        width = {"c_kv": full.kv_lora_rank, "k_rope": full.qk_rope_head_dim}
        check(caches and all(
            k.split("/")[-1] in width and v[1] == 4
            and v[-1] == width[k.split("/")[-1]] for k, v in caches.items()),
            f"{name} TP decode caches {caches}: want the latents whole")
        out["serve"] = dict(launches=counts, wall_s=wall,
                            peak_gib=by_rank(peak), heads=seen,
                            caches=caches, param_bytes=pbytes)
        say(f"{name} TP (1, {n}): batch serve equal to world 1 (p_hat within "
            f"{BF16_TOL}), launches {counts}; flash at {heads} heads: "
            f"{seen}; caches {sorted(set(map(tuple, caches.values())))}; "
            f"param bytes {pbytes}; serve wall {wall:.4f} s, peaks "
            f"{out['serve']['peak_gib']} GiB")

        out["shallow"] = shallow_tp(
            torch, name, MLA_SHALLOW, mesh,
            None if ref is None else ref["shallow"], L, ds, dev, rank)
        say(f"{name}@{MLA_SHALLOW} TP (1, {n}): {out['shallow']}")

        cfg = ssm_cfg(name, layers)
        plain = init_params(cfg, seed=0, device=dev)
        params = ReasoningEstimator(cfg, plain).shard(mesh).params
        del plain
        release(torch)
        with HeadProbe() as probe:
            loss, grads = first_grads(torch, cfg, params, ds)
            errs = leaf_errs(torch, grads, None if ref is None
                             else ref["grads"], dev, rank, scaled=True)
            del grads
            release(torch)
            sft = mesh_sft(torch, cfg, params, ds)
        sbytes = rank_bytes(sft["state"].mu) + rank_bytes(sft["state"].nu)
        del params, sft["params"], sft["state"]
        release(torch)
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            sft["losses"], small["sft"], strict=True))
        check(rel <= BF16_TOL, f"{name} TP SFT losses {sft['losses']} vs "
              f"world 1 {small['sft']}")
        if rank == 0:
            out["grad_errs"] = grad_gate(errs, ref["grads_vs_f32"],
                                         f"{name}@{layers}", shallow=False)
        sft_heads = probe.seen()
        check(list(sft_heads) == ["flash_attention"]
              and list(sft_heads["flash_attention"]) == [heads],
              f"{name} TP SFT attention heads {sft_heads}")
        sft["peak_gib_by_rank"] = by_rank(sft["peak_gib"])
        out.update(sft=sft, sft_rel_err=rel, sft_heads=sft_heads,
                   sft_layers=layers, adamw_bytes=sbytes, first_loss=loss)
        say(f"{name}@{layers} TP SFT: losses {sft['losses']} (world 1 "
            f"{small['sft']}, {rel:.2e} rel); first-step gradient leaves "
            f"{out.get('grad_errs')} of their largest from world 1's; step "
            f"walls {[round(w, 3) for w in sft['walls_s']]} s, peak by rank "
            f"{sft['peak_gib_by_rank']} GiB, launches {sft['launches']}")
        del ref
        release(torch)
        if rank == 0:
            t1 = time.perf_counter()
            out["kernels"] = mla_tp_kernel_rows(torch, n, L,
                                                ds["tokens"].shape[1])
            say(f"flash kernel rows at a rank's MLA heads: "
                f"{time.perf_counter() - t1:.1f} s")
        dist.barrier()
        out["job_s"] = time.perf_counter() - t0
        say(f"the job: {out['job_s']:.1f} s")
        if rank == 0:
            Path(path).write_text(json.dumps(out, default=str))
    finally:
        dist.destroy_process_group()
    return 0


# whisper-medium over TP (1, n) (``mesh_cross_rank``): the encoder's and
# the decoder's self-attention and the decoder's cross-attention each on
# 16 / n heads, a rank's ``ck`` / ``cv`` its own heads'.  Held to world 1 on
# rank 0's card from the same seeded weights: the audio serve at full depth
# (24 + 24 layers, 56 rows x 49 tokens + 1500 frames, ``NEW_TOKENS`` steps)
# teacher-forced with world 1's tokens, its logits gated by ``logit_gate``
# on the first CROSS_F32_ROWS rows (world 1's float32 serve of those rows,
# forced alike, the yardstick) and beside world 1's on every row; one
# batch's prefill logits and the first SFT step's gradient leaves at
# CROSS_SHALLOW encoder and decoder layers; MESH_TRAIN_STEPS SFT steps at
# full depth (FAMILY_TRAIN's 64 x 57 tokens)
CROSS_SHALLOW = 2
CROSS_F32_ROWS = 8
AUDIO_SEED = 8              # the audio serve's stubs (phase 12e's too)


def audio_serve(torch, cfg, params, L: int, forced=None) -> dict:
    """whisper's model-level serve of 56 rows x ``L`` tokens and their
    frames (``stub_generate``, seed ``AUDIO_SEED``; given ``forced``, its
    tokens fed): a warm-up, then a run with its walls, the prefill's and
    the decode's launches (flash by shape), the prefill caches' shapes and
    the peak: the tokens and float32 logits on the host."""
    batch = stub_batch(torch, cfg, 56, L, seed=AUDIO_SEED, device="cuda")
    stub_generate(torch, params, cfg, batch, 2)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, parts, shapes = {}, {}, {}
    toks, logits = stub_generate(torch, params, cfg, batch, NEW_TOKENS,
                                 forced=forced, walls=walls, parts=parts,
                                 shapes=shapes)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: non-finite "
          "serve logits")
    del batch
    return {"tokens": toks.cpu(), "logits": logits.cpu(), "walls": walls,
            "parts": {part: {**c, "flash_by_shape": {
                str(key): k for key, k in c["flash_by_shape"].items()}}
                for part, c in parts.items()},
            "caches": shapes, "peak_gib": peak}


def cross_world1(torch, L: int, ds) -> dict:
    """whisper-medium on this card alone (rank 0 of ``mesh_cross_rank``
    while the others wait), from seeded weights: at ``CROSS_SHALLOW``
    encoder and decoder layers the prefill logits and the first step's
    gradient leaves, each beside the same weights' in float32
    (``ssm_logits``, ``ssm_grads``); at full depth the audio serve
    (``audio_serve``), its first ``CROSS_F32_ROWS`` rows again in float32
    fed the serve's tokens, and ``mesh_sft``'s steps with the flash
    backward's launches by shape."""
    import dataclasses
    from repro_torch.io import tree_map
    from repro_torch.kernels import flash_attention as FA
    name = AUDIO[1:]
    cut = ssm_cfg(name, CROSS_SHALLOW)
    params, _ = full_params(torch, cut, 0.0)
    logits, logits32 = ssm_logits(torch, cut, params, L)
    grads, grads_vs_f32 = ssm_grads(torch, cut, params, ds)
    ref = {"shallow": {"logits": logits, "logits_f32": logits32,
                       "grads": grads, "grads_vs_f32": grads_vs_f32}}
    del params
    release(torch)
    full = ssm_cfg(name)
    params, _ = full_params(torch, full, FAMILY_TRAIN[name][0])
    ref["serve"] = serve = audio_serve(torch, full, params, L)
    rows = slice(0, CROSS_F32_ROWS)
    batch = stub_batch(torch, full, 56, L, seed=AUDIO_SEED, device="cuda")
    p32 = tree_map(lambda t: t.float(), params)
    _, logits32 = stub_generate(
        torch, p32, dataclasses.replace(full, dtype="float32"),
        as_float32({k: v[rows] for k, v in batch.items()}), NEW_TOKENS,
        forced=serve["tokens"][rows].to(batch["tokens"].device))
    serve["logits_f32"] = logits32.cpu()
    del p32, batch, logits32
    release(torch)
    sft = mesh_sft(torch, full, params, ds)
    sft["bwd_by_shape"] = {str(k): v for k, v in
                           FA.bwd_shape_launches.items()}
    del params, sft["params"], sft["state"]
    release(torch)
    ref["sft"] = sft
    return ref


def cross_tp_kernel_rows(torch, n: int, L: int):
    """The attention kernels at the heads a rank of a (1, n) mesh computes
    for whisper-medium (16 / n heads of 64, g 1), as rows 2w-enc,
    2w-cross, 2w-cross-sq1, 3w and 7w at 16 heads: the flash forward over
    the encoder's 56 x 1500 frames, the cross-attention at 56 x L and at
    sq = 1 over them, the dense decode at L + 12 keys, the flash backward
    over the encoder at the SFT batch; each against its plain version on
    the card (max |err|), its time, bound and yardstick."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    h, tag = 16 // n, f"@tp{n}/{AUDIO[1:]}"
    calls = (("/encoder", 56, ENC_FRAMES, ENC_FRAMES, False, 10),
             ("/cross", 56, None, ENC_FRAMES, False, 50),
             ("/cross-sq1", 56, 1, ENC_FRAMES, False, 200))
    rows = attention_timings(torch, L, 0.0, shapes=(
        (tag, h, h, 64, 0.0, calls),))
    gen = torch.Generator(device="cuda").manual_seed(38)
    bwd = "flash_attention_bwd" + tag + "/encoder"
    rows[bwd] = bwd_timing(torch, gen, ENC_FRAMES, hq=h, hkv=h, d=64,
                           label=bwd, b=FAMILY_TRAIN[AUDIO[1:]][2],
                           sk=ENC_FRAMES, causal=False)

    def view(b, s):
        return torch.randn(b, s, h, 64, generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    errs, scale = {}, {}
    for suffix, b, sq, sk, _, _ in calls:
        q, k, v = view(b, sq or L), view(b, sk), view(b, sk)
        row = "flash_attention" + tag + suffix
        want = FA.flash_attention_plain(q, k, v, causal=False)
        errs[row] = err(FA.flash_attention_cuda(q, k, v, causal=False), want)
        # over 1500 keys an output is ~0.05: held relative to max|want|
        scale[row] = min(1.0, want.float().abs().max().item())
        del q, k, v, want
    S = L + NEW_TOKENS
    qd = view(56, 1).contiguous()
    kc, vc = view(56, S).contiguous(), view(56, S).contiguous()
    lens = torch.full((56,), S, dtype=torch.int32, device="cuda")
    errs["decode_attention" + tag] = err(
        DA.decode_attention_cuda(qd, kc, vc, lens),
        DA.decode_attention_plain(qd, kc, vc, lens))
    del qd, kc, vc
    b = FAMILY_TRAIN[AUDIO[1:]][2]
    q, k, v = (view(b, ENC_FRAMES).requires_grad_(True) for _ in range(3))
    dout = view(b, ENC_FRAMES).contiguous()
    with torch.no_grad():
        out, lse = FA.flash_attention_cuda(q, k, v, causal=False,
                                           return_lse=True)
    got = FA.flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=False)
    want = torch.autograd.grad(FA.flash_attention_plain(q, k, v,
                                                        causal=False),
                               (q, k, v), dout)
    errs[bwd] = max(err(a, c) for a, c in zip(got, want, strict=True))
    # gradients reach ~10, where one bf16 step is 0.06 (bwd_checks' scale)
    scale[bwd] = max(1.0, max(w.float().abs().max().item() for w in want))
    del q, k, v, dout, out, lse, got, want
    for row, e in errs.items():
        check(e <= BF16_TOL * scale.get(row, 1.0),
              f"{row}: {e:.3e} from its plain version")
        rows[row]["max_abs_err"] = e
    release(torch)
    return rows


def mesh_cross_rank(path: str) -> int:
    """One rank of ``mesh_train_world``'s fifth job, which needs nothing
    from the parent: whisper-medium with its encoder's and decoder's
    attention and its decoder's cross-attention on 16 / n heads over TP (1,
    n), held to world 1 on rank 0's card from the same seeded weights
    (``cross_world1``; the other ranks wait): the audio serve at full depth
    fed world 1's tokens (logits through ``logit_gate``, the prefill's and
    the decode's launches equal, flash by shape too), the heads of every
    flash and dense decode call, a rank's ``k`` / ``v`` / ``ck`` / ``cv``
    at 16 / n heads, the rank's param bytes against ``local_bytes``; the
    logits and first-step gradient leaves at ``CROSS_SHALLOW`` layers
    (``shallow_tp``); ``MESH_TRAIN_STEPS`` SFT steps at full depth (losses
    within 3e-2 relative, launches equal), with every card's peaks.  Rank 0
    adds the kernels' rows at a rank's heads (``cross_tp_kernel_rows``),
    their launches from its own TP run, and writes what it found."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.mesh import init_distributed, make_serve_mesh
    from repro_torch.models.model import init_params
    dev = init_distributed()
    n, rank = dist.get_world_size(), dist.get_rank()
    out = {"world": n, "smi": nvidia_smi(), "mesh": [1, n]}
    t0 = time.perf_counter()
    name = AUDIO[1:]

    def say(msg):
        if rank == 0:
            print(f"   [world {n} cross, {time.perf_counter() - t0:.0f} s] "
                  f"{msg}", flush=True)

    def by_rank(x: float):
        got = [torch.zeros((), device=dev) for _ in range(n)]
        dist.all_gather(got, torch.zeros((), device=dev) + x)
        return [float(v) for v in got]

    try:
        world, data, anchors, lib = build_world()
        qids = [int(q) for q in data.test_qids[:N_QUERIES]]
        L = prompt_len(world, data, anchors, lib, qids)
        ds = sft_dataset()
        ref = None
        if rank == 0:
            ref = cross_world1(torch, L, ds)
            one, sft1 = ref["serve"], ref["sft"]
            out["world1"] = {"serve": {k: one[k] for k in (
                "walls", "parts", "caches", "peak_gib")}, "sft": sft1}
            say(f"{name} world 1 on rank 0's card: audio serve walls "
                f"{one['walls']}, peak {one['peak_gib']:.2f} GiB; SFT "
                f"losses {sft1['losses']}, step walls "
                f"{[round(w, 3) for w in sft1['walls_s']]} s, peak "
                f"{sft1['peak_gib']:.2f} GiB")
        # world 1's tokens, launches and losses on every rank
        small = [None if ref is None else {
            "tokens": ref["serve"]["tokens"].tolist(),
            "parts": ref["serve"]["parts"],
            "sft": {k: ref["sft"][k] for k in ("losses", "launches",
                                               "bwd_by_shape")}}]
        dist.broadcast_object_list(small, src=0)
        small = small[0]
        mesh = make_serve_mesh(n_data=1, n_model=n)
        full = ssm_cfg(name)
        split = coll.model_split(full, mesh)
        check(split.attn, f"{name}: attention computes whole on (1, {n}): "
              f"{split}")
        h = full.num_heads // n
        heads = f"{h}/{h}"
        plain = init_params(full, seed=0, device=dev)
        params = ReasoningEstimator(full, plain).shard(mesh).params
        del plain
        release(torch)
        pbytes = rank_bytes(params)
        want_bytes = spec_bytes(mesh, full)
        check(pbytes == want_bytes, f"{name} TP param bytes {pbytes} vs "
              f"local_bytes {want_bytes}")
        forced = torch.tensor(small["tokens"], dtype=torch.int32, device=dev)
        with HeadProbe() as probe:
            serve = audio_serve(torch, full, params, L, forced=forced)
        check(serve["parts"] == small["parts"],
              f"{name} TP serve launches {serve['parts']} vs world 1 "
              f"{small['parts']}")
        seen = probe.seen()
        check(sorted(seen) == ["decode_attention", "flash_attention"]
              and all(list(c) == [heads] for c in seen.values()),
              f"{name} TP attention heads {seen}, want {heads}")
        frames = full.encoder_seq_len
        want = {"k": L, "v": L, "ck": frames, "cv": frames}
        check(serve["caches"] == {
            f"0/0/{k}": [full.num_layers, 56, h, s, full.resolved_head_dim]
            for k, s in want.items()},
            f"{name} TP prefill caches {serve['caches']}: want the rank's "
            f"{h} heads")
        out["serve"] = {"walls": serve["walls"], "parts": serve["parts"],
                        "peak_gib": by_rank(serve["peak_gib"]),
                        "heads": seen, "caches": serve["caches"],
                        "param_bytes": pbytes}
        if rank == 0:
            rows = slice(0, CROSS_F32_ROWS)
            one = ref["serve"]
            out["serve"]["logits"] = dict(logit_gate(
                serve["logits"][rows], {"logits": one["logits"][rows],
                                        "logits_f32": one["logits_f32"]},
                f"{name} TP serve"),
                every_row_tp_vs_world1=logit_dist(serve["logits"],
                                                  one["logits"]))
        del serve
        release(torch)
        say(f"{name} TP (1, {n}): audio serve fed world 1's tokens, "
            f"launches equal ({out['serve']['parts']['decode']}); heads "
            f"{seen}; caches {out['serve']['caches']}; param bytes "
            f"{pbytes}; walls {out['serve']['walls']}, peaks "
            f"{out['serve']['peak_gib']} GiB; logits {out['serve'].get('logits')}")

        out["shallow"] = shallow_tp(
            torch, name, CROSS_SHALLOW, mesh,
            None if ref is None else ref["shallow"], L, ds, dev, rank)
        say(f"{name}@{CROSS_SHALLOW}+{CROSS_SHALLOW} TP (1, {n}): "
            f"{out['shallow']}")

        with HeadProbe() as probe:
            sft = mesh_sft(torch, full, params, ds)
        sft["bwd_by_shape"] = {str(k): v for k, v in
                               FA.bwd_shape_launches.items()}
        sbytes = rank_bytes(sft["state"].mu) + rank_bytes(sft["state"].nu)
        del params, sft["params"], sft["state"]
        release(torch)
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            sft["losses"], small["sft"]["losses"], strict=True))
        check(rel <= BF16_TOL, f"{name} TP SFT losses {sft['losses']} vs "
              f"world 1 {small['sft']['losses']}")
        check(sft["launches"] == small["sft"]["launches"]
              and sft["bwd_by_shape"] == small["sft"]["bwd_by_shape"],
              f"{name} TP SFT launches {sft['launches']} "
              f"{sft['bwd_by_shape']} vs world 1 {small['sft']}")
        sft_heads = probe.seen()
        check(list(sft_heads) == ["flash_attention"]
              and list(sft_heads["flash_attention"]) == [heads],
              f"{name} TP SFT attention heads {sft_heads}")
        sft["peak_gib_by_rank"] = by_rank(sft["peak_gib"])
        out.update(sft=sft, sft_rel_err=rel, sft_heads=sft_heads,
                   adamw_bytes=sbytes)
        say(f"{name} TP SFT: losses {sft['losses']} (world 1 "
            f"{small['sft']['losses']}, {rel:.2e} rel); step walls "
            f"{[round(w, 3) for w in sft['walls_s']]} s, peak by rank "
            f"{sft['peak_gib_by_rank']} GiB, launches {sft['launches']}")
        del ref
        release(torch)
        if rank == 0:
            t1 = time.perf_counter()
            out["kernels"] = cross_tp_kernel_rows(torch, n, L)
            tag, pre, dec = (f"@tp{n}/{name}", out["serve"]["parts"][
                "prefill"], out["serve"]["parts"]["decode"])
            enc = str((frames, frames, False))
            out["row_launches"] = {
                f"flash_attention{tag}/encoder": pre["flash_by_shape"][enc],
                f"flash_attention{tag}/cross": pre["flash_by_shape"][
                    str((L, frames, False))],
                f"flash_attention{tag}/cross-sq1": dec["flash_by_shape"][
                    str((1, frames, False))],
                f"decode_attention{tag}": dec["decode_attention"],
                f"flash_attention_bwd{tag}/encoder": sft["bwd_by_shape"][enc]}
            say(f"kernel rows at a rank's whisper heads, launches "
                f"{out['row_launches']}: {time.perf_counter() - t1:.1f} s")
        dist.barrier()
        out["job_s"] = time.perf_counter() - t0
        say(f"the job: {out['job_s']:.1f} s")
        if rank == 0:
            Path(path).write_text(json.dumps(out, default=str))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_train_world(n, refs):
    """World ``n`` over NCCL, one process a card, in three jobs
    (``world_job``): ``chip_smoke.py --mesh-train-rank`` held to the
    world-1 runs ``refs`` (TP over a (1, n) mesh, FSDP over an (n, 1)
    mesh), then ``--mesh-moe-grpo-rank`` (the MoE families' rows over data,
    GRPO against world 1 on rank 0's card), then ``--mesh-ssm-rank``
    (mamba2-1.3b and zamba2-7b over TP, held to ``mesh_ssm_world1``'s saved
    figures), then ``--mesh-mla-rank`` (deepseek-v2-lite-16b's MLA heads
    over TP, against world 1 on rank 0's card), then ``--mesh-cross-rank``
    (whisper-medium's attention and cross-attention heads over TP, against
    world 1 on rank 0's card)."""
    refs_path = OUT_DIR / "mesh_train_refs.json"
    refs_path.write_text(json.dumps(refs, default=list))
    got = {job: world_job(n, job, args) for job, args in (
        ("train", ["--mesh-train-rank", str(refs_path)]),
        ("moe_grpo", ["--mesh-moe-grpo-rank"]),
        ("ssm", ["--mesh-ssm-rank", str(OUT_DIR / SSM_REFS)]),
        ("mla", ["--mesh-mla-rank"]),
        ("cross", ["--mesh-cross-rank"]))}
    out = dict(got["train"], **{k: v for k, v in got["moe_grpo"].items()
                                if k in ("moe_world1", "grpo", "moe_over_cards")})
    out["fsdp"].update(got["moe_grpo"]["fsdp"])
    out["ssm"] = got["ssm"]
    out["mla"] = got["mla"]
    out["cross"] = got["cross"]
    out["wall_s"] = {job: r["wall_s"] for job, r in got.items()}
    print(f"   world {n}: TP, FSDP, the MoE rows, GRPO, the SSM backbones, "
          f"MLA and whisper's cross-attention held to world 1, "
          f"{out['wall_s']} s")
    return out


def world_job(n, job: str, args) -> dict:
    """``chip_smoke.py <args> <out>`` over ``n`` cards under
    torch.distributed.run, one process a card: what rank 0 wrote to
    ``out``, with the job's wall (printed)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    path = OUT_DIR / f"mesh_{job}_world.json"
    # the ranks print to this process's output as they go (rank 0's lines
    # carry their time since the job started); their errors go to a file
    err = OUT_DIR / f"mesh_{job}_world.err"
    t0 = time.perf_counter()
    sys.stdout.flush()
    with open(err, "w") as f:
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", str(n), "--master-port", str(free_port()),
             str(Path(__file__).resolve()), *args, str(path)], env=env,
            stderr=f, timeout=1500)
    check(res.returncode == 0, f"world {n} {job} exit {res.returncode}: "
          f"{err.read_text()[-3000:]}")
    got = json.loads(path.read_text())
    got["wall_s"] = time.perf_counter() - t0
    print(f"   world {n} {job} job: {got['wall_s']:.1f} s", flush=True)
    return got


def tp_kernel_rows(torch, n: int, L: int, s_train: int):
    """The kernels at the heads a rank of a (1, n) mesh computes
    (scope-qwen3-4b's 32/n on 8/n of 128): each against its plain version
    on the card (max |err|), its time, bound and yardstick, as the
    timing phase gives them at 32 on 8."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    hq, hkv = QWEN_HEADS[0] // n, QWEN_HEADS[1] // n
    tag = f"@tp{n}"
    rows = attention_timings(torch, L, 0.0, shapes=(
        (tag, hq, hkv, 128, 0.0, SERVE_FLASH),))
    gen = torch.Generator(device="cuda").manual_seed(31)
    rows["paged_decode_attention" + tag] = paged_timing(
        torch, gen, 56, hq, hkv, 128, L + NEW_TOKENS)
    rows["flash_attention_bwd" + tag] = bwd_timing(
        torch, gen, s_train, hq=hq, hkv=hkv,
        label="flash_attention_bwd" + tag)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    q, k, v = randn(56, hq, L, 128), randn(56, hkv, L, 128), \
        randn(56, hkv, L, 128)
    errs = {"flash_attention": err(FA.flash_attention_cuda(q, k, v),
                                   FA.flash_attention_plain(q, k, v))}
    S = L + NEW_TOKENS
    qd, kc, vc = randn(56, hq, 1, 128), randn(56, hkv, S, 128), \
        randn(56, hkv, S, 128)
    lens = torch.full((56,), S, dtype=torch.int32, device="cuda")
    errs["decode_attention"] = err(DA.decode_attention_cuda(qd, kc, vc, lens),
                                   DA.decode_attention_plain(qd, kc, vc,
                                                             lens))
    _, _, kp, vp, table = paged_layout(torch, gen, 56, hkv, S, 128, 128,
                                       PAGE, bf)
    kw = dict(page_size=PAGE, kv_cap=S)
    errs["paged_decode_attention"] = err(
        DA.paged_decode_attention_cuda(qd, kp, vp, lens, table, **kw),
        DA.paged_decode_attention_plain(qd, kp, vp, lens, table, **kw))
    q, k, v = (randn(SFT_BATCH, h, s_train, 128).requires_grad_(True)
               for h in (hq, hkv, hkv))
    dout = randn(SFT_BATCH, hq, s_train, 128)
    with torch.no_grad():
        out, lse = FA.flash_attention_cuda(q, k, v, return_lse=True)
    got = FA.flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    want = torch.autograd.grad(FA.flash_attention_plain(q, k, v), (q, k, v),
                               dout)
    errs["flash_attention_bwd"] = max(err(a, b) for a, b in zip(
        got, want, strict=True))
    # gradients reach ~10, where one bf16 step is 0.06 (bwd_checks' scale)
    scale = {"flash_attention_bwd": max(1.0, max(
        w.float().abs().max().item() for w in want))}
    for name, e in errs.items():
        check(e <= BF16_TOL * scale.get(name, 1.0),
              f"{name}{tag}: {e:.3e} from its plain version")
        rows[name + tag]["max_abs_err"] = e
    release(torch)
    return rows


def fsdp_sft(torch, cfg, mesh, dev, ds):
    """``mesh_sft`` of ``cfg`` from seeded weights sharded over the FSDP
    ``mesh``: the bytes of params and AdamW state a rank (held to
    ``local_bytes``), the rows a rank computes (a MoE batch split where
    its routing groups divide over ``data``), the peak of every rank."""
    import torch.distributed as dist
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.distributed import collectives as coll
    from repro_torch.models.model import init_params
    from repro_torch.models.moe import routing_groups
    est = ReasoningEstimator(cfg, init_params(cfg, seed=0, device=dev))
    params = est.shard(mesh).params
    del est
    release(torch)
    n = mesh.size()
    s = ds["tokens"].shape[1]
    rows = coll.train_rows(mesh, cfg, SFT_BATCH, s)
    whole = cfg.has_moe() and routing_groups(SFT_BATCH, s) % n
    check((rows is None) if whole else (
        rows is not None and rows.stop - rows.start == SFT_BATCH // n),
        f"{cfg.name} FSDP rows {rows} at world {n}")
    res = mesh_sft(torch, cfg, params, ds)
    sbytes = rank_bytes(res["state"].mu) + rank_bytes(res["state"].nu)
    pbytes = rank_bytes(res["params"])
    want = (spec_bytes(mesh, cfg), 2 * spec_bytes(mesh, cfg, torch.float32))
    check((pbytes, sbytes) == want, f"{cfg.name} FSDP bytes "
          f"{(pbytes, sbytes)} vs local_bytes {want}")
    del params, res["params"], res["state"]
    release(torch)
    gathered = [torch.zeros((), device=dev) for _ in range(n)]
    dist.all_gather(gathered, torch.zeros((), device=dev) + res["peak_gib"])
    res["peak_gib_by_rank"] = [float(x) for x in gathered]
    res.update(param_bytes=pbytes, adamw_bytes=sbytes,
               num_layers=cfg.num_layers,
               rows=SFT_BATCH if rows is None else rows.stop - rows.start)
    return res


def leaf_errs(torch, params, want, dev, rank, scaled=False):
    """The largest |difference| of each leaf of sharded ``params`` (each
    gathered whole, a collective of every rank) from rank 0's host copy
    ``want`` (over the leaf's largest |value| where ``scaled``); None on
    the other ranks."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.io import flatten
    errs = {}
    want = flatten(want) if rank == 0 else None
    for key, t in flatten(params).items():
        whole = t.full_tensor() if coll.is_sharded(t) else t
        if rank == 0:
            w = want[key].to(dev).float()
            err = (whole.float() - w).abs().max().item()
            errs[key] = err / max(w.abs().max().item(), 1e-30) if scaled \
                else err
            del w
        del whole
    return errs if rank == 0 else None


def held_to_world1(key, res, ref):
    """``res``'s losses and MoE ``aux`` (where not 0) against world 1's
    ``ref``, each within 3e-2 relative: the largest errors go in
    ``res["rel_err"]``."""
    res["rel_err"] = {k: max(abs(a - b) / abs(b) for a, b in zip(
        res[k], ref[k], strict=True) if b)
        for k in ("losses", "aux") if any(ref[k])}
    check(all(e <= BF16_TOL for e in res["rel_err"].values()),
          f"{key} FSDP losses {res['losses']} / aux {res['aux']} vs world "
          f"1 {ref}")


def fsdp_line(n, key, res) -> str:
    return (f"FSDP ({n}, 1) {key}: losses {res['losses']}, aux "
            f"{res['aux']}" + (f" (rel err to world 1 {res['rel_err']})"
                               if "rel_err" in res else "")
            + f", rows a rank {res['rows']}, step walls "
            f"{[round(w, 3) for w in res['walls_s']]} s, peak by rank "
            f"{res['peak_gib_by_rank']} GiB, bytes a rank: params "
            f"{res['param_bytes']}, AdamW {res['adamw_bytes']}")


def fixed_grpo_batch(torch, batch):
    """A GRPO batch whose policy gradient is not 0: a greedy step's
    rollouts and mask with an advantage a rollout drawn from
    ``default_rng(31)``.  A group's greedy rollouts are equal, so
    advantages normalized within it (the step's own) give the group no
    gradient at all."""
    import numpy as np
    adv = np.random.default_rng(31).standard_normal(
        batch["adv"].shape[0]).astype(np.float32)
    return {"tokens": batch["tokens"], "gen_mask": batch["gen_mask"],
            "adv": torch.from_numpy(adv)}


def grpo_grads(torch, cfg, params, batch, dev):
    """On a host ``fixed_grpo_batch``: its log-probs under ``params``
    (whole rows on every rank, no gradient) as both the old and the
    reference log-probs, then ``grpo_loss`` there, where the ratio is 1 and
    the KL 0: (loss, pg, kl, the gradient, the log-probs on the host)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    from repro_torch.training.grpo import grpo_loss, sequence_logprobs
    from repro_torch.training.optimizer import value_and_grad
    b = {k: v.to(dev) for k, v in batch.items()}
    B = b["tokens"].shape[0]
    with torch.no_grad():
        local, lay = M.local_batch(params, cfg, b)
        lp, _ = sequence_logprobs(params, cfg, local["tokens"],
                                  local["gen_mask"], lay=lay)
        if lp.shape[0] < B:
            lp = shd.gather_rows(coll.mesh_of(params), B, lp)
    b.update(old_logp=lp, ref_logp=lp)
    loss, metrics, grads = value_and_grad(
        lambda p: grpo_loss(p, cfg, b, 0.2, 0.02), params)
    return (float(loss), float(metrics["pg"]), float(metrics["kl"]), grads,
            lp.cpu())


def grpo_rounds(torch, dev, n, rank, say):
    """scope-qwen3-4b's greedy GRPO step (``mesh_grpo``) from seeded
    weights, in two rounds of: world 1 on rank 0's card (the others wait),
    TP over (1, n), FSDP over (n, 1).  The first round holds each mesh to
    world 1.  Before its step, on world 1's rollouts with drawn advantages
    (``fixed_grpo_batch``, ``grpo_grads``) and the same fresh weights: the
    log-prob of every generated token within ``GRPO_LP_TOL`` (largest,
    median) and every gradient leaf within ``GRPO_GRAD_TOL`` of its largest
    |value| of world 1's.  After it: the rollouts equal on every rank, the
    loss and every param leaf within 3e-2.  A mesh's own rollouts may
    differ from world 1's, and under TP a group's greedy rollouts from one
    prompt from each other (its all-reduce sums a row's columns in an order
    that depends on the row), so its advantages and update need not be
    world 1's; the run records how many differ.  Walls and per-card peaks
    of both rounds."""
    import torch.distributed as dist
    from repro_torch.configs.scope_estimator import CONFIG
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models.model import init_params
    meshes = {"tp": (1, n), "fsdp": (n, 1)}
    out = {"world1": [], **{k: [] for k in meshes}}
    host, fixed = None, None
    for round_ in range(2):
        if rank == 0:
            def keep(i, p, step):
                if round_:
                    return None
                return {"params": _to(p, "cpu"),
                        "batch": fixed_grpo_batch(torch, step["batch"]),
                        "tokens": step["batch"]["tokens"]}
            w1, = mesh_grpo(torch, CONFIG, init_params(CONFIG, seed=0,
                                                       device=dev),
                            dev, after=keep, temperatures=(0.0,))
            release(torch)
            if round_ == 0:
                host = w1["after"]
                loss, pg, kl, grads, lp = grpo_grads(
                    torch, CONFIG, init_params(CONFIG, seed=0, device=dev),
                    host["batch"], dev)
                host.update(fixed=(loss, pg, kl), lp=lp,
                            grads=_to(grads, "cpu"))
                del grads
                release(torch)
            out["world1"].append({k: v for k, v in w1.items()
                                  if k not in ("batch", "after")})
            say(f"GRPO world 1 (rank 0's card), round {round_ + 1}: loss "
                f"{w1['loss']:.6g}"
                + (f", on its rollouts with drawn advantages loss / pg / "
                   f"kl {host['fixed']}" if round_ == 0 else "")
                + f", wall {w1['wall_s']:.3f} s, peak {w1['peak_gib']:.2f} "
                f"GiB")
        if round_ == 0:
            got = [host["batch"] if rank == 0 else None]
            dist.broadcast_object_list(got, src=0)
            fixed = got[0]
        dist.barrier()
        for name, (nd, nm) in meshes.items():
            mesh = make_serve_mesh(n_data=nd, n_model=nm)
            params = ReasoningEstimator(CONFIG, init_params(
                CONFIG, seed=0, device=dev)).shard(mesh).params
            release(torch)
            before = None
            if round_ == 0:
                loss, pg, kl, grads, lp = grpo_grads(torch, CONFIG, params,
                                                     fixed, dev)
                want = host or {}
                before = {"fixed": (loss, pg, kl), "lp": lp,
                          "grad_errs": leaf_errs(torch, grads,
                                                 want.get("grads"), dev,
                                                 rank, scaled=True)}
                del grads
                release(torch)

            def compare(i, p, step):
                if round_:
                    return None
                return leaf_errs(torch, p, (host or {}).get("params"), dev,
                                 rank)
            st, = mesh_grpo(torch, CONFIG, params, dev, after=compare,
                            temperatures=(0.0,))
            del params
            release(torch)
            toks = st.pop("batch")["tokens"].to(dev)
            every = [torch.empty_like(toks) for _ in range(n)]
            dist.all_gather(every, toks)
            check(all(torch.equal(t, toks) for t in every),
                  f"GRPO {name} ({nd}, {nm}): the ranks scored different "
                  "rollouts")
            peaks = [torch.zeros((), device=dev) for _ in range(n)]
            dist.all_gather(peaks, torch.zeros((), device=dev)
                            + st["peak_gib"])
            st["peak_gib_by_rank"] = [float(x) for x in peaks]
            param_errs = st.pop("after")
            # groups (one prompt's rollouts, rows in order) whose greedy
            # rollouts are not all equal
            groups = toks.cpu().reshape(-1, 4, toks.shape[1])
            st["groups_unequal"] = int(
                (groups != groups[:, :1]).flatten(1).any(1).sum())
            if rank == 0 and round_ == 0:
                w1 = out["world1"][0]
                st["rows_unlike_world1"] = int(
                    (toks.cpu() != host["tokens"]).any(dim=1).sum())
                st["loss_err"] = abs(st["loss"] - w1["loss"])
                st["param_err"] = max(param_errs.values())
                st["param_err_at"] = max(param_errs, key=param_errs.get)
                st["fixed"] = before["fixed"]
                st["fixed_err"] = max(abs(a - b) for a, b in zip(
                    before["fixed"], host["fixed"], strict=True))
                # |difference| of each generated token's log-prob from
                # world 1's: its largest, median, 99th percentile, how
                # many exceed 1, and where the largest is
                diff = (before["lp"] - host["lp"]).abs()
                vals = diff[fixed["gen_mask"][:, 1:] > 0]
                st["lp_err"] = float(vals.max())
                st["lp_err_median_p99"] = [float(vals.median()),
                                           float(vals.quantile(0.99))]
                st["lp_err_over_1"] = [int((vals > 1).sum()),
                                       int(vals.numel())]
                st["lp_err_at"] = list(divmod(int(diff.argmax()),
                                              diff.shape[1]))
                errs = before["grad_errs"]
                st["grad_err"] = max(errs.values())
                st["grad_err_at"] = max(errs, key=errs.get)
                check(max(st["loss_err"], st["fixed_err"], st["param_err"])
                      <= BF16_TOL and st["lp_err"] <= GRPO_LP_TOL[0]
                      and st["lp_err_median_p99"][0] <= GRPO_LP_TOL[1]
                      and st["grad_err"] <= GRPO_GRAD_TOL,
                      f"GRPO {name} ({nd}, {nm}) against world 1: {st}")
            out[name].append(st)
            say(f"GRPO {name} ({nd}, {nm}), round {round_ + 1}: loss "
                f"{st['loss']:.6g}"
                + (f" ({st['loss_err']:.2e} from world 1; every param leaf "
                   f"within {st['param_err']:.2e}, largest at "
                   f"{st['param_err_at']}; {st['rows_unlike_world1']} of "
                   f"{toks.shape[0]} rollouts unlike world 1's; before the "
                   f"step, on world 1's rollouts with drawn advantages loss "
                   f"/ pg / kl {st['fixed']} within {st['fixed_err']:.2e}, "
                   f"their log-probs within {st['lp_err']:.3g} of world "
                   f"1's (median, 99th percentile "
                   f"{st['lp_err_median_p99']}; over 1: "
                   f"{st['lp_err_over_1']}; the largest at (row, position) "
                   f"{st['lp_err_at']}), every gradient leaf within "
                   f"{st['grad_err']:.3g} of its largest, worst at "
                   f"{st['grad_err_at']})" if "loss_err" in st else "")
                + f", {st['groups_unequal']} of {groups.shape[0]} groups' "
                f"rollouts unequal, rollouts equal on every rank, wall "
                f"{st['wall_s']:.3f} s, peak by rank {st['peak_gib_by_rank']}"
                f" GiB")
    del host, fixed
    return out


def moe_over_cards(torch, mesh, dev, ds, n, say):
    """qwen3-moe-235b-a22b under FSDP (n, 1) (``fsdp_sft``) at
    ``MOE_OVER_CARDS`` layers: three steps, the per-card peaks and walls."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(MOE_Q[1:]),
                              num_layers=MOE_OVER_CARDS)
    res = fsdp_sft(torch, cfg, mesh, dev, ds)
    say(fsdp_line(n, f"{cfg.name}@{MOE_OVER_CARDS}", res))
    return res


def moe_grpo_rank(path: str) -> int:
    """One rank of ``mesh_train_world``'s second job, which needs nothing
    from the parent: (a) deepseek-v2-lite-16b at ``MOE_FSDP``'s depth on
    rank 0's card alone, then over FSDP (n, 1), its MoE rows split over
    data, losses and aux within 3e-2 of the one card's, then at full
    depth; (b) qwen3-moe-235b-a22b at more layers than one card trains
    (``moe_over_cards``); (c) scope-qwen3-4b's greedy GRPO step at world 1,
    TP and FSDP (``grpo_rounds``).  Rank 0 writes what it found."""
    import dataclasses
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models.model import init_params
    dev = init_distributed()
    n, rank = dist.get_world_size(), dist.get_rank()
    out = {"world": n, "smi": nvidia_smi()}
    t0 = time.perf_counter()

    def say(msg):
        if rank == 0:
            print(f"   [world {n}, {time.perf_counter() - t0:.0f} s] {msg}",
                  flush=True)

    try:
        ds = sft_dataset()
        name, layers = MOE_FSDP
        full = get_config(name)
        cut = dataclasses.replace(full, num_layers=layers)
        if rank == 0:
            one = mesh_sft(torch, cut, init_params(cut, seed=0, device=dev),
                           ds)
            one.pop("params"), one.pop("state")
            release(torch)
            out["moe_world1"] = one
            say(f"{name}@{layers} on rank 0's card: losses {one['losses']},"
                f" aux {one['aux']}, step walls {one['walls_s']} s, peak "
                f"{one['peak_gib']:.2f} GiB")
        dist.barrier()
        mesh = make_host_mesh()
        out["fsdp"] = {}
        for cfg in (cut, full):
            res = fsdp_sft(torch, cfg, mesh, dev, ds)
            key = f"{name}@{cfg.num_layers}"
            if rank == 0 and cfg is cut:
                held_to_world1(key, res, out["moe_world1"])
            out["fsdp"][key] = res
            say(fsdp_line(n, key, res))
        out["moe_over_cards"] = moe_over_cards(torch, mesh, dev, ds, n, say)
        out["grpo"] = grpo_rounds(torch, dev, n, rank, say)
        if rank == 0:
            Path(path).write_text(json.dumps(out, default=str))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_train_rank(refs_path: str, path: str) -> int:
    """One rank of ``mesh_train_world``'s first job: (a) TP over (1, n):
    scope-qwen3-4b served (batch, dense and paged refill streams) and three
    SFT steps, the attention kernels' head counts, the rank's param bytes;
    (b) FSDP over (n, 1): gemma2-9b and zamba2-7b at their one-card depths
    and at full depth, three SFT steps each, per-card peaks, step walls and
    the bytes of params and AdamW state (``fsdp_sft``).  Rank 0 writes what
    it found."""
    import dataclasses
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.scope_estimator import CONFIG
    from repro_torch.core.estimator import ReasoningEstimator
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                         make_serve_mesh)
    from repro_torch.models.model import init_params
    dev = init_distributed()
    refs = json.loads(Path(refs_path).read_text())
    n, rank = dist.get_world_size(), dist.get_rank()
    out = {"world": n, "smi": nvidia_smi()}
    t0 = time.perf_counter()

    def say(msg):
        if rank == 0:
            print(f"   [world {n}, {time.perf_counter() - t0:.0f} s] {msg}",
                  flush=True)

    try:
        world, data, anchors, lib = build_world()
        qids = [int(q) for q in data.test_qids[:N_QUERIES]]
        ds = sft_dataset()
        heads = (QWEN_HEADS[0] // n, QWEN_HEADS[1] // n)

        # (a) TP over (1, n)
        mesh = make_serve_mesh(n_data=1, n_model=n)
        split = coll.model_split(CONFIG, mesh)
        # attention, MLP and vocabulary split; no Mamba layer to split
        check(split == (True, True, True, False), f"TP split {split}")
        plain = init_params(CONFIG, seed=0, device=dev)

        def engine(**kw):
            gc.collect()            # the last engine's sharded weights
            eng = make_engine(CONFIG, plain, anchors, lib, world, data, dev,
                              **kw)
            eng.estimator.shard(mesh)
            return eng

        with HeadProbe() as probe:
            eng = engine()
            pbytes = rank_bytes(eng.estimator.params)
            check(pbytes == spec_bytes(mesh, CONFIG),
                  f"TP param bytes {pbytes} vs local_bytes")
            dec, fields, counts, wall, peak = mesh_serve(torch, eng, data,
                                                         qids)
            ticks = stream_ticks(data, MESH_STREAM_QUERIES)
            streams = {}
            for mode, kw in (("dense", {}), ("paged", dict(
                    kv_paged=True, kv_page_size=PAGE))):
                eng = engine(refill=True, segment_len=SEGMENT, **kw)
                streams[mode] = stream_decisions(torch, eng, data, ticks)
            del eng
        check(close_decisions(dec, refs["serve"]["decisions"], BF16_TOL)
              and close_fields(fields, refs["serve"]["fields"], BF16_TOL),
              f"TP world {n}: the batch serve differs from world 1")
        for mode, (got, _) in streams.items():
            check(len(got) == len(refs["streams"][mode]) and all(
                close_decisions(g, w, BF16_TOL) for g, w in zip(
                    got, refs["streams"][mode], strict=True)),
                f"TP world {n}: the {mode} refill stream differs")
        seen = probe.seen()
        want = f"{heads[0]}/{heads[1]}"
        check(all(list(c) == [want] for c in seen.values())
              and len(seen) == 3, f"TP heads {seen}, want {want}")
        say(f"TP (1, {n}): batch serve and dense / paged refill streams "
            f"equal to world 1 (p_hat within {BF16_TOL}); kernels at "
            f"{want} heads: {seen}; param bytes {pbytes}; serve wall "
            f"{wall:.4f} s, peak {peak:.2f} GiB")
        release(torch)
        params = ReasoningEstimator(CONFIG, plain).shard(mesh).params
        del plain
        with HeadProbe() as probe:
            sft = mesh_sft(torch, CONFIG, params, ds)
        del params, sft["params"], sft["state"]
        release(torch)
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            sft["losses"], refs["sft"], strict=True))
        check(rel <= BF16_TOL, f"TP SFT losses {sft['losses']} vs world 1 "
              f"{refs['sft']}")
        out["tp"] = {"mesh": [1, n], "heads": seen, "sft_heads": probe.seen(),
                     "param_bytes": pbytes, "serve_launches": counts,
                     "serve_wall_s": wall, "serve_peak_gib": peak,
                     "stream_launches": {m: s[1] for m, s in
                                         streams.items()},
                     "sft": sft, "sft_rel_err": rel}
        say(f"TP SFT: losses {sft['losses']} (world 1 {refs['sft']}, "
            f"{rel:.2e} rel), step walls {sft['walls_s']}, peak "
            f"{sft['peak_gib']:.2f} GiB, launches {sft['launches']}")
        if rank == 0:
            out["tp"]["kernels"] = tp_kernel_rows(
                torch, n, int(refs["prompt_len"]), ds["tokens"].shape[1])
        dist.barrier()

        # (b) FSDP over (n, 1)
        mesh = make_host_mesh()
        out["fsdp"] = {}
        for name, layers, least in FSDP_TRAIN:
            for depth in (layers, None):
                full = get_config(name)
                cfg = full if depth is None else dataclasses.replace(
                    full, num_layers=depth)
                res = fsdp_sft(torch, cfg, mesh, dev, ds)
                key = f"{name}@{cfg.num_layers}"
                if depth is not None:
                    held_to_world1(key, res, refs["fsdp"][name])
                out["fsdp"][key] = res
                say(fsdp_line(n, key, res))
        if rank == 0:
            Path(path).write_text(json.dumps(out, default=str))
    finally:
        dist.destroy_process_group()
    return 0


def _to(tree, dev):
    """A copy of ``tree`` on ``dev`` (training writes params in place)."""
    from repro_torch.io import tree_map
    return tree_map(lambda t: t.to(dev, copy=True), tree)


def _leaves(tree):
    from repro_torch.io import flatten
    return flatten(tree).values()


def main(mesh_only: str = "") -> int:
    """Every phase, or with ``mesh_only`` (``--mesh-phase``: "all") the
    device, build, world and mesh phases alone, ending with the mesh report
    ("ssm", ``--mesh-phase ssm``: of the mesh phases phase 24's SSM
    backbones alone; "mla", ``--mesh-phase mla``: its MLA job alone;
    "cross", ``--mesh-phase cross``: its whisper job alone)."""
    # torch.compile (the softcapped rows' yardstick) keeps its caches in
    # the checkout's build directory and compiles in this process
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton/cache"),
                     ("TRITON_HOME", "triton")):
        os.environ.setdefault(var, str(OUT_DIR / sub))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    report = {}
    t = phase("device")
    smi = nvidia_smi()
    resolve_device()                          # cuda:0, TF32 off
    print(f"   {smi}")
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    report["device"] = {"nvidia_smi": smi, "torch": torch.__version__,
                        "cuda": torch.version.cuda}
    done(t)

    t = phase("build")
    paths = build.build()
    report["build_s"] = time.perf_counter() - t
    for name, p in paths.items():
        regs = [line.split("Used ")[1].split(",")[0]
                for line in p.with_suffix(".log").read_text().splitlines()
                if "Used " in line]
        spills = [line.strip() for line in
                  p.with_suffix(".log").read_text().splitlines()
                  if "spill" in line and " 0 bytes spill" not in line]
        print(f"   {name}: {len(regs)} instantiations, registers "
              f"{sorted(set(regs))}, spills {spills or 'none'}")
        check(not spills, f"{name}: ptxas reports spills {spills}")
    done(t)

    t = phase("world")
    world, data, anchors, lib = build_world()
    qids = [int(q) for q in data.test_qids[:N_QUERIES]]
    from repro_torch.core.retrieval import AnchorRetriever
    import numpy as np
    from repro_torch.configs.scope_estimator import TINY
    L = prompt_len(world, data, anchors, lib, qids)
    print(f"   {len(qids)} queries x {len(data.models)} models, "
          f"{N_ANCHORS} anchors, prompt length {L}")
    # the SFT examples of the training phases, from a world of their own
    # (building them draws from the world's generator)
    sft_ds = sft_dataset()
    s_train = sft_ds["tokens"].shape[1]
    print(f"   SFT examples {sft_ds['tokens'].shape}")
    done(t)

    if mesh_only == "ssm":
        t = phase("mesh training: the SSM backbones")
        report = {"mesh_ssm": mesh_ssm_phase(torch, world, data, anchors, lib,
                                             qids, L, sft_ds, smi)}
        report["mesh_ssm"]["seconds"] = time.perf_counter() - t
    elif mesh_only == "mla":
        t = phase("mesh training: MLA over TP")
        report = {"mesh_mla": mesh_mla_phase(smi)}
        report["mesh_mla"]["seconds"] = time.perf_counter() - t
    elif mesh_only == "cross":
        t = phase("mesh training: whisper's attention and cross-attention "
                  "over TP")
        report = {"mesh_cross": mesh_cross_phase(smi)}
        report["mesh_cross"]["seconds"] = time.perf_counter() - t
    elif mesh_only:
        t = phase("mesh")
        report = {"mesh": mesh_phase(torch, world, data, anchors, lib, qids,
                                     smi)}
        done(t)
        t = phase("mesh training")
        report["mesh_train"] = mesh_train_phase(torch, world, data, anchors,
                                                lib, qids, L, sft_ds, smi)
        report["mesh_train"]["seconds"] = time.perf_counter() - t
    if mesh_only:
        done(t)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                            default=str))
        print(json.dumps(report, default=str))
        return 0

    t = phase("kernels")
    errs = kernel_checks(torch, L, s_train)
    done(t)

    t = phase("timing")
    embs = np.stack([data.queries[q].embedding for q in qids]).astype(
        np.float32)
    timing = kernel_timings(torch, L, AnchorRetriever(anchors), embs,
                            s_train)
    done(t)

    t = phase("tiny: card vs cpu")
    report["tiny"] = tiny_card_vs_cpu(torch, TINY, world, data, anchors, lib,
                                      qids)
    done(t)

    t = phase("full width: scope-qwen3-4b")
    from repro_torch.configs.scope_estimator import CONFIG
    params, n_params = full_params(torch, CONFIG, 3.9e9)
    report["full"] = full_width(torch, CONFIG, world, data, anchors, lib,
                                qids, params, n_params)
    done(t)

    t = phase("lint: runtime pass on the card, scope-qwen3-4b")
    report["lint"] = lint_phase(torch, CONFIG, params,
                                len(qids) * len(data.models), L, smi)
    done(t)

    t = phase("tiny stream: card vs cpu, whole-retire, dense and paged "
              "refill")
    report["tiny_stream"] = tiny_stream_card_vs_cpu(torch, world, data,
                                                    anchors, lib)
    done(t)

    t = phase("full-width stream: scope-qwen3-4b, paged and dense refill")
    report["stream"] = full_stream(torch, world, data, anchors, lib, params)
    del params
    release(torch)
    done(t)

    t = phase("tiny ssm: card vs cpu")
    report["tiny_ssm"] = tiny_card_vs_cpu(torch, tiny_ssm_config(), world,
                                          data, anchors, lib, qids)
    done(t)

    t = phase("full width: mamba2-1.3b")
    from repro_torch.configs import get_config
    ssm_cfg = get_config("mamba2-1.3b")
    params, n_params = full_params(torch, ssm_cfg, 1.3e9)
    report["ssm"] = full_width(torch, ssm_cfg, world, data, anchors, lib,
                               qids, params, n_params)
    del params
    release(torch)
    done(t)

    t = phase("tiny hybrid: card vs cpu")
    report["tiny_hybrid"] = tiny_card_vs_cpu(torch, tiny_hybrid_config(),
                                             world, data, anchors, lib, qids)
    done(t)

    t = phase("full width: zamba2-7b")
    hybrid_cfg = get_config("zamba2-7b")
    params, n_params = full_params(torch, hybrid_cfg, 6.5e9)
    report["hybrid"] = full_width(torch, hybrid_cfg, world, data, anchors,
                                  lib, qids, params, n_params)
    del params
    release(torch)
    done(t)

    t = phase("tiny dense families: card vs cpu")
    report["tiny_dense"] = {cfg.name: tiny_card_vs_cpu(
        torch, cfg, world, data, anchors, lib, qids)
        for cfg in tiny_dense_configs()}
    report["tiny_dense"]["ring"] = ring_card_vs_cpu(torch,
                                                    tiny_dense_configs()[1])
    done(t)

    report["dense"] = {}
    for name, least in DENSE_FULL.items():
        t = phase(f"full width: {name}")
        cfg = get_config(name)
        params, n_params = full_params(torch, cfg, least)
        report["dense"][name] = full_width(torch, cfg, world, data, anchors,
                                           lib, qids, params, n_params)
        del params
        release(torch)
        done(t)

    t = phase("tiny multimodal: card vs cpu, qwen2-vl at group 7 and "
              "whisper")
    vlm_small, audio_small = tiny_multimodal_configs()
    report["tiny_multimodal"] = {
        "serve": tiny_card_vs_cpu(torch, vlm_small, world, data, anchors,
                                  lib, qids),
        vlm_small.name: stub_card_vs_cpu(torch, vlm_small),
        audio_small.name: stub_card_vs_cpu(torch, audio_small)}
    done(t)

    t = phase("full width: qwen2-vl-7b")
    vlm_cfg = get_config("qwen2-vl-7b")
    params, n_params = full_params(torch, vlm_cfg, 7.0e9)
    report["vlm"] = full_width(torch, vlm_cfg, world, data, anchors, lib,
                               qids, params, n_params)
    report["vlm"]["image"] = full_stub_serve(torch, vlm_cfg, params, stub_batch(
        torch, vlm_cfg, VLM_ROWS, VLM_PATCHES + VLM_TEXT, seed=7,
        device="cuda"))
    report["vlm"]["paged"] = paged_vs_dense(torch, vlm_cfg, params,
                                            serve_prompts(vlm_cfg, params,
                                                          world, data,
                                                          anchors, lib, qids))
    del params
    release(torch)
    done(t)

    t = phase("full width: whisper-medium")
    audio_cfg = get_config("whisper-medium")
    params, n_params = full_params(torch, audio_cfg, 0.7e9)
    report["audio"] = dict(full_stub_serve(torch, audio_cfg, params, stub_batch(
        torch, audio_cfg, 56, L, seed=AUDIO_SEED, device="cuda")),
        params=n_params)
    del params
    release(torch)
    done(t)

    t = phase("tiny moe: card vs cpu, qwen3-moe and deepseek-v2 (reduced), "
              "batch and stream, router margins")
    report["tiny_moe"] = {cfg.name: tiny_moe_card_vs_cpu(
        torch, cfg, world, data, anchors, lib, qids)
        for cfg in tiny_moe_configs()}
    done(t)

    t = phase("full width: deepseek-v2-lite-16b")
    mla_cfg = get_config(MLA[1:])
    params, n_params = full_params(torch, mla_cfg, 15.4e9)
    report["mla"] = full_width(torch, mla_cfg, world, data, anchors, lib,
                               qids, params, n_params)
    report["mla"]["moe"] = moe_prefill(torch, mla_cfg, params, serve_prompts(
        mla_cfg, params, world, data, anchors, lib, qids))
    del params
    release(torch)
    done(t)

    t = phase(f"full width: qwen3-moe-235b-a22b, {MOE_LAYERS} of 94 layers")
    import dataclasses
    moe_cfg = dataclasses.replace(get_config(MOE_Q[1:]),
                                  num_layers=MOE_LAYERS)
    print(f"   cut: qwen3-moe-235b-a22b at full width (d {moe_cfg.d_model}, "
          f"{moe_cfg.num_heads} heads on {moe_cfg.num_kv_heads} of "
          f"{moe_cfg.resolved_head_dim}, {moe_cfg.num_experts} experts of "
          f"{moe_cfg.d_model} x {moe_cfg.resolved_moe_d_ff}, top "
          f"{moe_cfg.num_experts_per_tok}) and {MOE_LAYERS} of its 94 "
          "layers: all 94 come to ~470 GB of bf16 weights")
    params, n_params = full_params(torch, moe_cfg, 20.4e9)
    report["moe"] = full_width(torch, moe_cfg, world, data, anchors, lib,
                               qids, params, n_params)
    prompts = serve_prompts(moe_cfg, params, world, data, anchors, lib, qids)
    report["moe"]["moe"] = moe_prefill(torch, moe_cfg, params, prompts)
    report["moe"]["paged"] = paged_vs_dense(torch, moe_cfg, params, prompts)
    del params
    release(torch)
    done(t)

    t = phase("tiny tiers: card vs cpu, tier-0 gate, fallback, hot_swap")
    report["tiny_tiers"] = tiny_tiers_card_vs_cpu(torch, world, data,
                                                  anchors, lib)
    done(t)

    t = phase("full-width tiers: scope-qwen3-4b, gated paged stream, drift, "
              "hot_swap")
    report["tiers"] = full_tiers(torch, world, data, anchors, lib, smi)
    release(torch)
    done(t)

    t = phase("tiny train: card vs cpu, loss, gradients, SFT and a greedy "
              "GRPO step")
    report["tiny_train"] = tiny_grads_card_vs_cpu(torch, TINY, sft_ds,
                                                  grpo=True)
    release(torch)
    done(t)

    t = phase("full-width train: scope-qwen3-4b, SFT and GRPO steps")
    report["train"] = full_train(torch, sft_ds)
    done(t)

    t = phase("tiny ssm train: card vs cpu, loss, gradients, ten SFT steps")
    report["tiny_ssm_train"] = tiny_grads_card_vs_cpu(
        torch, tiny_ssm_config(), sft_ds)
    release(torch)
    done(t)

    t = phase("tiny hybrid train: card vs cpu, loss, gradients, ten SFT "
              "steps")
    report["tiny_hybrid_train"] = tiny_grads_card_vs_cpu(
        torch, tiny_hybrid_config(), sft_ds)
    release(torch)
    done(t)

    t = phase("full-width train: mamba2-1.3b, SFT steps")
    report["ssm_train"] = full_ssm_train(torch, ssm_cfg, sft_ds, 1.3e9)
    done(t)

    t = phase("full-width train: zamba2-7b, 12 mamba layers, SFT steps")
    cut_cfg = dataclasses.replace(hybrid_cfg, num_layers=12)
    n_attn, n_mamba = layer_counts(cut_cfg)
    print(f"   cut: zamba2-7b at full width (d {cut_cfg.d_model}, "
          f"{cut_cfg.resolved_ssm_heads} SSM heads of {cut_cfg.ssm_head_dim}, "
          f"state {cut_cfg.ssm_state}, the tied block's {cut_cfg.num_heads} "
          f"heads of {cut_cfg.resolved_head_dim}) and {n_mamba} of its "
          f"{hybrid_cfg.num_layers} mamba layers ({n_attn} of 13 shared-block "
          "occurrences): at full depth its weights, gradients and AdamW "
          "moments alone need ~80 GB")
    report["hybrid_train"] = full_ssm_train(torch, cut_cfg, sft_ds, 1.2e9)
    done(t)

    t = phase("tiny families train: card vs cpu, loss, gradients, ten SFT "
              "steps, a greedy GRPO step (text-only)")
    report["tiny_family_train"] = {
        cfg.name: tiny_grads_card_vs_cpu(torch, cfg, sft_ds,
                                         grpo=not (cfg.is_encoder_decoder
                                                   or cfg.num_stub_patches))
        for cfg in (*tiny_dense_configs(), *tiny_multimodal_configs(),
                    *tiny_moe_configs())}
    release(torch)
    done(t)

    report["family_train"] = {}
    for name, (least, layers, batch) in FAMILY_TRAIN.items():
        t = phase(f"full-width train: {name}"
                  + (f", {layers} layers" if layers else "") + ", SFT steps")
        report["family_train"][name] = full_family_train(
            torch, name, least, layers, batch, sft_ds)
        done(t)

    t = phase("CLIs: repro_torch.launch.train, then .serve --checkpoint")
    report["clis"] = clis()
    done(t)

    t = phase("planning: 40 (arch, input shape) plans, the 34 steps on the "
              "card at their lengths, the kernels at 4096 and 32768")
    report["planning"] = planning_runs(torch)
    plan_errs = long_checks(torch)
    timing.update(long_timings(torch))
    errs.update(plan_errs)
    launches_plan = plan_launches(report["planning"]["runs"])
    report["planning"]["seconds"] = time.perf_counter() - t
    print(f"   planning phase: {report['planning']['seconds']:.1f} s")
    done(t)

    t = phase("mesh: scope-qwen3-4b over a serve mesh, world 1 over NCCL, "
              "batch and refill streams bit for bit, launch.serve --mesh")
    release(torch)
    report["mesh"] = mesh_phase(torch, world, data, anchors, lib, qids, smi)
    report["mesh"]["seconds"] = time.perf_counter() - t
    done(t)

    t = phase("mesh training: scope-qwen3-4b SFT steps, GRPO steps and a "
              "batch serve sharded over a world-1 NCCL mesh, bit for bit; "
              "TP, FSDP, MoE rows and GRPO on more cards")
    release(torch)
    report["mesh_train"] = mesh_train_phase(torch, world, data, anchors, lib,
                                            qids, L, sft_ds, smi)
    report["mesh_train"]["seconds"] = time.perf_counter() - t
    done(t)

    # launches: each kernel's count on its own path's run — the batch serve
    # for the three kernels of that path, the paged stream for the paged
    # one, the mamba2-1.3b serve for the SSD scan and decode step, the
    # full-width SFT steps for the flash backward
    launches = dict(report["full"]["launches"],
                    paged_decode_attention=report["stream"]["paged"][
                        "launches"]["paged_decode_attention"],
                    ssd_scan=report["ssm"]["launches"]["ssd_scan"],
                    ssd_decode_step=report["ssm"]["launches"][
                        "ssd_decode_step"],
                    flash_attention_bwd=report["train"]["sft_launches"][
                        "flash_attention_bwd"],
                    ssd_scan_bwd=report["ssm_train"]["sft_launches"][
                        "ssd_scan_bwd"])
    # and the zamba2-7b serve's own path: its attention kernels at head dim
    # 112 and its SSD kernels at its shapes, each a row of its own
    for name in HYBRID_KERNELS:
        launches[f"{name}{HYBRID}"] = report["hybrid"]["launches"][name]
    # and its SFT steps' backward kernels
    for name in HYBRID_TRAIN_KERNELS:
        launches[f"{name}{HYBRID}"] = report["hybrid_train"][
            "sft_launches"][name]
    # and the dense families' serves, each its own path
    for name, config in DENSE_ROWS:
        launches[name + config] = report["dense"][config[1:]]["launches"][
            name]
    # and the multimodal runs: qwen2-vl-7b's serve, image prefill and paged
    # decode, each its own run; whisper-medium's stub serve, whose flash
    # launches full_stub_serve counted by call (the prefill's and the
    # decode's, each from 0, told apart by their shapes)
    vlm, audio = report["vlm"], report["audio"]
    launches.update({
        "flash_attention" + VLM: vlm["launches"]["flash_attention"],
        "flash_attention" + VLM + "/image": vlm["image"]["flash_calls"][
            "self"],
        "decode_attention" + VLM: vlm["launches"]["decode_attention"],
        "paged_decode_attention" + VLM: vlm["paged"]["launches"][
            "paged_decode_attention"],
        "flash_attention" + AUDIO: audio["flash_calls"]["self"],
        "flash_attention" + AUDIO + "/encoder": audio["flash_calls"][
            "encoder"],
        "flash_attention" + AUDIO + "/cross": audio["flash_calls"]["cross"],
        "flash_attention" + AUDIO + "/cross-sq1": audio["flash_calls"][
            "cross_sq1"],
        "decode_attention" + AUDIO: audio["launches"]["decode_attention"]})
    # and the MoE serves: deepseek-v2-lite-16b's flash (its decode runs no
    # kernel), qwen3-moe-235b-a22b's flash and dense decode in its serve and
    # its paged decode over the serve's prompts, each its own run
    mla, moe = report["mla"], report["moe"]
    launches.update({
        "flash_attention" + MLA: mla["launches"]["flash_attention"],
        "flash_attention" + MOE_Q: moe["launches"]["flash_attention"],
        "decode_attention" + MOE_Q: moe["launches"]["decode_attention"],
        "paged_decode_attention" + MOE_Q: moe["paged"]["launches"][
            "paged_decode_attention"]})
    # and the training families' SFT steps: each backward row's launches
    # from its config's run (whisper's encoder calls told apart by shape)
    fam = report["family_train"]
    launches.update({
        "flash_attention_bwd" + MLA: fam[MLA[1:]]["sft_launches"][
            "flash_attention_bwd"],
        "flash_attention_bwd@gemma2-9b": fam["gemma2-9b"]["sft_launches"][
            "flash_attention_bwd"],
        "flash_attention_bwd" + MOE_Q: fam[MOE_Q[1:]]["sft_launches"][
            "flash_attention_bwd"],
        "flash_attention_bwd" + AUDIO + "/encoder": fam[AUDIO[1:]][
            "sft_bwd_shapes"][str((ENC_FRAMES, ENC_FRAMES, False))]})
    launches.update(launches_plan)
    kernel_rows = []
    for row in [*TPU_KERNELS, *(f"{n}{HYBRID}" for n in
                                (*HYBRID_KERNELS, *HYBRID_TRAIN_KERNELS)),
                *(name + config for name, config in DENSE_ROWS),
                *(name + config for name, config in MULTIMODAL_ROWS),
                *(name + config for name, config in MOE_ROWS),
                *(name + config for name, config in TRAIN_ROWS),
                *PLAN_ROWS_KERNELS]:
        name = row.split("@")[0]
        tm = timing[row]
        kernel_rows.append({
            "name": row, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": launches[row],
            "max_abs_err": errs[row], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"]})
    # and, where more cards ran the mesh training phase, the attention
    # kernels at the heads one rank of its (1, n) mesh computes
    tp = report["mesh_train"].get("world", {}).get("tp")
    if tp:
        n = tp["mesh"][1]
        tp_launches = {
            "flash_attention": tp["serve_launches"]["flash_attention"],
            "decode_attention": tp["serve_launches"]["decode_attention"],
            "paged_decode_attention": tp["stream_launches"]["paged"][
                "paged_decode_attention"],
            "flash_attention_bwd": tp["sft"]["launches"][
                "flash_attention_bwd"]}
        for name, count in tp_launches.items():
            tm = tp["kernels"][f"{name}@tp{n}"]
            kernel_rows.append({
                "name": f"{name}@tp{n}", "route": "cuda",
                "source": SOURCES[name], "replaces": TPU_KERNELS[name],
                "launches": count, "max_abs_err": tm["max_abs_err"],
                "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                "library_ms": tm["library_ms"]})
    # and the SSD kernels at the heads one rank of the (1, n) mesh computes,
    # each with the launches of rank 0's TP run of its config
    ssm = report["mesh_train"].get("world", {}).get("ssm")
    if ssm:
        n = ssm["mesh"][1]
        for config in ("mamba2-1.3b", "zamba2-7b"):
            run = ssm[config]
            for name, count in (
                    ("ssd_scan", run["serve_launches"]["ssd_scan"]),
                    ("ssd_decode_step", run["serve_launches"][
                        "ssd_decode_step"]),
                    ("ssd_scan_bwd", run["sft"]["launches"][
                        "ssd_scan_bwd"])):
                row = f"{name}@tp{n}/{config}"
                tm = ssm["kernels"][row]
                kernel_rows.append({
                    "name": row, "route": "cuda", "source": SOURCES[name],
                    "replaces": TPU_KERNELS[name], "launches": count,
                    "max_abs_err": tm["max_abs_err"], "ms": tm["ms"],
                    "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                    "bound_by": tm["bound_by"],
                    "library_ms": tm["library_ms"]})
    # and the flash kernels at the MLA heads one rank of the (1, n) mesh
    # computes, with the launches of rank 0's TP serve and SFT
    mla = report["mesh_train"].get("world", {}).get("mla")
    if mla:
        n = mla["mesh"][1]
        for name, count in (
                ("flash_attention", mla["serve"]["launches"][
                    "flash_attention"]),
                ("flash_attention_bwd", mla["sft"]["launches"][
                    "flash_attention_bwd"])):
            row = f"{name}@tp{n}/deepseek-v2-lite-16b"
            tm = mla["kernels"][row]
            kernel_rows.append({
                "name": row, "route": "cuda", "source": SOURCES[name],
                "replaces": TPU_KERNELS[name], "launches": count,
                "max_abs_err": tm["max_abs_err"], "ms": tm["ms"],
                "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                "bound_by": tm["bound_by"], "library_ms": tm["library_ms"]})
    # and the attention kernels at the whisper heads one rank of the (1, n)
    # mesh computes, with the launches of rank 0's TP serve and SFT
    cross = report["mesh_train"].get("world", {}).get("cross")
    if cross:
        for row, count in cross["row_launches"].items():
            name = row.split("@")[0]
            tm = cross["kernels"][row]
            kernel_rows.append({
                "name": row, "route": "cuda", "source": SOURCES[name],
                "replaces": TPU_KERNELS[name], "launches": count,
                "max_abs_err": tm["max_abs_err"], "ms": tm["ms"],
                "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                "bound_by": tm["bound_by"], "library_ms": tm["library_ms"]})
    report["kernels"] = kernel_rows
    report["timing"] = timing
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    print(json.dumps({"kernels": kernel_rows, "to_port": TO_PORT}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-train-rank"]:
        sys.exit(mesh_train_rank(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--mesh-moe-grpo-rank"]:
        sys.exit(moe_grpo_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-ssm-rank"]:
        sys.exit(mesh_ssm_rank(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--mesh-mla-rank"]:
        sys.exit(mesh_mla_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-cross-rank"]:
        sys.exit(mesh_cross_rank(sys.argv[2]))
    sys.exit(main(mesh_only={("--mesh-phase",): "all",
                             ("--mesh-phase", "ssm"): "ssm",
                             ("--mesh-phase", "mla"): "mla",
                             ("--mesh-phase", "cross"): "cross"}.get(
                                 tuple(sys.argv[1:]), "")))
