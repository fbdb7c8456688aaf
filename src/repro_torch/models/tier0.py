"""Tier-0 pre-router: one cross-attention forward instead of a reasoning
decode (two-tier routing on the SCOPE serve path).

The port of ``repro/models/tier0.py``.  The reasoning estimator spends
``max_new_tokens`` decode steps per (query, model) pair.  The tier-0 head
reads *exactly the features the serialized prompt encodes* — the query
embedding + domain, the retrieved anchor slice of the model's fingerprint
(similarities, outcomes, token counts, anchor domains), and the model's
metadata (price bucket, reasoning flag, seen flag, identity embedding) —
and emits the same prediction tuple (p_correct, len_bucket) plus a
calibrated confidence, in one forward over all pairs.
``ScopeEngine._prepare`` answers pairs whose confidence clears
``EngineConfig.escalation_threshold`` directly from this head; only the
low-confidence remainder escalates to the reasoning decode.

The head is a few small products, a ``tanh`` and a softmax over the K
retrieved anchors: plain PyTorch on the params' device (the card unless
the caller asks for the CPU).  Serve-path invariants:

- **fixed bucket shapes**: pair batches are padded up to ``PAIR_BUCKETS``
  sizes, as in the reference, so steady-state traffic reuses a handful of
  shapes;
- **one copy each way**: the features travel to the device in one packed
  float32 buffer and ``(p_logit, len_logits)`` come back in one;
- **no serve-time nondeterminism**: ``init_tier0`` takes its generator as
  a parameter; nothing here reads clocks or seeds generators;
- **temperature on the host**: calibration scales the correctness logit in
  float64 numpy *after* the forward, so refitting the temperature never
  touches the params.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.fingerprint import AnchorSet, Fingerprint
from repro_torch.data import tokenizer as tok
from repro_torch.data.worldsim import EMBED_DIM, NUM_DOMAINS, PoolModel, Query
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import dense_init, embed_init

# feature widths — derived from the same quantities serialize_prompt tokenizes
QUERY_FEATS = EMBED_DIM + NUM_DOMAINS       # raw embedding + domain one-hot
ANCHOR_FEATS = 3 + NUM_DOMAINS              # sim, fp.y, log-len + domain
MODEL_FEATS = 3                             # price bucket, reasoning, seen
N_MODEL_SLOTS = tok.NUM_MODEL_TOKENS + 1    # identity slots + shared UNK

# fixed pair-batch grid: a batch of n pairs is padded to the smallest
# bucket >= n (multiples of the largest bucket beyond it)
PAIR_BUCKETS = (16, 64, 256, 1024)

# the head's parameter names, in the reference's param dict
PARAM_NAMES = ("model_emb", "wq", "wk", "wv", "w1", "b1", "w_p", "b_p",
               "w_len", "b_len")


def pair_bucket(n: int) -> int:
    """Smallest configured pair-bucket >= n (largest-bucket multiples
    beyond the grid)."""
    for b in PAIR_BUCKETS:
        if b >= n:
            return b
    top = PAIR_BUCKETS[-1]
    return -(-n // top) * top


@dataclasses.dataclass(frozen=True)
class Tier0Config:
    d_model: int = 32
    d_hidden: int = 64
    n_len_buckets: int = tok.NUM_LEN_BUCKETS


def param_shapes(cfg: Tier0Config) -> Dict[str, Tuple[int, ...]]:
    """Each parameter's shape, weights stored (in, out)."""
    d, h = cfg.d_model, cfg.d_hidden
    slot = ANCHOR_FEATS + MODEL_FEATS + d
    return {"model_emb": (N_MODEL_SLOTS, d), "wq": (QUERY_FEATS, d),
            "wk": (slot, d), "wv": (slot, d), "w1": (3 * d, h),
            "b1": (h,), "w_p": (h, 1), "b_p": (1,),
            "w_len": (h, cfg.n_len_buckets), "b_len": (cfg.n_len_buckets,)}


def init_tier0(generator: torch.Generator, cfg: Tier0Config = Tier0Config(),
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Head parameters, float32, with the reference initializers'
    distributions.  ``generator`` is supplied by the caller (training code)
    and must live on ``device``; serve code never seeds one."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    params = {"model_emb": embed_init(shapes["model_emb"], generator,
                                      device=dev)}
    for name in ("wq", "wk", "wv", "w1", "w_p", "w_len"):
        params[name] = dense_init(shapes[name], generator, device=dev)
    for name in ("b1", "b_p", "b_len"):
        params[name] = torch.zeros(shapes[name], dtype=torch.float32,
                                   device=dev)
    return {k: params[k] for k in PARAM_NAMES}


def tier0_forward(params, qf: torch.Tensor, af: torch.Tensor,
                  mf: torch.Tensor, mid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention forward over (n,) pairs.

    ``qf`` (n, QUERY_FEATS) query features; ``af`` (n, K, ANCHOR_FEATS)
    retrieved anchor slice; ``mf`` (n, MODEL_FEATS) model metadata; ``mid``
    (n,) model identity slot.  Returns the correctness logit (n,) and the
    length-bucket logits (n, n_len_buckets).
    """
    d = params["wq"].shape[1]
    me = params["model_emb"][mid]                           # (n, d)
    qv = torch.tanh(qf @ params["wq"])                      # (n, d)
    n, K = af.shape[0], af.shape[1]
    slot = torch.cat(
        [af,
         mf[:, None, :].expand(n, K, mf.shape[1]),
         me[:, None, :].expand(n, K, d)], dim=-1)
    k = torch.tanh(slot @ params["wk"])                     # (n, K, d)
    v = slot @ params["wv"]                                 # (n, K, d)
    attn = torch.softmax(
        torch.einsum("nd,nkd->nk", qv, k) / math.sqrt(d), dim=-1)
    pooled = torch.einsum("nk,nkd->nd", attn, v)            # (n, d)
    h = torch.relu(
        torch.cat([qv, pooled, me], dim=-1) @ params["w1"] + params["b1"])
    p_logit = (h @ params["w_p"] + params["b_p"])[:, 0]
    len_logits = h @ params["w_len"] + params["b_len"]
    return p_logit, len_logits


# ---------------------------------------------------------------------------
# Featurization — mirrors serialize_prompt's inputs field for field
# ---------------------------------------------------------------------------
def pair_features(model: PoolModel, model_index: int, anchor_set: AnchorSet,
                  fp: Fingerprint, sims: np.ndarray, idx: np.ndarray,
                  query: Query
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(qf, af, mf, mid) for one (query, model) pair — the same signature
    (and information) as ``serialization.serialize_prompt``, so the gate
    needs no retrieval or serialization pass of its own."""
    qf = np.zeros(QUERY_FEATS, np.float32)
    qf[:EMBED_DIM] = query.embedding
    qf[EMBED_DIM + int(query.domain)] = 1.0
    K = len(sims)
    af = np.zeros((K, ANCHOR_FEATS), np.float32)
    fy = np.asarray(fp.y, np.float64)
    ft = np.asarray(fp.tokens, np.float64)
    for j in range(K):
        i = int(idx[j])
        af[j, 0] = float(sims[j])
        af[j, 1] = float(fy[i])
        af[j, 2] = float(np.log1p(ft[i])) / 10.0
        af[j, 3 + int(anchor_set.queries[i].domain)] = 1.0
    mf = np.asarray(
        [tok.price_bucket(model.price_out) / tok.NUM_PRICE_BUCKETS,
         float(bool(model.reasoning)), float(bool(model.seen))], np.float32)
    mid = (int(model_index) % tok.NUM_MODEL_TOKENS if model.seen
           else tok.NUM_MODEL_TOKENS)
    return qf, af, mf, mid


@dataclasses.dataclass
class Tier0Batch:
    """Columnar tier-0 predictions for n pairs (``ParsedBatch``-shaped
    fields plus the calibrated escalation signal)."""
    p: np.ndarray               # (n,) calibrated P(correct)
    y_hat: np.ndarray           # (n,) int, p >= 0.5
    len_hat: np.ndarray         # (n,) float, LEN_CENTERS[argmax]
    conf: np.ndarray            # (n,) max(p, 1-p) in [0.5, 1]

    def __len__(self) -> int:
        return len(self.p)


class Tier0Head:
    """Trained tier-0 parameters + calibration temperature.

    The head runs where its params live (``init_tier0`` and
    ``io.tier0_params_from_numpy`` put them on the card unless asked for
    the CPU).  ``predict_pairs`` pads the pair batch to the
    ``PAIR_BUCKETS`` grid, runs the forward once, and converts on the
    host: the calibrated probability is ``sigmoid(p_logit / temperature)``
    and the confidence is its distance from chance, ``max(p, 1 - p)``.
    """

    def __init__(self, params: Dict[str, torch.Tensor],
                 cfg: Tier0Config = Tier0Config(), *,
                 temperature: float = 1.0, version: str = "v0"):
        if temperature <= 0.0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.params = params
        self.cfg = cfg
        self.temperature = float(temperature)
        # which estimator this head was distilled from/calibrated against
        # (EngineConfig.estimator_version); ScopeEngine.hot_swap stamps the
        # post-swap head so a stale head can never ride a version bump
        self.version = str(version)

    @property
    def device(self) -> torch.device:
        return self.params["wq"].device

    def forward_raw(self, qf: np.ndarray, af: np.ndarray, mf: np.ndarray,
                    mid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Bucket-padded forward; returns host (p_logit, len_logits)
        trimmed back to the true pair count.  The four feature arrays are
        packed into one float32 (bucket, width) buffer (the identity slot
        is a small integer, exact in float32) and copied to the device
        once; the two outputs come back in one (bucket, 1 + n_len) copy."""
        n = len(qf)
        nlb = self.cfg.n_len_buckets
        if n == 0:
            return (np.zeros(0, np.float32), np.zeros((0, nlb), np.float32))
        b, K = pair_bucket(n), af.shape[1]
        a_end = QUERY_FEATS + K * ANCHOR_FEATS
        packed = np.zeros((b, a_end + MODEL_FEATS + 1), np.float32)
        packed[:n, :QUERY_FEATS] = qf
        packed[:n, QUERY_FEATS:a_end] = np.asarray(af).reshape(n, -1)
        packed[:n, a_end:a_end + MODEL_FEATS] = mf
        packed[:n, -1] = mid
        x = torch.from_numpy(packed).to(self.device)
        with torch.no_grad():
            p_logit, len_logits = tier0_forward(
                self.params, x[:, :QUERY_FEATS],
                x[:, QUERY_FEATS:a_end].reshape(b, K, ANCHOR_FEATS),
                x[:, a_end:a_end + MODEL_FEATS], x[:, -1].long())
            out = torch.cat([p_logit[:, None], len_logits], dim=1)
        # scopelint-torch: allow[host-sync-in-hot-path] -- the gate's one device->host copy: both outputs in one (bucket, 1 + n_len) buffer
        out = out.cpu().numpy()
        return out[:n, 0], out[:n, 1:]

    def predict_pairs(self, qf: np.ndarray, af: np.ndarray, mf: np.ndarray,
                      mid: np.ndarray) -> Tier0Batch:
        p_logit, len_logits = self.forward_raw(qf, af, mf, mid)
        z = np.asarray(p_logit, np.float64) / self.temperature
        p = 1.0 / (1.0 + np.exp(-z))
        lb = np.argmax(len_logits, axis=-1) if len(p) else \
            np.zeros(0, int)
        return Tier0Batch(
            p=p, y_hat=(p >= 0.5).astype(int),
            len_hat=np.asarray(tok.LEN_CENTERS)[lb].astype(np.float64),
            conf=np.maximum(p, 1.0 - p))

    def predict_features(
            self, feats: List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    int]]) -> Tier0Batch:
        """``predict_pairs`` over a list of ``pair_features`` tuples."""
        if not feats:
            return Tier0Batch(np.zeros(0), np.zeros(0, int), np.zeros(0),
                              np.zeros(0))
        qf = np.stack([f[0] for f in feats])
        af = np.stack([f[1] for f in feats])
        mf = np.stack([f[2] for f in feats])
        mid = np.asarray([f[3] for f in feats], np.int32)
        return self.predict_pairs(qf, af, mf, mid)

    def with_temperature(self, temperature: float) -> "Tier0Head":
        return Tier0Head(self.params, self.cfg, temperature=temperature,
                         version=self.version)
