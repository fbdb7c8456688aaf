"""The planning path's FLOP count (``launch/step_cost``) against the
reference's: ``repro.launch.hlo_analysis.analyze`` of the compiled HLO of
the same step (``jax.jit(step).lower(...).compile().as_text()``, on the
CPU), at reduced configs and small shapes, in every mode.

Tolerance: exact (relative 1e-12, float rounding of the sums) where the
products are the same, which is every train, prefill and decode step of
two or more rows, over one or two microbatches, on the unblocked, blocked
and banded attention paths.  One difference is by design: XLA's CPU
backend fuses a matrix-vector product (a projection of ONE token) into a
loop fusion, where ``analyze`` counts no dot; the port counts every
product.  So a one-row decode step (long_500k) counts at least the
reference's FLOPs; for gemma2's long variant, exactly them plus its
projections and LM head.
"""
import dataclasses

import jax
import pytest

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JShape
from repro.launch import hlo_analysis as H
from repro.launch import specs as JS
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import step_cost as C

EXACT = 1e-12


def _configs(arch, long=False):
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if arch == "mamba2-1.3b":
        jcfg = dataclasses.replace(jcfg, shared_attn_every=0)
        tcfg = dataclasses.replace(tcfg, shared_attn_every=0)
    if long:
        jcfg = dataclasses.replace(jcfg, force_window=jcfg.long_context_window)
        tcfg = dataclasses.replace(tcfg, force_window=tcfg.long_context_window)
    return jcfg, tcfg


def _reference_flops(jcfg, shape, m=1):
    params = JS.abstract_params(jcfg)
    inp = JS.input_specs(jcfg, shape)
    if shape.mode == "train":
        lowered = jax.jit(JS.make_train_step(jcfg, microbatches=m)).lower(
            params, JS.abstract_opt_state(params), inp["batch"])
    elif shape.mode == "prefill":
        lowered = jax.jit(JS.make_prefill_step(jcfg, microbatches=m)).lower(
            params, inp["batch"])
    else:
        lowered = jax.jit(JS.make_serve_step(jcfg)).lower(
            params, inp["token"], inp["caches"])
    return H.analyze(lowered.compile().as_text())["flops"]


def _both(arch, mode, s, b, m=1, long=False):
    jcfg, tcfg = _configs(arch, long)
    return (C.step_flops(tcfg, InputShape("x", s, b, mode), m),
            _reference_flops(jcfg, JShape("x", s, b, mode), m))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_flops_equal_reference_hlo(arch, mode):
    got, want = _both(arch, mode, 64, 2)
    assert got == pytest.approx(want, rel=EXACT)


@pytest.mark.parametrize("arch,mode", [
    ("starcoder2-3b", "train"), ("qwen3-moe-235b-a22b", "train"),
    ("zamba2-7b", "prefill"), ("whisper-medium", "prefill")])
def test_flops_equal_reference_hlo_over_two_microbatches(arch, mode):
    got, want = _both(arch, mode, 64, 4, m=2)
    assert got == pytest.approx(want, rel=EXACT)


@pytest.mark.parametrize("arch,mode", [
    ("starcoder2-3b", "train"), ("gemma2-2b", "train"),
    ("qwen3-moe-235b-a22b", "prefill"), ("deepseek-v2-lite-16b", "prefill"),
    ("mamba2-1.3b", "train")])
def test_flops_equal_reference_hlo_on_the_blocked_and_banded_paths(arch,
                                                                   mode):
    """2048 tokens: past 1024 x 1024 the heads of 4 take the blocked path
    (512 x 1024 blocks, the masked ones computed), gemma2's local layers
    the banded one (a 64 + 512-key span a block); the MoE in 8 routing
    groups of 256; 16 SSD chunks."""
    got, want = _both(arch, mode, 2048, 1)
    assert got == pytest.approx(want, rel=EXACT)


@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-7b", "mamba2-1.3b"])
def test_long_variant_decode_of_two_rows_equals_reference(arch):
    """The long variant's ring (64 slots at the reduced window) over a
    longer capacity."""
    got, want = _both(arch, "decode", 256, 2, long=True)
    assert got == pytest.approx(want, rel=EXACT)


def test_one_row_decode_counts_the_products_xla_cpu_fuses():
    """One token a step: the reference's CPU count leaves out gemma2's
    matrix-vector projections and LM head (fused into loops), the port
    counts them; the difference is those products, no more."""
    _, tcfg = _configs("gemma2-2b", long=True)
    got, want = _both("gemma2-2b", "decode", 256, 1, long=True)
    assert got > want
    d, f = tcfg.d_model, tcfg.d_ff
    hq, hkv, hd = tcfg.num_heads, tcfg.num_kv_heads, tcfg.resolved_head_dim
    per_layer = 2 * (d * (2 * hq + 2 * hkv) * hd + 3 * d * f)
    head = 2 * d * tcfg.vocab_size
    assert got - want == pytest.approx(tcfg.num_layers * per_layer + head,
                                       rel=EXACT)
