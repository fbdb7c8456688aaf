"""The port's multimodal-stub backbones against the JAX package on the same
inputs: qwen2-vl-7b's language backbone (M-RoPE over (t, h, w) position
streams, stub patch embeddings projected into the first positions) and
whisper-medium's encoder-decoder (stub frame embeddings, a non-causal
encoder, sinusoid positions, cross-attention into ``ck`` / ``cv`` caches, a
tanh-GELU MLP): configs, plans, init, the bridge, the numerics, prefill
and decode logits and the loss.  Generation and the serving stack are in
``test_torch_multimodal_serving.py``, the examples' twins in
``test_torch_examples.py``, the gradients in
``test_torch_family_training.py``; those import the helpers here.

Small configs (``reduced()``, and qwen2-vl at its full-width GQA group 7)
with weights bridged from the reference's seeded ``init_params``.
Tolerances: float32 within 2e-5, bfloat16 within 3e-2, token streams and
decisions equal.

On the card the same paths run the flash kernel (causal at group 7; the
encoder non-causal over its frames; the cross-attention non-causal, sq = 1
in decode), the dense decode and the paged decode kernels, which
``chip_smoke.py`` holds to their plain versions at these shapes; here the
model runs those plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import mlp as JMLP
from repro.models import model as JM
from repro.models import rope as JR
from repro.models import transformer as JT
from repro.serving import sampler as JS
from repro_torch import io
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import mlp as TMLP
from repro_torch.models import model as TM
from repro_torch.models import rope as TR
from repro_torch.models import transformer as TT
from repro_torch.serving import sampler as TS

F32_TOL = 2e-5
BF16_TOL = 3e-2
N_QUERIES = 8
PROMPT_LEN = 49
FAMILIES = ("qwen2-vl-7b", "whisper-medium")
# qwen2-vl at its full-width GQA group 7 (28 heads of 32 on 4 kv-heads)
G7 = dict(d_model=896, num_heads=28)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _close(got, want, what="", tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=what)


def _caches_close(tc, jc, tol=F32_TOL):
    jf, tf_ = _flat(jc), _flat(tc)
    assert set(jf) == set(tf_)
    for path, leaf in jf.items():
        assert tuple(tf_[path].shape) == tuple(leaf.shape), path
        _close(tf_[path], leaf, path, tol)


def _configs(name, kw=None, replace=None):
    """(JAX config, port config): ``reduced(**kw)`` of ``name`` (kw None:
    the full config), then ``replace`` on both."""
    jcfg, tcfg = jget_config(name), get_config(name)
    if kw is not None:
        jcfg, tcfg = jcfg.reduced(**kw), tcfg.reduced(**kw)
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        tcfg = dataclasses.replace(tcfg, **replace)
    return jcfg, tcfg


def _pair(name, kw=None, replace=None, seed=0):
    jcfg, tcfg = _configs(name, {} if kw is None else kw, replace)
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = io.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, tcfg, params, tp


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return _pair(request.param)


def _grid_positions(b, s, patches, side):
    """Qwen2-VL's layout (the port's ``grid_positions_3d``) on a ``side`` x
    ``side`` grid, as numpy int32."""
    return tpipe.grid_positions_3d(b, s, patches, side=side).numpy()


def _stub_batch(cfg, b, s, seed, dtype=np.float32, grid=True):
    """Numpy tokens and the family's stubs, seeded."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.is_encoder_decoder:
        batch["enc_features"] = rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model)).astype(dtype)
    if cfg.num_stub_patches:
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_stub_patches, cfg.d_model)).astype(dtype)
        if grid:
            batch["positions_3d"] = _grid_positions(
                b, s, cfg.num_stub_patches, 4)
    return batch


def _jbatch(batch, bf16=False):
    out = {}
    for k, v in batch.items():
        a = jnp.asarray(v)
        out[k] = a.astype(jnp.bfloat16) if bf16 and a.dtype == \
            jnp.float32 else a
    return out


def _tbatch(batch, bf16=False):
    out = {}
    for k, v in batch.items():
        t = torch.tensor(v)
        out[k] = t.to(torch.bfloat16) if bf16 and t.dtype == \
            torch.float32 else t
    return out


# ---------------------------------------------------------------------------
# configs, plans, init, the bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [None, {}, G7], ids=["full", "reduced",
                                                     "reduced g7"])
@pytest.mark.parametrize("name", FAMILIES)
def test_config_fields_equal_jax(name, kw):
    jcfg, tcfg = _configs(name, kw)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert get_config(name).name == name
    if name == "qwen2-vl-7b":
        assert tcfg.rope_kind == "mrope" and not tcfg.is_encoder_decoder
        assert sum(tcfg.mrope_sections) == tcfg.resolved_head_dim
        assert tcfg.num_stub_patches == (256 if kw is None else 8)
    else:
        assert tcfg.rope_kind == "none" and tcfg.mlp_kind == "gelu"
        assert (tcfg.num_encoder_layers, tcfg.encoder_seq_len) == (
            (24, 1500) if kw is None else (2, 32))


def test_full_width_geometry():
    """The shapes the card's kernels meet at full width: qwen2-vl's GQA
    group 7 at heads of 128, whisper's heads of 64 at group 1 over 1500
    encoder frames."""
    q, w = get_config("qwen2-vl-7b"), get_config("whisper-medium")
    assert (q.num_heads, q.num_kv_heads, q.resolved_head_dim,
            q.num_layers) == (28, 4, 128, 28)
    assert q.mrope_sections == (16, 56, 56)
    assert (w.num_heads, w.num_kv_heads, w.resolved_head_dim, w.num_layers,
            w.num_encoder_layers, w.encoder_seq_len) == (16, 16, 64, 24, 24,
                                                         1500)
    small = get_config("qwen2-vl-7b").reduced(**G7)
    assert small.num_heads // small.num_kv_heads == 7
    assert small.mrope_sections == (8, 12, 12)


@pytest.mark.parametrize("kw", [None, {}], ids=["full", "reduced"])
@pytest.mark.parametrize("name", FAMILIES)
def test_build_plan_equal_jax(name, kw):
    jcfg, tcfg = _configs(name, kw)
    assert TT.build_plan(tcfg) == JT.build_plan(jcfg) == [
        (("attn",), tcfg.num_layers)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_and_cache_match_jax_structure_and_dtypes(name, dtype):
    """The encoder's stacked norms in the model dtype and its final norm
    float32, ``vision_proj`` in the model dtype, the cross caches ck / cv
    (L, b, hq, enc_seq, hd) beside k / v."""
    jcfg, tcfg = _configs(name, {}, dict(dtype=dtype))
    for jtree, ttree in (
            (jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                            jax.random.PRNGKey(0)),
             TM.init_params(tcfg, seed=0, device="cpu")),
            (jax.eval_shape(lambda: JM.init_cache(jcfg, 3, 80)),
             TM.init_cache(tcfg, 3, 80, device="cpu"))):
        jf, tf_ = _flat(jtree), _flat(ttree)
        assert set(jf) == set(tf_)
        for path, leaf in jf.items():
            assert tuple(tf_[path].shape) == tuple(leaf.shape), path
            want = torch.bfloat16 if leaf.dtype == jnp.bfloat16 \
                else torch.float32
            assert tf_[path].dtype == want, path
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    if tcfg.is_encoder_decoder:
        enc = tp["encoder"]
        assert enc["final_norm"]["scale"].dtype == torch.float32
        assert enc["segments"][0]["0"]["attn_norm"]["scale"].dtype == \
            TC.dtype_of(dtype)
        assert "cross" in tp["segments"][0]["0"]
        cache = TM.init_cache(tcfg, 3, 80, device="cpu")[0]["0"]
        assert tuple(cache["ck"].shape) == (2, 3, 4, 32, 64)
    else:
        assert tp["vision_proj"].dtype == TC.dtype_of(dtype)


def test_bridge_is_leaf_for_leaf(family):
    _, _, params, tp = family
    jf, tf_ = _flat(params), _flat(tp)
    assert set(jf) == set(tf_)
    for path, leaf in jf.items():
        np.testing.assert_array_equal(_np(tf_[path]), _np(leaf), err_msg=path)


def test_bridge_refuses_a_tree_that_does_not_fit():
    """A whisper tree without its encoder, with an encoder of the wrong
    depth, without its cross leaves or with SwiGLU leaves; a qwen2-vl tree
    without ``vision_proj``, with a wrong-shaped one, or bridged to a
    decoder-only config without patches: each refused."""
    jcfg, tcfg = _configs("whisper-medium", {})
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    io.params_from_numpy(tree, tcfg, "cpu")
    with pytest.raises(ValueError, match="encoder"):
        io.params_from_numpy({k: v for k, v in tree.items()
                              if k != "encoder"}, tcfg, "cpu")
    with pytest.raises(ValueError, match="layers"):
        io.params_from_numpy(tree, dataclasses.replace(
            tcfg, num_encoder_layers=3), "cpu")
    seg = tree["segments"][0]["0"]
    no_cross = {k: v for k, v in seg.items() if not k.startswith("cross")}
    with pytest.raises(ValueError, match="cross"):
        io.params_from_numpy(dict(tree, segments=({"0": no_cross},)), tcfg,
                             "cpu")
    with pytest.raises(ValueError, match="MLP"):
        io.params_from_numpy(tree, dataclasses.replace(
            tcfg, mlp_kind="swiglu"), "cpu")
    with pytest.raises(ValueError, match="encoder"):
        io.params_from_numpy(tree, dataclasses.replace(
            tcfg, is_encoder_decoder=False), "cpu")
    qj, qt = _configs("qwen2-vl-7b", {})
    qtree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                    qj))
    with pytest.raises(ValueError, match="vision_proj"):
        io.params_from_numpy({k: v for k, v in qtree.items()
                              if k != "vision_proj"}, qt, "cpu")
    with pytest.raises(ValueError, match="vision_proj"):
        io.params_from_numpy(dict(qtree, vision_proj=qtree["vision_proj"][
            :, :8]), qt, "cpu")
    with pytest.raises(ValueError, match="vision_proj"):
        io.params_from_numpy(qtree, dataclasses.replace(
            qt, num_stub_patches=0), "cpu")


# ---------------------------------------------------------------------------
# the new pieces: M-RoPE, sinusoids, GELU, cross-attention, the encoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd,sections", [(128, (16, 56, 56)),
                                         (64, (16, 24, 24)),
                                         (32, (8, 12, 12))])
def test_mrope_cos_sin_equal_jax(hd, sections):
    pos = np.random.default_rng(hd).integers(0, 4000, (3, 2, 17)).astype(
        np.int32)
    jc, js = JR.mrope_cos_sin(jnp.asarray(pos), hd, 1e6, sections)
    tc, ts = TR.mrope_cos_sin(torch.tensor(pos), hd, 1e6, sections)
    assert tuple(tc.shape) == (2, 17, hd)
    _close(tc, jc, "cos")
    _close(ts, js, "sin")
    # each stream rotates its own slots: moving the width stream moves only
    # the width slots (and their duplicates)
    moved = pos.copy()
    moved[2] += 1
    tc2, _ = TR.mrope_cos_sin(torch.tensor(moved), hd, 1e6, sections)
    changed = (tc2 != tc).any(0).any(0)
    t_half, h_half = sections[0] // 2, sections[1] // 2
    want = torch.zeros(hd // 2, dtype=torch.bool)
    want[t_half + h_half:] = True
    assert torch.equal(changed[:hd // 2], want)
    assert torch.equal(changed[hd // 2:], want)


def test_text_only_mrope_bitwise_equals_rope_on_both_sides():
    pos = np.random.default_rng(0).integers(0, 5000, (3, 21)).astype(
        np.int32)
    jp = jnp.asarray(pos)
    for a, b in zip(JR.mrope_cos_sin(JR.text_positions_3d(jp), 128, 1e6,
                                     (16, 56, 56)),
                    JR.rope_cos_sin(jp, 128, 1e6), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tp = torch.tensor(pos)
    assert tuple(TR.text_positions_3d(tp).shape) == (3, 3, 21)
    for a, b in zip(TR.mrope_cos_sin(TR.text_positions_3d(tp), 128, 1e6,
                                     (16, 56, 56)),
                    TR.rope_cos_sin(tp, 128, 1e6), strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="sum"):
        TR.mrope_cos_sin(TR.text_positions_3d(tp), 128, 1e6, (16, 56, 48))


def test_sinusoids_equal_jax():
    for length, dim in ((32, 256), (49, 1024), (7, 64)):
        _close(TC.sinusoidal_positions(length, dim, device="cpu"),
               JC.sinusoidal_positions(length, dim), f"table {length}x{dim}")
    pos = np.array([0, 5, 48, 61], np.int32)
    _close(TC.sinusoid_at(torch.tensor(pos), 256),
           JM._sinusoid_at(jnp.asarray(pos), 256), "at positions")
    # the decode rows are the table's rows
    table = TC.sinusoidal_positions(62, 256, device="cpu")
    assert torch.equal(TC.sinusoid_at(torch.tensor(pos), 256),
                       table[torch.tensor(pos).long()])
    bf = TC.sinusoidal_positions(49, 1024, device="cpu", dtype=torch.bfloat16)
    jbf = JC.sinusoidal_positions(49, 1024, jnp.bfloat16)
    assert bf.dtype == torch.bfloat16
    _close(bf, jbf, "bf16 table", BF16_TOL)


def test_gelu_mlp_is_tanh_gelu_like_jax():
    """``jax.nn.gelu`` defaults to the tanh approximation and ``F.gelu`` to
    the exact erf: the port asks for tanh."""
    jcfg, tcfg = _configs("whisper-medium", {})
    x = np.random.default_rng(1).standard_normal((3, 5, 256)).astype(
        np.float32) * 3
    jp = JMLP.init_mlp(jax.random.PRNGKey(2), jcfg)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    assert set(tp) == {"w1", "w2"}
    _close(TMLP.mlp_forward(tp, tcfg, torch.tensor(x)),
           JMLP.mlp_forward(jp, jcfg, jnp.asarray(x)), "gelu mlp")
    z = np.linspace(-6, 6, 1001).astype(np.float32)
    tanh = torch.nn.functional.gelu(torch.tensor(z), approximate="tanh")
    _close(tanh, jax.nn.gelu(jnp.asarray(z)), "tanh gelu")
    erf = torch.nn.functional.gelu(torch.tensor(z))
    assert float((erf - tanh).abs().max()) > 1e-4


def test_cross_attention_and_encoder_equal_jax():
    """``cross_kv`` (K/V with num_heads heads), ``cross_attend`` over them
    at a prompt and at sq = 1, and ``_encode``: frontend projection,
    sinusoids, the non-causal stack, the final norm."""
    jcfg, tcfg, params, tp = _pair("whisper-medium", seed=3)
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 32, 256)).astype(np.float32)
    jenc = JM._encode(params, jcfg, jnp.asarray(enc))
    tenc = TM._encode(tp, tcfg, torch.tensor(enc))
    _close(tenc, jenc, "encoder output")
    jcross = jax.tree.map(lambda a: a[0], params["segments"][0]["0"]["cross"])
    tcross = {k: v[0] for k, v in tp["segments"][0]["0"]["cross"].items()}
    jkv = JA.cross_kv(jcross, jcfg, jenc)
    tkv = TA.cross_kv(tcross, tcfg, tenc)
    assert tuple(tkv["ck"].shape) == (2, 4, 32, 64)
    for key in ("ck", "cv"):
        _close(tkv[key], jkv[key], key)
    for s in (9, 1):
        x = rng.standard_normal((2, s, 256)).astype(np.float32)
        _close(TA.cross_attend(tcross, tcfg, torch.tensor(x), tkv),
               JA.cross_attend(jcross, jcfg, jnp.asarray(x), jkv),
               f"cross_attend sq={s}")
    # the encoder is not causal: the first frame's output sees the last
    moved = enc.copy()
    moved[:, -1] += 1.0
    assert not torch.allclose(TM._encode(tp, tcfg, torch.tensor(moved))[:, 0],
                              tenc[:, 0])


def test_image_embeds_replace_the_first_positions():
    jcfg, tcfg, params, tp = _pair("qwen2-vl-7b", seed=5)
    batch = _stub_batch(tcfg, 2, 12, seed=6)
    th = TM._embed(tp, tcfg, torch.tensor(batch["tokens"]), _tbatch(batch))
    jh = JM._embed(params, jcfg, jnp.asarray(batch["tokens"]), _jbatch(batch))
    _close(th, jh, "embed")
    img = torch.tensor(batch["image_embeds"]) @ tp["vision_proj"]
    assert torch.equal(th[:, :8], img)
    assert torch.equal(th[:, 8:], tp["embed"][torch.tensor(
        batch["tokens"][:, 8:]).long()])


def test_a_prompt_shorter_than_the_patches_is_refused():
    """The reference concatenates P patch rows onto s - P text rows even
    when s < P, and its shapes break further on; the port refuses."""
    jcfg, tcfg, params, tp = _pair("qwen2-vl-7b", seed=5)
    batch = _stub_batch(tcfg, 2, 5, seed=7, grid=False)
    with pytest.raises(Exception):
        JM.prefill(params, jcfg, _jbatch(batch))
    with pytest.raises(ValueError, match="patches"):
        TM.prefill(tp, tcfg, _tbatch(batch))


def test_float32_stubs_in_a_bf16_model_promote_as_in_jax():
    """Stubs belong in the model dtype; float32 stubs with bf16 weights
    compute in float32 where JAX promotes: the patch projection (cast to
    bf16 before the scatter), the encoder and the cross K/V (float32
    caches)."""
    for name in FAMILIES:
        jcfg, tcfg, params, tp = _pair(name, replace=dict(dtype="bfloat16"),
                                       seed=8)
        batch = _stub_batch(tcfg, 2, 12, seed=9)
        jl, jc = JM.prefill(params, jcfg, _jbatch(batch))
        tl, tc = TM.prefill(tp, tcfg, _tbatch(batch))
        assert tl.dtype == torch.bfloat16
        _close(tl, jl, f"{name} logits", BF16_TOL)
        if name == "whisper-medium":
            ck = tc[0]["0"]["ck"]
            assert ck.dtype == torch.float32
            assert jc[0]["0"]["ck"].dtype == jnp.float32
            _close(ck, jc[0]["0"]["ck"], "f32 cross keys", 1e-4)
            _close(TM._encode(tp, tcfg, torch.tensor(batch["enc_features"])),
                   JM._encode(params, jcfg, jnp.asarray(
                       batch["enc_features"])), "f32 encoder", 1e-4)


# ---------------------------------------------------------------------------
# the model: logits, caches, decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(family, dtype):
    """Prefill with the family's stubs (qwen2-vl: 8 patches and a (t, h, w)
    grid in ``positions_3d``; whisper: 32 encoder frames), then three
    decode steps on the grown caches; bf16 with the stubs in bf16."""
    jcfg, tcfg, params, tp = family
    tol, bf = F32_TOL, dtype == "bfloat16"
    if bf:
        jcfg, tcfg, params, tp = _pair(tcfg.name, replace=dict(dtype=dtype))
        tol = BF16_TOL
    batch = _stub_batch(tcfg, 3, PROMPT_LEN, seed=10)
    steps = np.random.default_rng(11).integers(0, 512, (3, 3)).astype(
        np.int32)
    jl, jc = JM.prefill(params, jcfg, _jbatch(batch, bf))
    tl, tc = TM.prefill(tp, tcfg, _tbatch(batch, bf))
    assert tl.dtype == TC.dtype_of(dtype)
    _close(tl, jl, "prefill logits", tol)
    _caches_close(tc, jc, tol)
    jc = JS._pad_caches(jc, PROMPT_LEN + 3, PROMPT_LEN)
    tc = TS._pad_caches(tc, PROMPT_LEN + 3, PROMPT_LEN)
    pos = np.full((3,), PROMPT_LEN, np.int32)
    for t in range(3):
        jl, jc = JM.decode_step(params, jcfg, jnp.asarray(steps[:, t:t + 1]),
                                jc, jnp.asarray(pos + t))
        tl, tc2 = TM.decode_step(tp, tcfg, torch.tensor(steps[:, t:t + 1]),
                                 tc, torch.tensor(pos + t))
        assert tc2 is tc
        _close(tl, jl, f"decode logits step {t}", tol)
    _caches_close(tc, jc, tol)


def _continuation(TMod, params, cfg, batch, split, to):
    """Prefill of the first ``split`` tokens (all stubs), then decode of the
    rest one token at a time, both through module ``TMod`` (the port's or
    the reference's ``models.model``); returns the logits at positions
    split - 1 .. s - 1 stacked on axis 1."""
    toks = batch["tokens"]
    s = toks.shape[1]
    head = dict(batch, tokens=toks[:, :split])
    if "positions_3d" in head:
        head["positions_3d"] = batch["positions_3d"][:, :, :split]
    logits, caches = TMod.prefill(params, cfg, to(head))
    grow = TS._pad_caches if TMod is TM else JS._pad_caches
    caches = grow(caches, s, split)
    outs = [logits[:, -1]]
    for t in range(split, s):
        pos = np.full((toks.shape[0],), t, np.int32)
        lg, caches = TMod.decode_step(params, cfg,
                                      to({"t": toks[:, t:t + 1]})["t"],
                                      caches, to({"p": pos})["p"])
        outs.append(lg[:, 0])
    return outs


def test_whisper_decode_continues_the_full_forward_on_both_sides():
    """Prefill of 10 tokens then 6 decode steps (sinusoid rows at each
    position, self K/V growing, the cross caches read) equals the full
    forward over 16, on each side; and the two sides agree."""
    jcfg, tcfg, params, tp = _pair("whisper-medium", seed=12)
    batch = _stub_batch(tcfg, 2, 16, seed=13)
    full_t, _ = TM.forward_train(tp, tcfg, _tbatch(batch))
    full_j, _ = JM.forward_train(params, jcfg, _jbatch(batch))
    dec_t = _continuation(TM, tp, tcfg, batch, 10, _tbatch)
    dec_j = _continuation(JM, params, jcfg, batch, 10, _jbatch)
    for i, (a, b) in enumerate(zip(dec_t, dec_j, strict=True)):
        _close(a, full_t[:, 9 + i], f"port step {i}", 5e-5)
        _close(b, full_j[:, 9 + i], f"reference step {i}", 5e-5)
        _close(a, b, f"port vs reference step {i}")


def test_qwen2_vl_decode_rotates_by_the_cache_index():
    """Decode rotates by ``text_positions_3d(pos)``, the cache index on
    every stream: after a prefill with text positions it continues the full
    forward; after one with a spatial grid in ``positions_3d`` (whose text
    positions run behind the cache index) it does not, on both sides
    alike (ROADMAP Queue 3)."""
    jcfg, tcfg, params, tp = _pair("qwen2-vl-7b", seed=14)
    for grid in (False, True):
        batch = _stub_batch(tcfg, 2, 16, seed=15, grid=grid)
        full_t, _ = TM.forward_train(tp, tcfg, _tbatch(batch))
        full_j, _ = JM.forward_train(params, jcfg, _jbatch(batch))
        dec_t = _continuation(TM, tp, tcfg, batch, 10, _tbatch)
        dec_j = _continuation(JM, params, jcfg, batch, 10, _jbatch)
        for i, (a, b) in enumerate(zip(dec_t, dec_j, strict=True)):
            _close(a, b, f"grid {grid} port vs reference step {i}")
            if i == 0 or not grid:
                _close(a, full_t[:, 9 + i], f"port step {i}", 5e-5)
                _close(b, full_j[:, 9 + i], f"reference step {i}", 5e-5)
            else:
                assert not np.allclose(_np(a), _np(full_t[:, 9 + i]),
                                       atol=1e-3)
                assert not np.allclose(_np(b), _np(full_j[:, 9 + i]),
                                       atol=1e-3)


def test_loss_equals_jax(family):
    """``loss_fn`` with the stubs in the batch."""
    jcfg, tcfg, params, tp = family
    batch = _stub_batch(tcfg, 3, 20, seed=16)
    labels = np.where(np.random.default_rng(17).random((3, 20)) < 0.3, -100,
                      batch["tokens"]).astype(np.int32)
    for b in (batch, dict(batch, labels=labels)):
        jloss, jm = JM.loss_fn(params, jcfg, _jbatch(b))
        tloss, tm = TM.loss_fn(tp, tcfg, _tbatch(b))
        assert float(tloss) == pytest.approx(float(jloss), abs=F32_TOL)
        for k in ("ce", "acc", "aux"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), abs=F32_TOL)
