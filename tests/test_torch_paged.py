"""Paged KV in the port against the JAX package: the plain paged decode
attention against ``repro.kernels.ops.paged_decode_attention`` (its XLA
gather path and the Pallas kernel in interpret mode), the page pool's
accounting against ``repro.serving.kv_pool``, and paged prefill, decode
segments, refills and slot runs on bridged ``tiny_trained`` weights against
the port's dense path and the JAX paged path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.estimator import ReasoningEstimator as JEstimator
from repro.kernels import ops as jops
from repro.kernels.decode_attention import KernelType
from repro.serving import kv_pool as JK
from repro.serving import sampler as JS
from repro_torch import io
from repro_torch.configs.scope_estimator import CONFIG, TINY
from repro_torch.core.estimator import ReasoningEstimator as TEstimator
from repro_torch.kernels import decode_attention as DA
from repro_torch.serving import kv_pool as TK
from repro_torch.serving import sampler as TS

F32_TOL = 2e-5

PAGED_CASES = [
    # b, hq, hkv, S, d, page_size, lens, softcap
    (2, 4, 2, 128, 32, 16, (100, 128), 0.0),
    (1, 8, 4, 64, 64, 8, (40,), 50.0),
    (3, 4, 2, 96, 32, 32, (10, 77, 96), 0.0),
]


def _layout(seed, b, hq, hkv, S, d, page, n_pages=64):
    """q, dense caches (b, hkv, S, d), and the same keys in block-paged
    storage behind a permuted page table, random values everywhere else."""
    rng = np.random.default_rng(seed)
    n_w = -(-S // page)
    q = (rng.standard_normal((b, hq, 1, d)) * 0.5).astype(np.float32)
    kc = rng.standard_normal((b, hkv, S, d)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, S, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages + 1, hkv, page, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, hkv, page, d)).astype(np.float32)
    table = rng.permutation(n_pages)[: b * n_w].reshape(b, n_w)
    for i in range(b):
        for w in range(n_w):
            sl = slice(w * page, min((w + 1) * page, S))
            kp[table[i, w], :, : sl.stop - sl.start] = kc[i, :, sl]
            vp[table[i, w], :, : sl.stop - sl.start] = vc[i, :, sl]
    return q, kc, vc, kp, vp, table.astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the plain paged version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_plain_paged_matches_reference(case, kernel):
    b, hq, hkv, S, d, page, lens, cap = case
    q, _, _, kp, vp, table = _layout(11, b, hq, hkv, S, d, page)
    clen = np.asarray(lens, np.int32)
    want = jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(clen),
        jnp.asarray(table), page_size=page, kv_cap=S, softcap=cap,
        kernel={"xla": KernelType.XLA, "pallas": KernelType.PALLAS}[kernel])
    tq, tkp, tvp, tlen, ttab = _t(q, kp, vp, clen, table)
    got = DA.paged_decode_attention(tq, tkp, tvp, tlen, ttab, page_size=page,
                                    kv_cap=S, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("case", PAGED_CASES)
def test_plain_paged_bit_equal_to_plain_dense(case):
    """Gather -> slice -> the dense plain version: bitwise the dense
    output on the logical cache, any page permutation, per-row lengths."""
    b, hq, hkv, S, d, page, lens, cap = case
    q, kc, vc, kp, vp, table = _layout(12, b, hq, hkv, S, d, page)
    tq, tkc, tvc, tkp, tvp, ttab = _t(q, kc, vc, kp, vp, table)
    clen = torch.tensor(lens, dtype=torch.int32)
    dense = DA.decode_attention_plain(tq, tkc, tvc, clen, softcap=cap)
    paged = DA.paged_decode_attention_plain(tq, tkp, tvp, clen, ttab,
                                            page_size=page, kv_cap=S,
                                            softcap=cap)
    assert torch.equal(paged, dense)


def test_plain_paged_clipped_last_page_and_empty_row():
    """kv_cap below W * page (a clipped last page) and a row with no valid
    key (0 out, like the Pallas kernel)."""
    q, kc, vc, kp, vp, table = _layout(13, 2, 4, 2, 50, 32, 16)
    tq, tkc, tvc, tkp, tvp, ttab = _t(q, kc, vc, kp, vp, table)
    clen = torch.tensor([0, 37], dtype=torch.int32)
    got = DA.paged_decode_attention_plain(tq, tkp, tvp, clen, ttab,
                                          page_size=16, kv_cap=50)
    assert table.shape[1] * 16 > 50
    assert torch.equal(got, DA.decode_attention_plain(tq, tkc, tvc, clen))
    assert bool((got[0] == 0).all())


def test_plain_paged_trash_page_is_inert():
    """Garbage in the trash page or any unreferenced page cannot reach the
    output: only table-referenced, length-valid positions contribute."""
    q, _, _, kp, vp, table = _layout(14, 1, 4, 2, 64, 32, 16, n_pages=32)
    tq, tkp, tvp, ttab = _t(q, kp, vp, table)
    clen = torch.tensor([40], dtype=torch.int32)
    kw = dict(page_size=16, kv_cap=64)
    base = DA.paged_decode_attention(tq, tkp, tvp, clen, ttab, **kw)
    unref = torch.ones(tkp.shape[0], dtype=torch.bool)
    unref[ttab.reshape(-1).long()] = False
    assert unref[-1]                                    # the trash page
    pk, pv = tkp.clone(), tvp.clone()
    pk[unref], pv[unref] = 1e9, 1e9
    got = DA.paged_decode_attention(tq, pk, pv, clen, ttab, **kw)
    assert torch.equal(got, base)


def test_paged_wrapper_guards():
    """The CUDA wrapper refuses CPU tensors (no fallback), and its argument
    check rejects what the kernel does not take."""
    q, _, _, kp, vp, table = _layout(15, 2, 4, 2, 32, 32, 8)
    tq, tkp, tvp, ttab = _t(q, kp, vp, table)
    lens = torch.tensor([5, 32], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        DA.paged_decode_attention_cuda(tq, tkp, tvp, lens, ttab, page_size=8,
                                       kv_cap=32)
    ok = dict(page_size=8, kv_cap=32)
    DA.check_paged_args(tq, tkp, tvp, lens, ttab, **ok)
    bad = [
        ((tq, tkp, tvp, lens, ttab.long()), ok, "int32"),
        ((tq, tkp, tvp, lens, ttab), dict(page_size=8, kv_cap=33), "kv_cap"),
        ((tq, tkp, tvp, lens, ttab), dict(page_size=16, kv_cap=32),
         "page_size"),
        ((tq.double(), tkp, tvp, lens, ttab), ok, "dtypes"),
        ((torch.zeros(2, 34, 1, 32), tkp[:, :2], tvp[:, :2], lens, ttab), ok,
         "group"),
        ((tq, tkp, tvp, lens.long(), ttab), ok, "int32"),
        ((tq, tkp, tvp, lens, ttab.t()), ok, "page_table"),
    ]
    for args, kw, msg in bad:
        with pytest.raises(ValueError, match=msg):
            DA.check_paged_args(*args, **kw)


# ---------------------------------------------------------------------------
# the page pool
# ---------------------------------------------------------------------------
def _pool_state(pg):
    return (pg.table.tolist(), [list(r) for r in pg.row_pages],
            list(pg.row_reserved), pg.row_high.tolist(), pg.row_live.tolist(),
            list(pg.pool._free), pg.pool.reserved, pg.pool.pages_peak,
            pg.pool.live_tokens, pg.pool.tokens_peak, pg.pool.available())


def _apply(pg, op, row, arg):
    """One trace op on a PagedKV; returns the exception type it raised."""
    try:
        if op == "admit":
            pg.admit_row(row, arg)
        elif op == "pre_admit":
            pg.pre_admit(row, arg)
        elif op == "ensure":
            pg.check_steps(row)
            pg.ensure(row)
        elif op == "starved":
            return tuple(pg.starved_rows(row))
        else:
            pg.retire_row(row)
    except (RuntimeError, ValueError) as exc:
        return type(exc)
    return None


def _same_trace(ops):
    pools = (JK.KVPool(n_pages=24, page_size=4),
             TK.KVPool(n_pages=24, page_size=4))
    pgs = [p.attach(4, kv_cap=32, budget_steps=8) for p in pools]
    for op, row, arg in ops:
        outs = [_apply(pg, op, row, arg) for pg in pgs]
        assert outs[0] == outs[1], (op, row, arg, outs)
        assert _pool_state(pgs[0]) == _pool_state(pgs[1]), (op, row, arg)
        assert pgs[1].prompt_page_ids(np.arange(4) % 2 == 0, 3).tolist() == \
            pgs[0].prompt_page_ids(np.arange(4) % 2 == 0, 3).tolist()
    return pgs


def test_pool_accounting_matches_reference():
    """A fixed trace of admissions, decode advances, starvation probes,
    pre-admits and retirements leaves both pools in the same state after
    every op, failures included."""
    ops = [("admit", 0, 9), ("admit", 1, 4), ("ensure", 4, 0),
           ("admit", 2, 30), ("admit", 0, 5), ("starved", 4, 0),
           ("ensure", 4, 0), ("retire", 1, 0), ("pre_admit", 1, 12),
           ("admit", 3, 40), ("ensure", 8, 0), ("starved", 8, 0),
           ("retire", 0, 0), ("retire", 2, 0), ("pre_admit", 0, 1),
           ("ensure", 3, 0), ("retire", 1, 0), ("retire", 0, 0)]
    pgs = _same_trace(ops)
    pool = pgs[1].pool
    assert pool.pages_peak > 0 and pool.tokens_peak > 0
    assert pool.pages_in_use == 0 and pool.reserved == 0
    assert (pgs[1].table == pool.trash_page).all()


def test_pool_trace_property_matches_reference():
    """Hypothesis: any interleaving of admit / pre-admit / decode-advance /
    starvation probe / retire keeps the two pools in lockstep."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    trace = st.lists(st.one_of(
        st.tuples(st.sampled_from(["admit", "pre_admit"]), st.integers(0, 3),
                  st.integers(0, 34)),
        st.tuples(st.sampled_from(["ensure", "starved"]), st.integers(1, 6),
                  st.just(0)),
        st.tuples(st.just("retire"), st.integers(0, 3), st.just(0))),
        min_size=1, max_size=40)

    @given(trace)
    @settings(max_examples=150, deadline=None)
    def lockstep(ops):
        _same_trace(ops)

    lockstep()


def test_pool_guards_and_sizes_match_reference():
    for mod in (JK, TK):
        pool = mod.KVPool(n_pages=4, page_size=8)
        ids = pool.alloc(3)
        pool.free(ids[:1])
        with pytest.raises(RuntimeError, match="double free"):
            pool.free(ids[:1])
        with pytest.raises(RuntimeError, match="invalid"):
            pool.free([pool.n_pages])
        with pytest.raises(ValueError, match="n_pages"):
            mod.KVPool(n_pages=0, page_size=8)
        pg = mod.KVPool(n_pages=4, page_size=8).attach(
            2, kv_cap=64, budget_steps=64)
        with pytest.raises(ValueError, match="full-budget row"):
            pg.admit_row(0, 10)
    from repro.configs.scope_estimator import CONFIG as JCONFIG
    from repro.configs.scope_estimator import TINY as JTINY
    assert TK.kv_bytes_per_token(TINY) == JK.kv_bytes_per_token(JTINY)
    assert TK.kv_bytes_per_token(CONFIG) == JK.kv_bytes_per_token(JCONFIG)
    assert TK.check_kv_kernel("XLA") == "xla"
    assert TK.check_kv_kernel("pallas") == "pallas"
    with pytest.raises(ValueError, match="kv_kernel"):
        TK.check_kv_kernel("triton")


# ---------------------------------------------------------------------------
# paged prefill / decode / refill on bridged weights
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bridged(tiny_trained):
    cfg, params, _ = tiny_trained
    tparams = io.params_from_numpy(jax.tree.map(np.asarray, params), TINY,
                                   device="cpu")
    return cfg, params, tparams


def _states(bridged, prompts, lens, budget, page_size=8, pool_pages=64):
    """(port dense, port paged, JAX paged) states over the same prompts."""
    cfg, jparams, tparams = bridged
    dense = TS.prefill_state(tparams, TINY, prompts, max_new_tokens=budget,
                             prompt_lens=lens)
    tpool = TK.KVPool(n_pages=pool_pages, page_size=page_size)
    paged = TS.prefill_state(tparams, TINY, prompts, max_new_tokens=budget,
                             prompt_lens=lens, kv_pool=tpool)
    jpool = JK.KVPool(n_pages=pool_pages, page_size=page_size)
    jpaged = JS.prefill_state(jparams, cfg, prompts, max_new_tokens=budget,
                              prompt_lens=lens, kv_pool=jpool)
    return dense, paged, jpaged


def _segment(bridged, states, steps, refill=None):
    cfg, jparams, tparams = bridged
    dense, paged, jpaged = states
    dense, g0, d0 = TS.decode_segment(tparams, TINY, dense, steps,
                                      refill=refill)
    paged, g1, d1 = TS.decode_segment(tparams, TINY, paged, steps,
                                      refill=refill)
    jpaged, g2, d2 = JS.decode_segment(jparams, cfg, jpaged, steps,
                                       refill=refill)
    assert torch.equal(g0, g1) and torch.equal(d0, d1)
    np.testing.assert_array_equal(g1.numpy(), np.asarray(g2))
    np.testing.assert_allclose(d1.numpy(), np.asarray(d2), atol=F32_TOL,
                               rtol=F32_TOL)
    assert _pool_state(paged.paged) == _pool_state(jpaged.paged)
    return dense, paged, jpaged


def test_paged_prefill_and_segments(bridged):
    """Paged == dense in the port bit for bit, and == the JAX paged path in
    tokens (logits to 2e-5): ragged prompt lengths, several segments."""
    prompts = np.random.default_rng(10).integers(
        3, 100, size=(3, 20)).astype(np.int32)
    states = _states(bridged, prompts, [20, 13, 7], budget=12)
    assert torch.equal(states[0].last_logits, states[1].last_logits)
    for steps in (5, 4, 3):
        states = _segment(bridged, states, steps)
    assert torch.equal(states[0].positions, states[1].positions)
    assert torch.equal(states[0].done, states[1].done)


def test_paged_fused_refill_segment(bridged):
    """The refill fused into a segment: the refilled row restarts from its
    true length in fresh pages, the others keep decoding unchanged."""
    rng = np.random.default_rng(11)
    prompts = rng.integers(3, 100, size=(3, 16)).astype(np.int32)
    states = _states(bridged, prompts, [16, 11, 16], budget=14)
    states = _segment(bridged, states, 4)
    mat = np.zeros((3, 16), np.int32)
    mat[1] = rng.integers(3, 100, size=(16,))
    refill = (np.array([False, True, False]), mat,
              np.array([1, 12, 1], np.int64))
    states = _segment(bridged, states, 4, refill=refill)
    states = _segment(bridged, states, 4)


def test_paged_refill_slots(bridged):
    """``refill_slots`` (the unfused prefill-merge) re-pages the refilled
    rows: port paged == port dense bit for bit, tokens == JAX paged."""
    cfg, jparams, tparams = bridged
    rng = np.random.default_rng(12)
    prompts = rng.integers(3, 100, size=(3, 14)).astype(np.int32)
    dense, paged, jpaged = _segment(
        bridged, _states(bridged, prompts, None, budget=10), 3)
    fresh = rng.integers(3, 100, size=(2, 14)).astype(np.int32)
    dense = TS.refill_slots(tparams, TINY, dense, [0, 2], fresh,
                            prompt_lens=[14, 9])
    paged = TS.refill_slots(tparams, TINY, paged, [0, 2], fresh,
                            prompt_lens=[14, 9])
    jpaged = JS.refill_slots(jparams, cfg, jpaged, [0, 2], fresh,
                             prompt_lens=[14, 9])
    assert torch.equal(dense.last_logits, paged.last_logits)
    np.testing.assert_allclose(paged.last_logits.numpy(),
                               np.asarray(jpaged.last_logits), atol=F32_TOL,
                               rtol=F32_TOL)
    states = (dense, paged, jpaged)
    for steps in (4, 3):
        states = _segment(bridged, states, steps)


def test_paged_guards(bridged):
    _, _, tparams = bridged
    prompts = np.random.default_rng(15).integers(
        3, 100, size=(2, 10)).astype(np.int32)
    with pytest.raises(ValueError, match="full-budget row"):
        TS.prefill_state(tparams, TINY, prompts, max_new_tokens=64,
                         kv_pool=TK.KVPool(n_pages=4, page_size=8))
    with pytest.raises(ValueError, match="kv_page_size"):
        TS.prefill_state(tparams, TINY, prompts, max_new_tokens=4,
                         kv_pool=TK.KVPool(n_pages=8, page_size=64))
    with pytest.raises(ValueError, match="kv_kernel"):
        TS.prefill_state(tparams, TINY, prompts, max_new_tokens=4,
                         kv_pool=TK.KVPool(n_pages=8, page_size=8),
                         kv_kernel="cuda")
    state = TS.prefill_state(tparams, TINY, prompts, max_new_tokens=6,
                             kv_pool=TK.KVPool(n_pages=16, page_size=8))
    with pytest.raises(ValueError, match="paged row"):
        TS.decode_segment(tparams, TINY, state, 7)


def test_slot_run_paged_matches_dense_and_reference(bridged):
    """A paged ``SlotRun`` serves the same requests as the dense-horizon
    run and as the JAX paged run, with the same parses, and returns every
    page when it retires."""
    cfg, jparams, tparams = bridged
    rng = np.random.default_rng(16)
    prompts = rng.integers(3, 100, size=(4, 18)).astype(np.int32)
    extra = [(t, list(rng.integers(3, 100, size=18).astype(np.int32)))
             for t in "ef"]

    def drive(est, **kw):
        run = est.open_slots(prompts, tags=["a", "b", "c", "d"],
                             segment_len=4, **kw)
        queue = list(extra)
        results = {}
        while not run.finished or queue:
            if queue and run.free_rows() and run.can_admit():
                n = min(len(queue), len(run.free_rows()))
                run.admit([(t, p, len(p)) for t, p in queue[:n]])
                del queue[:n]
            tags_done, batch = run.step()
            for i, t in enumerate(tags_done):
                results[t] = (int(batch.y_hat[i]), float(batch.len_hat[i]),
                              int(batch.pred_tokens[i]),
                              float(batch.p_conf[i]))
        return results

    test = TEstimator(TINY, tparams, max_new_tokens=8)
    dense = drive(test)
    tpool = TK.KVPool(n_pages=32, page_size=8)
    paged = drive(test, kv_pool=tpool)
    jpool = JK.KVPool(n_pages=32, page_size=8)
    ref = drive(JEstimator(cfg, jparams, max_new_tokens=8), kv_pool=jpool)
    assert set(dense) == set(paged) == set(ref) == set("abcdef")
    for t in dense:
        assert dense[t] == paged[t], t
        assert paged[t][:3] == ref[t][:3], t
        assert paged[t][3] == pytest.approx(ref[t][3], abs=F32_TOL)
    assert tpool.pages_in_use == 0 and tpool.reserved == 0
    assert (tpool.pages_peak, tpool.tokens_peak) == (jpool.pages_peak,
                                                     jpool.tokens_peak)
