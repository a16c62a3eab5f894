"""The generation engine's int8 KV cache in `paddle_tpu_torch`, on the CPU,
held against the JAX package and against the port's own sequential
oracle.

* `quantize_kv` / `dequantize_kv` equal JAX's bitwise (values and
  scales) on seeded rows, all-zero rows and exact half-way ties, and keep
  the reference's round-trip bound;
* `paged_gather_kv` and `paged_decode_attention_reference` with scales
  equal JAX's at 1e-6; `paged_decode_attention` refuses an int8 pool;
* the TransformerLM forward over the 7-tuple int8 cache (C = 1 and 5)
  equals JAX's: logits at 1e-5, the written int8 rows and their scales
  bitwise against JAX's quantization of the same rows; rows past the
  table go to the garbage block, scales too;
* `PagedKVCache(kv_dtype="int8")`: shapes, dtypes, bytes, description;
* the int8 engine's greedy streams and logprobs equal the JAX int8
  engine's, plain and with the prefix cache and 4-token chunks; every
  stream equals the port's `sequential_oracle`; full lengths and under
  half the f32 engine's bytes.

Tiny sizes as tests/test_torch_engine_prefix.py (hidden 128, 2 heads of
64, 2 layers, vocab 128, buckets [8, 16, 40]).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph, framework
from paddle_tpu.ops.pallas import paged_attention as jax_paged
from paddle_tpu_torch import generation as gen
from paddle_tpu_torch import models
from paddle_tpu_torch.generation import kv_cache
from paddle_tpu_torch.ops import (dequantize_kv, paged_decode_attention,
                                  paged_decode_attention_reference,
                                  paged_gather_kv, quantize_kv)

jax_gen = paddle_tpu.generation
KW = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
          intermediate_size=256, max_position_embeddings=128, dropout=0.0)
BUCKETS = [8, 16, 40]
ATTN_TOL = dict(atol=1e-6, rtol=1e-6)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pair():
    with dygraph.guard():
        np.random.seed(0)
        jm = jax_models.TransformerLM(jax_models.TransformerLMConfig(**KW))
    params = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = models.TransformerLM(models.TransformerLMConfig(**KW), device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(params))
    return jm, tm.eval()


def make_engine(model, module=gen, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_buckets", BUCKETS)
    kw.setdefault("max_queue", 64)
    if module is gen:
        kw.setdefault("device", "cpu")
    return module.GenerationEngine(model, **kw)


def mixed_requests(module, n, max_new=6, lo=2, hi=30, seed=1):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        prompt = rng.randint(0, KW["vocab_size"], int(rng.randint(lo, hi)))
        sp = (module.SamplingParams.greedy() if i % 2 == 0 else
              module.SamplingParams(temperature=0.9, top_k=20, top_p=0.9,
                                    seed=100 + i))
        reqs.append(module.GenerationRequest(
            prompt, max_new_tokens=max_new + (i % 3), sampling=sp,
            request_id="q%d" % i))
    return reqs


def serve(eng, reqs):
    handles = [eng.submit(r) for r in reqs]
    eng.run_until_idle()
    return [h.result(timeout=0) for h in handles], handles


def _jax_run(jm, fn):
    with dygraph.guard():
        framework._dygraph_tracer.train_mode = False
        for vb in jm.state_dict().values():
            framework._dygraph_tracer.register_var(vb)
        return fn()


def _jax_quantize(x):
    q, s = jax_paged.quantize_kv(jnp.asarray(x))
    return np.array(q), np.array(s)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def _tie_rows():
    """Rows whose x / scale lands exactly half-way between two integers:
    amax 127 gives scale 1.0, amax 63.5 scale 0.5 (both exact)."""
    a = np.zeros((2, 1, 16), np.float32)
    a[0, 0] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 4.5, -3.5,
               126.5, -126.5, 0, 1, -1, 0.25]
    a[1, 0] = [63.5, 0.25, 0.75, 1.25, -0.25, -0.75, -1.25, 1.75, 2.25,
               -1.75, 63.25, -63.25, 0, 0.5, -0.5, 0.125]
    return a


@pytest.mark.parametrize("case", ["randn", "wide", "zeros", "ties"])
def test_quantize_equals_jax_bitwise(case):
    rng = np.random.RandomState(4)
    x = {"randn": lambda: rng.randn(5, 3, 4, 16).astype(np.float32),
         "wide": lambda: (rng.randn(7, 2, 64) * np.exp(
             rng.uniform(-20, 20, (7, 2, 1)))).astype(np.float32),
         "zeros": lambda: np.zeros((2, 4, 8), np.float32),
         "ties": _tie_rows}[case]()
    want_q, want_s = _jax_quantize(x)
    q, s = quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == x.shape and s.shape == x.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  want_s.view(np.int32))
    back = dequantize_kv(q, s).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jax_paged.dequantize_kv(jnp.asarray(want_q),
                                                 jnp.asarray(want_s))))
    if case == "zeros":
        assert not back.any()
    if case == "ties":
        # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
        assert q.numpy()[0, 0, :12].tolist() == [127, 0, 2, 2, 0, -2, -2,
                                                 4, 4, -4, 126, -126]
        assert q.numpy()[1, 0, :12].tolist() == q.numpy()[0, 0, :12].tolist()


def test_int8_roundtrip_bound():
    """The reference's bound: every element back within amax / 127 of
    its row (symmetric 127-level quantization errs by scale / 2)."""
    rng = np.random.RandomState(4)
    x = rng.randn(5, 3, 4, 16).astype(np.float32)
    q, s = quantize_kv(torch.from_numpy(x))
    back = dequantize_kv(q, s).numpy()
    amax = np.abs(x).max(-1, keepdims=True)
    assert np.all(np.abs(back - x) <= amax / 127.0 + 1e-7)
    assert np.all(np.abs(back - x) <= amax / 254.0 * (1 + 1e-6) + 1e-7)


def _int8_pools(rng, nb=7, bs=4, h=2, d=64):
    x = rng.randn(nb, bs, h, d).astype(np.float32)
    y = rng.randn(nb, bs, h, d).astype(np.float32)
    kq, ks = _jax_quantize(x)
    vq, vs = _jax_quantize(y)
    return kq, vq, ks, vs


def test_gather_and_decode_reference_with_scales_match_jax():
    rng = np.random.RandomState(5)
    kq, vq, ks, vs = _int8_pools(rng)
    tables = np.array([[3, 1, 0], [2, 6, 5], [4, 0, 0]], np.int32)
    lengths = np.array([6, 12, 0], np.int32)
    q = rng.randn(3, 2, 64).astype(np.float32)
    want_g = np.asarray(jax_paged.paged_gather_kv(
        jnp.asarray(kq), jnp.asarray(tables), jnp.asarray(ks)))
    got_g = paged_gather_kv(torch.from_numpy(kq), torch.from_numpy(tables),
                            torch.from_numpy(ks))
    assert got_g.dtype == torch.float32 and got_g.shape == (3, 12, 2, 64)
    np.testing.assert_allclose(got_g.numpy(), want_g, **ATTN_TOL)
    args = [jnp.asarray(a) for a in (q, kq, vq, tables, lengths)]
    want = np.asarray(jax_paged.paged_decode_attention_reference(
        *args, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    want_d = np.asarray(jax_paged.paged_decode_attention(
        *args, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    targs = [torch.from_numpy(a) for a in (q, kq, vq, tables, lengths)]
    sc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    got = paged_decode_attention_reference(*targs, **sc)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    np.testing.assert_allclose(got.numpy(), want_d, **ATTN_TOL)
    assert not got[2].any()                      # an empty slot reads 0


def test_int8_pool_without_scales_raises():
    """No silent cast: the decode wrapper refuses an int8 pool, and any
    pool of another dtype than q's; the int8 pool is read through the
    plain version with its scales."""
    rng = np.random.RandomState(6)
    kq, vq, ks, vs = (torch.from_numpy(a) for a in _int8_pools(rng))
    q = torch.randn(1, 2, 64)
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    lengths = torch.tensor([5], dtype=torch.int32)
    with pytest.raises(ValueError, match="an int8 pool is read through"):
        paged_decode_attention(q, kq, vq, tables, lengths)
    with pytest.raises(ValueError, match="do not fit q of torch.float32"):
        paged_decode_attention(q, kq.double(), vq.double(), tables, lengths)


# ---------------------------------------------------------------------------
# the LM forward over the 7-tuple int8 cache
# ---------------------------------------------------------------------------

B, BS, NBLK = 2, 16, 6
L, H, DH = KW["num_layers"], KW["num_heads"], KW["hidden_size"] // 2


def _int8_cache(rng):
    x = rng.randn(L, NBLK, BS, H, DH).astype(np.float32)
    y = rng.randn(L, NBLK, BS, H, DH).astype(np.float32)
    kq, ks = _jax_quantize(x)
    vq, vs = _jax_quantize(y)
    return [kq, vq, ks, vs]


@pytest.mark.parametrize("c", [1, 5])
def test_lm_forward_over_int8_cache_matches_jax(pair, c):
    """Rows of C tokens from positions 9 and 29 (C = 5 crosses into the
    slot's third block): logits [B, C, V] at 1e-5; every int8 row and
    scale written equals, bitwise, JAX's quantization of the port's own
    K/V rows, and nothing else in the pools moves.  The two models' K/V
    rows differ in their last bits (their projections sum in other
    orders), so the rows JAX writes are held to within one int8 step
    and their scales to 1e-5."""
    jm, tm = pair
    rng = np.random.RandomState(7)
    ids = rng.randint(0, KW["vocab_size"], (B, c)).astype(np.int64)
    start = np.array([9, 29], np.int32)
    pos = (start[:, None] + np.arange(c)[None]).astype(np.int64)
    tables = np.array([[3, 1, 0], [4, 2, 5]], np.int32)
    cache = _int8_cache(rng)

    def run():
        lg, arrs = jm(dygraph.to_variable(ids), dygraph.to_variable(pos),
                      caches=tuple(jnp.asarray(a) for a in cache),
                      cache_positions=jnp.asarray(start),
                      block_tables=jnp.asarray(tables), block_size=BS)
        return np.asarray(lg.numpy()), [np.asarray(a) for a in arrs]

    want, wcache = _jax_run(jm, run)
    tc = [torch.from_numpy(a.copy()) for a in cache]
    kv_rows = []
    attn = [blk.attn for blk in tm.blocks]
    hooks = [a.qkv_proj.register_forward_hook(
        lambda m, i, o: kv_rows.append(o.detach().clone())) for a in attn]
    try:
        with torch.inference_mode():
            got, arrs = tm(torch.from_numpy(ids), torch.from_numpy(pos),
                           caches=tuple(tc),
                           cache_positions=torch.from_numpy(start),
                           block_tables=torch.from_numpy(tables),
                           block_size=BS)
    finally:
        for hk in hooks:
            hk.remove()
    assert len(arrs) == 4 and all(a is b for a, b in zip(arrs, tc))
    assert arrs[0].dtype == torch.int8 and arrs[2].dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    p = start[:, None] + np.arange(c)[None]
    bi, off = tables[np.arange(B)[:, None], p // BS], p % BS
    d = KW["hidden_size"]
    for li, qkv in enumerate(kv_rows):
        k_rows = qkv[..., d:2 * d].reshape(B, c, H, DH).numpy()
        v_rows = qkv[..., 2 * d:].reshape(B, c, H, DH).numpy()
        for rows, pool, sc in ((k_rows, 0, 2), (v_rows, 1, 3)):
            wq, ws = _jax_quantize(rows)
            np.testing.assert_array_equal(tc[pool][li].numpy()[bi, off], wq)
            np.testing.assert_array_equal(tc[sc][li].numpy()[bi, off], ws)
    for got_a, want_a, before in zip(tc, wcache, cache):
        mask = np.ones(got_a.shape[:3], bool)
        mask[:, bi, off] = False
        np.testing.assert_array_equal(got_a.numpy()[mask], before[mask])
        np.testing.assert_array_equal(want_a[mask], before[mask])
        if got_a.dtype == torch.int8:
            # JAX quantizes its own rows: within one step of the port's
            diff = np.abs(got_a.numpy()[:, bi, off].astype(np.int32)
                          - want_a[:, bi, off].astype(np.int32))
            assert diff.max() <= 1
        else:
            np.testing.assert_allclose(got_a.numpy()[:, bi, off],
                                       want_a[:, bi, off], rtol=1e-5)


def test_int8_rows_past_the_table_go_to_the_garbage_block(pair):
    """Rows at ``p >= max_blocks * bs`` land in block 0, in the int8
    pools and in the scales; no real block takes a write outside the
    chunk's own positions."""
    _, tm = pair
    rng = np.random.RandomState(8)
    tc = [torch.from_numpy(a) for a in _int8_cache(rng)]
    before = [a.clone() for a in tc]
    tables = torch.tensor([[2, 1]], dtype=torch.int32)      # 32 positions
    with torch.inference_mode():
        tm(torch.arange(6)[None], torch.arange(28, 34)[None],
           caches=tuple(tc),
           cache_positions=torch.tensor([28], dtype=torch.int32),
           block_tables=tables, block_size=BS)
    # positions 28..31 are rows 12..15 of block 1; 32, 33 -> block 0
    for pool, old in zip(tc, before):
        assert torch.equal(pool[:, 2], old[:, 2])
        assert torch.equal(pool[:, 3:], old[:, 3:])
        assert torch.equal(pool[:, 1, :12], old[:, 1, :12])
        assert not torch.equal(pool[:, 1, 12:], old[:, 1, 12:])
        assert not torch.equal(pool[:, 0, :2], old[:, 0, :2])
        assert torch.equal(pool[:, 0, 2:], old[:, 0, 2:])


# ---------------------------------------------------------------------------
# PagedKVCache
# ---------------------------------------------------------------------------


def test_paged_cache_int8_layout_and_bytes():
    kw = dict(num_layers=2, num_blocks=9, block_size=16, num_heads=4,
              head_dim=64, slots=3, max_len=64, device="cpu")
    f32 = kv_cache.PagedKVCache(**kw)
    i8 = kv_cache.PagedKVCache(kv_dtype="int8", **kw)
    assert i8.quantized and not f32.quantized
    assert len(i8.arrays()) == 4 and len(f32.arrays()) == 2
    k, v, ks, vs = i8.arrays()
    assert k.shape == v.shape == (2, 9, 16, 4, 64)
    assert ks.shape == vs.shape == (2, 9, 16, 4)
    assert k.dtype == v.dtype == torch.int8
    assert ks.dtype == vs.dtype == torch.float32
    assert i8.nbytes == 2 * 2 * 9 * 16 * 4 * 64 + 2 * 2 * 9 * 16 * 4 * 4
    assert i8.nbytes / f32.nbytes == (64 + 4) / (4 * 64)
    d = i8.describe()
    assert d["kv_dtype"] == "int8" and d["bytes"] == i8.nbytes
    assert f32.describe()["kv_dtype"] == "torch.float32"
    want = jax_gen.PagedKVCache(2, 9, 16, 4, 64, 3, 64, kv_dtype="int8")
    assert i8.nbytes == want.nbytes
    with pytest.raises(ValueError, match="kv_dtype must be None or 'int8'"):
        kv_cache.PagedKVCache(kv_dtype="fp8", **kw)


# ---------------------------------------------------------------------------
# the int8 engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs", [{}, {"prefix_cache": True,
                                        "prefill_chunk": 4}],
                         ids=["plain", "prefix_chunk4"])
def test_int8_engine_greedy_and_logprobs_equal_jax(pair, knobs):
    jm, tm = pair
    reqs = mixed_requests(jax_gen, 6)
    if knobs:
        # a shared 33-token prefix: two full blocks for the prefix cache
        sysp = list(np.random.RandomState(5).randint(0, 128, 33))
        for r in reqs:
            r.prompt_ids = sysp + r.prompt_ids[:6]
    jeng = make_engine(jm, jax_gen, kv_dtype="int8", logprobs=True, **knobs)
    want, jh = serve(jeng, reqs)
    treqs = [gen.GenerationRequest(r.prompt_ids, r.max_new_tokens,
                                   request_id=r.request_id) for r in reqs]
    eng = make_engine(tm, kv_dtype="int8", logprobs=True, **knobs)
    got, th = serve(eng, treqs)
    # the JAX requests alternate greedy and sampled; the port's are all
    # greedy, so compare the greedy ones
    for i in range(0, len(reqs), 2):
        assert got[i] == want[i]
        np.testing.assert_allclose(th[i].logprobs(), jh[i].logprobs(),
                                   **TOL)
    assert eng.cache.describe()["kv_dtype"] == "int8"
    assert eng.stats().get("prefix_cache") == \
        jeng.stats().get("prefix_cache")
    if knobs:
        assert eng.stats()["prefix_cache"]["hits"] >= 1
        eng._prefix.evict(eng.cache.num_blocks - 1)
    assert eng.cache.pool.used_blocks == 0


def test_int8_streams_equal_sequential_oracle(pair):
    """Every stream, sampled ones too, equals a fresh int8 engine's
    serving the request alone."""
    _, tm = pair
    reqs = mixed_requests(gen, 7)
    got, handles = serve(make_engine(tm, kv_dtype="int8"), reqs)
    assert got == gen.sequential_oracle(
        lambda: make_engine(tm, kv_dtype="int8"), reqs)
    assert all(h.finish_reason == "max_new_tokens" for h in handles)


def test_int8_opt_in_smoke(pair):
    """The reference's smoke check: full-length streams, an int8 pool
    and its scales, under half the f32 engine's bytes; the whole-prompt
    prefill writes the flash forward's rows quantized."""
    _, tm = pair
    reqs = mixed_requests(gen, 5)
    eng = make_engine(tm, kv_dtype="int8")
    got, _ = serve(eng, reqs)
    assert [len(t) for t in got] == [r.max_new_tokens for r in reqs]
    f32 = make_engine(tm)
    assert eng.cache.nbytes < f32.cache.nbytes / 2
    prompt = reqs[0].prompt_ids
    tables = []
    for e in (eng, f32):
        h = e.submit(gen.GenerationRequest(prompt, max_new_tokens=3))
        e.step()
        slot = next(s for s, st in enumerate(e._slot_state)
                    if st is not None and st.handle is h)
        tables.append(torch.from_numpy(e.cache.table_row(slot)[None]))
    n = len(prompt)
    for li in range(L):
        for pool, sc, fpool in ((eng.cache.k, eng.cache.k_scale, f32.cache.k),
                                (eng.cache.v, eng.cache.v_scale,
                                 f32.cache.v)):
            rows = paged_gather_kv(fpool[li], tables[1])[0, :n]
            deq = paged_gather_kv(pool[li], tables[0], sc[li])[0, :n]
            amax = rows.abs().amax(-1, keepdim=True)
            assert torch.all((deq - rows).abs() <= amax / 127 + 1e-6)
    for e in (eng, f32):
        e.run_until_idle()
