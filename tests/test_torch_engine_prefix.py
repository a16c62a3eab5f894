"""The generation engine's prefix cache, chunked prefill and logprobs in
`paddle_tpu_torch`, on the CPU, held against the JAX package and against
the port's own sequential oracle.

* `chunked_attention_reference` equals the JAX one (C = 1 and 5, mixed
  starts, ``n_real``, dead rows) at 1e-6, and garbage past every row's
  limit does not reach the output;
* the TransformerLM forward with C > 1 rows over dense and paged caches
  equals JAX's, logits and written caches, at 1e-5;
* one lookup / register / evict script drives both `PrefixCache`s to
  the same block ids, refcounts and statistics;
* greedy streams and logprobs of ``prefill_chunk=4`` and of
  ``prefix_cache=True`` equal the JAX engine's with the same knobs, with
  the same prefix statistics; chunked streams, sampled ones too, equal
  the port's `sequential_oracle`;
* a pool too small for prefix + chunk traffic preempts a slot mid-chunk
  and still completes every request;
* a prefix hit whose padded suffix runs past ``max_len`` and the
  model's last position id leaves the real rows equal to a whole-prompt
  prefill, with every index in range.

Tiny sizes as tests/test_torch_engine.py (hidden 128, 2 heads of 64, 2
layers, vocab 128).
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
from paddle_tpu_torch.ops import (chunked_attention_reference,
                                  decode_attention_reference, paged_gather_kv)

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


def system_prompt_requests(module, n=6):
    """A shared 33-token system prompt (two full blocks of 16) and a
    private suffix of 1-6 tokens; greedy and sampled alternate."""
    rng = np.random.RandomState(5)
    sysp = list(rng.randint(0, KW["vocab_size"], 33))
    reqs = []
    for i in range(n):
        suffix = list(rng.randint(0, KW["vocab_size"],
                                  int(rng.randint(1, 7))))
        sp = (module.SamplingParams.greedy() if i % 2 == 0 else
              module.SamplingParams(temperature=0.9, top_k=20, top_p=0.9,
                                    seed=200 + i))
        reqs.append(module.GenerationRequest(
            sysp + suffix, max_new_tokens=5 + (i % 3), sampling=sp,
            request_id="s%d" % i))
    return reqs


def mixed_requests(module, n, max_new=6, lo=2, hi=30):
    rng = np.random.RandomState(1)
    reqs = []
    for i in range(n):
        prompt = rng.randint(0, KW["vocab_size"], int(rng.randint(lo, hi)))
        sp = (module.SamplingParams.greedy() if i % 2 == 0 else
              module.SamplingParams(temperature=0.9, top_k=20, top_p=0.9,
                                    seed=100 + i))
        reqs.append(module.GenerationRequest(
            prompt, max_new_tokens=max_new + (i % 3), sampling=sp,
            request_id="m%d" % i))
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


# ---------------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [1, 5])
def test_chunked_attention_matches_jax(c):
    """Starts mid-cache, at 0, at the end, and negative (its first rows,
    or the only row at C = 1, see nothing and return 0)."""
    rng = np.random.RandomState(2)
    n, t, h, d = 4, 24, 2, 64
    q = rng.randn(n, c, h, d).astype(np.float32)
    k = rng.randn(n, t, h, d).astype(np.float32)
    v = rng.randn(n, t, h, d).astype(np.float32)
    start = np.array([7, 0, t - c, -3 if c > 1 else -1], np.int32)
    want = np.asarray(jax_paged.chunked_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(start),
        n_real=3))
    got = chunked_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(start), n_real=3).numpy()
    np.testing.assert_allclose(got, want, **ATTN_TOL)
    dead = start[-1] + np.arange(c) < 0
    assert dead.any() and not got[-1][dead].any()
    if c == 1:
        dec = decode_attention_reference(
            torch.from_numpy(q[:, 0]), torch.from_numpy(k),
            torch.from_numpy(v), torch.from_numpy(start + 1))
        np.testing.assert_allclose(got[:, 0], dec.numpy(), **ATTN_TOL)


def test_chunked_attention_ignores_garbage_past_the_limits():
    """A gathered view past every row's limit may hold inf or NaN (the
    garbage block): a masked weight is 0, and the output stays that of
    clean data."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 4, 2, 64).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 16, 2, 64).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 16, 2, 64).astype(np.float32))
    start = torch.tensor([3, 9], dtype=torch.int32)
    want = chunked_attention_reference(q, k, v, start)
    kg, vg = k.clone(), v.clone()
    kg[0, 7:], vg[0, 7:] = float("inf"), float("nan")
    kg[1, 13:], vg[1, 13:] = float("nan"), float("inf")
    got = chunked_attention_reference(q, kg, vg, start)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the C > 1 forward over a cache
# ---------------------------------------------------------------------------

B, C, T, BS = 2, 5, 32, 16
L, H, DH = KW["num_layers"], KW["num_heads"], KW["hidden_size"] // 2


def _chunk_inputs():
    rng = np.random.RandomState(4)
    ids = rng.randint(0, KW["vocab_size"], (B, C)).astype(np.int64)
    start = np.array([9, 20], np.int32)
    pos = (start[:, None] + np.arange(C)[None]).astype(np.int64)
    shape = (L, B, T, H, DH)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    return ids, pos, start, k, v


@pytest.mark.parametrize("paged", [False, True])
def test_lm_forward_with_chunk_rows_matches_jax(pair, paged):
    """Two rows of 5 tokens from positions 9 and 20 (row 1's chunk
    crosses a block edge): logits [B, C, V] and every cache row written,
    against the JAX model on the same caches."""
    jm, tm = pair
    ids, pos, start, k, v = _chunk_inputs()
    kw_np, kw_t = {}, {}
    if paged:
        tables = np.array([[3, 1], [4, 2]], np.int32)
        nb = B * (T // BS) + 1
        pk = np.zeros((L, nb, BS, H, DH), np.float32)
        pv = np.zeros_like(pk)
        for n in range(B):
            for j in range(T // BS):
                pk[:, tables[n, j]] = k[:, n, j * BS:(j + 1) * BS]
                pv[:, tables[n, j]] = v[:, n, j * BS:(j + 1) * BS]
        k, v = pk, pv
        kw_np = dict(block_tables=jnp.asarray(tables), block_size=BS)
        kw_t = dict(block_tables=torch.from_numpy(tables), block_size=BS)

    def run():
        lg, (k2, v2) = jm(dygraph.to_variable(ids), dygraph.to_variable(pos),
                          caches=(jnp.asarray(k), jnp.asarray(v)),
                          cache_positions=jnp.asarray(start), **kw_np)
        return np.asarray(lg.numpy()), np.asarray(k2), np.asarray(v2)

    want, wk, wv = _jax_run(jm, run)
    kc, vc = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    with torch.inference_mode():
        got, (k2, v2) = tm(torch.from_numpy(ids), torch.from_numpy(pos),
                           caches=(kc, vc),
                           cache_positions=torch.from_numpy(start), **kw_t)
    assert got.shape == (B, C, KW["vocab_size"]) and k2 is kc
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(k2.numpy(), wk, **TOL)
    np.testing.assert_allclose(v2.numpy(), wv, **TOL)
    assert np.any(k2.numpy() != k)


def test_paged_rows_past_the_table_go_to_the_garbage_block(pair):
    """Rows at ``p >= max_blocks * bs`` land in block 0; no real block
    takes a write outside the chunk's own positions."""
    _, tm = pair
    tables = torch.tensor([[2, 1]], dtype=torch.int32)      # 32 positions
    shape = (L, 3, BS, H, DH)
    kp = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    vp = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    k0, v0 = kp.clone(), vp.clone()
    ids = torch.arange(6)[None]
    with torch.inference_mode():
        tm(ids, torch.arange(28, 34)[None], caches=(kp, vp),
           cache_positions=torch.tensor([28], dtype=torch.int32),
           block_tables=tables, block_size=BS)
    # positions 28..31 are rows 12..15 of block 1; 32, 33 -> block 0
    for pool, before in ((kp, k0), (vp, v0)):
        assert torch.equal(pool[:, 2], before[:, 2])
        assert torch.equal(pool[:, 1, :12], before[:, 1, :12])
        assert not torch.equal(pool[:, 1, 12:], before[:, 1, 12:])
        assert not torch.equal(pool[:, 0, :2], before[:, 0, :2])
        assert torch.equal(pool[:, 0, 2:], before[:, 0, 2:])


# ---------------------------------------------------------------------------
# PrefixCache
# ---------------------------------------------------------------------------


def _prefix_script(module):
    """One script of registers, lookups, releases and evictions; returns
    what it observed at each point."""
    pool = module.BlockPool(10)
    pc = module.PrefixCache(pool, 4)
    seen = []

    def snap(tag, extra=None):
        seen.append((tag, extra, [pool.refcount(b) for b in range(10)],
                     pool.free_blocks, len(pc), pc.stats()))

    a, b = list(range(100, 112)), list(range(100, 108)) + [7, 7, 7, 7, 5]
    blocks_a = pool.alloc(3)
    pc.register(a, blocks_a)
    snap("register a", blocks_a)
    n, got = pc.lookup(a)
    snap("lookup a", (n, got))
    blocks_b = got + pool.alloc(2)
    pc.register(b, blocks_b)
    snap("register b", blocks_b)
    snap("lookup miss", pc.lookup([1, 2, 3, 4, 5]))
    snap("lookup short", pc.lookup([100, 101, 102]))
    pool.decref(blocks_a)
    pool.decref(blocks_b)
    snap("released")
    snap("lookup b", pc.lookup(b + [9]))
    snap("evict 8", pc.evict(8))
    pool.decref(seen[-2][1][1])
    snap("evict all", pc.evict(9))
    return seen


def test_prefix_cache_script_matches_jax():
    want = _prefix_script(jax_gen)
    got = _prefix_script(gen)
    assert got == want
    assert got[-1][2][1:] == [0] * 9 and got[-1][4] == 0


# ---------------------------------------------------------------------------
# the engine against the JAX engine and against the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs", [{"prefill_chunk": 4},
                                   {"prefix_cache": True}],
                         ids=["chunk4", "prefix"])
def test_greedy_streams_and_logprobs_equal_jax_engine(pair, knobs):
    jm, tm = pair
    jeng = make_engine(jm, jax_gen, logprobs=True, **knobs)
    want, jh = serve(jeng, system_prompt_requests(jax_gen))
    eng = make_engine(tm, logprobs=True, **knobs)
    got, th = serve(eng, system_prompt_requests(gen))
    greedy = range(0, len(got), 2)
    assert [got[i] for i in greedy] == [want[i] for i in greedy]
    for i in greedy:
        np.testing.assert_allclose(th[i].logprobs(), jh[i].logprobs(),
                                   **TOL)
    assert all(len(s) == 5 + (i % 3) for i, s in enumerate(got))
    assert all(h.finish_reason == "max_new_tokens" for h in th)
    assert eng.stats().get("prefix_cache") == \
        jeng.stats().get("prefix_cache")
    if "prefix_cache" in knobs:
        st = eng.stats()["prefix_cache"]
        assert st["hits"] == 5 and st["hit_tokens"] == 5 * 32
        assert eng.cache.pool.used_blocks == st["entries"]
        eng._prefix.evict(eng.cache.num_blocks - 1)
    assert eng.cache.pool.used_blocks == 0


def test_whole_prompt_logprobs_equal_jax_and_events_carry_them(pair):
    """The flash prefill and decode paths' logprobs against JAX; a
    logprob engine's token events are 4-tuples holding them, and an
    engine without the knob keeps its 3-tuples and reports none."""
    jm, tm = pair
    want, jh = serve(make_engine(jm, jax_gen, logprobs=True),
                     mixed_requests(jax_gen, 3, hi=14))
    eng = make_engine(tm, logprobs=True)
    got, th = serve(eng, mixed_requests(gen, 3, hi=14))
    for i in (0, 2):
        assert got[i] == want[i]
        np.testing.assert_allclose(th[i].logprobs(), jh[i].logprobs(),
                                   **TOL)
    evs = [e for e in th[1].events(timeout=0) if e[0] == "token"]
    assert [len(e) for e in evs] == [4] * len(got[1])
    assert [e[3] for e in evs] == th[1].logprobs()
    assert all(lp <= 0.0 for lp in th[1].logprobs())
    plain, ph = serve(make_engine(tm), mixed_requests(gen, 3, hi=14))
    assert plain == got
    evs = [e for e in ph[1].events(timeout=0) if e[0] == "token"]
    assert [len(e) for e in evs] == [3] * len(plain[1])
    assert ph[1].logprobs() == []


def test_chunked_streams_equal_sequential_oracle(pair):
    """Every stream, sampled ones included, equals a fresh chunked
    engine's serving the request alone: the same chunk boundaries give
    the same shapes, and decode is row-independent."""
    _, tm = pair
    reqs = mixed_requests(gen, 7)
    eng = make_engine(tm, prefill_chunk=4)
    got, handles = serve(eng, reqs)
    assert got == gen.sequential_oracle(
        lambda: make_engine(tm, prefill_chunk=4), reqs)
    assert all(h.finish_reason == "max_new_tokens" for h in handles)
    assert eng.cache.pool.used_blocks == 0
    assert eng.occupancy()["chunking"] == 0


def test_small_pool_preempts_mid_chunk_and_completes(pair):
    """Block size 4, 12 usable blocks, prefix cache and 4-token chunks
    for 3 slots: the pool runs dry while a slot is mid-chunk, that slot
    (progress 0) is preempted, and every request still completes."""
    _, tm = pair
    eng = make_engine(tm, block_size=4, kv_blocks=13, prefix_cache=True,
                      prefill_chunk=4)
    mid_chunk = []
    preempt = eng._preempt_slot

    def watch(slot, why):
        mid_chunk.append(eng._chunking[slot] is not None)
        preempt(slot, why)

    eng._preempt_slot = watch
    reqs = mixed_requests(gen, 6, max_new=10, lo=12, hi=30)
    got, handles = serve(eng, reqs)
    assert any(mid_chunk) and eng.stats()["preempted"] == len(mid_chunk)
    assert all(h.finish_reason == "max_new_tokens" for h in handles)
    assert [len(s) for s in got] == [r.max_new_tokens for r in reqs]
    greedy = range(0, len(reqs), 2)
    plain, _ = serve(make_engine(tm), reqs)
    assert [got[i] for i in greedy] == [plain[i] for i in greedy]
    eng._prefix.evict(eng.cache.num_blocks - 1)
    assert eng.cache.pool.used_blocks == 0


def test_prefix_hit_past_max_len_keeps_real_rows(pair):
    """``max_len`` 64 = the model's positions, buckets [8, 16, 64]: a
    60-token prompt that hits 32 cached tokens prefills its 28-token
    suffix as one 64-row chunk, positions 32..95.  Rows past 64 go to
    the garbage block with their position ids clamped to 63; the real
    rows, the first tokens and their logprobs equal a whole-prompt
    prefill's."""
    _, tm32 = pair
    cfg = models.TransformerLMConfig(**dict(KW, max_position_embeddings=64))
    tm = models.TransformerLM(cfg, device="cpu")
    state = tm32.state_dict()
    state["position.weight"] = state["position.weight"][:64]
    tm.load_state_dict(state)
    rng = np.random.RandomState(6)
    a = list(rng.randint(0, 128, 40))
    b = a[:32] + list(rng.randint(0, 128, 28))
    kw = dict(slots=2, max_len=64, prefill_buckets=[8, 16, 64],
              logprobs=True)
    eng = make_engine(tm, prefix_cache=True, **kw)
    serve(eng, [gen.GenerationRequest(a, max_new_tokens=2)])
    hb = eng.submit(gen.GenerationRequest(b, max_new_tokens=4))
    ref = make_engine(tm, **kw)
    hr = ref.submit(gen.GenerationRequest(b, max_new_tokens=4))
    rows = {}
    for e, h in ((eng, hb), (ref, hr)):
        e.step()                      # prefill + one decode step
        slot = next(s for s, st in enumerate(e._slot_state)
                    if st is not None and st.handle is h)
        table = torch.from_numpy(e.cache.table_row(slot)[None])
        rows[id(e)] = [paged_gather_kv(p[li], table)[0, :61]
                       for p in e.cache.arrays() for li in range(L)]
        e.run_until_idle()
    assert eng.stats()["prefix_cache"]["hit_tokens"] == 32
    for x, y in zip(rows[id(eng)], rows[id(ref)]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)
    assert hb.result(0) == hr.result(0)
    np.testing.assert_allclose(hb.logprobs(0), hr.logprobs(0), **TOL)
