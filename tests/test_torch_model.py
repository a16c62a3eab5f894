"""`paddle_tpu_torch.models` (and the sampling / KV-cache bookkeeping
the engine builds on) held against `paddle_tpu` on the CPU.

A TransformerLM at hidden 128, 2 heads (head dim 64), 2 layers, vocab
128 is built by the JAX package, its parameters carried across with
`from_jax_state_dict`, and the same numpy inputs go through both:
full-forward logits, the prefill K/V, one dense and one paged decode
step.  Tolerance atol 1e-4, rtol 1e-4: the JAX side runs its matmuls at
``highest`` precision (tests/conftest.py), the two frameworks sum in
another order, and the error grows through two layers and the tied
vocab projection.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph, framework
from paddle_tpu_torch import models
from paddle_tpu_torch.generation import kv_cache, sampling

jax_gen = paddle_tpu.generation
TOL = dict(atol=1e-4, rtol=1e-4)
KW = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
          intermediate_size=256, max_position_embeddings=128, dropout=0.0)
B, S, T, BS = 2, 12, 32, 16


@pytest.fixture(scope="module")
def pair():
    """(jax model, torch model) with the same weights."""
    with dygraph.guard():
        np.random.seed(0)
        jm = jax_models.TransformerLM(jax_models.TransformerLMConfig(**KW))
    params = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = models.TransformerLM(models.TransformerLMConfig(**KW),
                              device="cpu").eval()
    tm.load_state_dict(models.from_jax_state_dict(params))
    return jm, tm


def _jax_run(jm, fn):
    with dygraph.guard():
        framework._dygraph_tracer.train_mode = False
        for vb in jm.state_dict().values():
            framework._dygraph_tracer.register_var(vb)
        return fn()


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _ids():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, KW["vocab_size"], (B, S)).astype(np.int64)
    pos = np.tile(np.arange(S, dtype=np.int64), (B, 1))
    return ids, pos


def test_full_forward_logits_match(pair):
    jm, tm = pair
    ids, pos = _ids()
    want = _jax_run(jm, lambda: _np(jm(dygraph.to_variable(ids),
                                       dygraph.to_variable(pos))))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(pos)).numpy()
    assert got.shape == (B, S, KW["vocab_size"])
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_kv_matches(pair):
    jm, tm = pair
    ids, pos = _ids()

    def run():
        lg, kvs = jm(dygraph.to_variable(ids), dygraph.to_variable(pos),
                     use_cache=True)
        return _np(lg), [(_np(k), _np(v)) for k, v in kvs]

    want_logits, want_kvs = _jax_run(jm, run)
    with torch.no_grad():
        logits, kvs = tm(torch.from_numpy(ids), torch.from_numpy(pos),
                         use_cache=True)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    assert len(kvs) == KW["num_layers"]
    for (k, v), (wk, wv) in zip(kvs, want_kvs):
        assert tuple(k.shape) == (B, S, 2, 64)
        np.testing.assert_allclose(k.numpy(), wk, **TOL)
        np.testing.assert_allclose(v.numpy(), wv, **TOL)


def _prefilled_stacks(jm):
    """Dense [L, B, T, H, Dh] stacks holding the JAX prefill of the
    first S - 1 tokens, so both sides decode from the same cache."""
    ids, pos = _ids()

    def run():
        _, kvs = jm(dygraph.to_variable(ids[:, :S - 1]),
                    dygraph.to_variable(pos[:, :S - 1]), use_cache=True)
        return [(_np(k), _np(v)) for k, v in kvs]

    kvs = _jax_run(jm, run)
    shape = (KW["num_layers"], B, T, 2, 64)
    k_stack, v_stack = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for li, (k, v) in enumerate(kvs):
        k_stack[li, :, :S - 1] = k
        v_stack[li, :, :S - 1] = v
    return ids, k_stack, v_stack


def test_dense_decode_step_matches(pair):
    jm, tm = pair
    ids, k_stack, v_stack = _prefilled_stacks(jm)
    last = ids[:, S - 1:S]
    at = np.full((B, 1), S - 1, np.int64)
    cpos = np.full(B, S - 1, np.int32)

    def run():
        lg, (k2, v2) = jm(dygraph.to_variable(last), dygraph.to_variable(at),
                          caches=(jnp.asarray(k_stack), jnp.asarray(v_stack)),
                          cache_positions=jnp.asarray(cpos))
        return _np(lg), _np(k2), _np(v2)

    want, wk, wv = _jax_run(jm, run)
    kc, vc = torch.from_numpy(k_stack.copy()), torch.from_numpy(v_stack.copy())
    with torch.no_grad():
        got, (k2, v2) = tm(torch.from_numpy(last), torch.from_numpy(at),
                           caches=(kc, vc),
                           cache_positions=torch.from_numpy(cpos))
    assert k2 is kc                                  # updated in place
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(k2.numpy(), wk, **TOL)
    np.testing.assert_allclose(v2.numpy(), wv, **TOL)


def test_paged_decode_step_matches(pair):
    """The dense prefill rows scattered into a shuffled block pool; one
    decode step through the table on both sides, and the new K/V row
    lands in the same pool block."""
    jm, tm = pair
    ids, k_stack, v_stack = _prefilled_stacks(jm)
    mb = T // BS
    nb = B * mb + 1
    tables = np.array([[3, 1], [4, 2]], np.int32)
    shape = (KW["num_layers"], nb, BS, 2, 64)
    k_pool, v_pool = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for n in range(B):
        for j in range(mb):
            rows = slice(j * BS, (j + 1) * BS)
            k_pool[:, tables[n, j]] = k_stack[:, n, rows]
            v_pool[:, tables[n, j]] = v_stack[:, n, rows]
    last = ids[:, S - 1:S]
    at = np.full((B, 1), S - 1, np.int64)
    cpos = np.full(B, S - 1, np.int32)

    def run():
        lg, (k2, v2) = jm(dygraph.to_variable(last), dygraph.to_variable(at),
                          caches=(jnp.asarray(k_pool), jnp.asarray(v_pool)),
                          cache_positions=jnp.asarray(cpos),
                          block_tables=jnp.asarray(tables), block_size=BS)
        return _np(lg), _np(k2), _np(v2)

    want, wk, wv = _jax_run(jm, run)
    kc, vc = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    with torch.no_grad():
        got, (k2, v2) = tm(torch.from_numpy(last), torch.from_numpy(at),
                           caches=(kc, vc),
                           cache_positions=torch.from_numpy(cpos),
                           block_tables=torch.from_numpy(tables),
                           block_size=BS)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(k2.numpy(), wk, **TOL)
    np.testing.assert_allclose(v2.numpy(), wv, **TOL)
    assert np.any(k2.numpy()[0, tables[0, 0], S - 1] != 0)


def test_init_params_has_the_jax_keys_and_layout(pair):
    jm, _ = pair
    want = {k: tuple(np.asarray(v.numpy()).shape)
            for k, v in jm.state_dict().items()}
    got = models.init_params(models.TransformerLMConfig(**KW), seed=7)
    assert {k: v.shape for k, v in got.items()} == want
    again = models.init_params(models.TransformerLMConfig(**KW), seed=7)
    assert all(np.array_equal(got[k], again[k]) for k in got)
    sd = models.from_jax_state_dict(got)
    assert tuple(sd["blocks.0.attn.qkv_proj.weight"].shape) == (384, 128)
    assert np.array_equal(sd["blocks.0.fc1.weight"].numpy(),
                          got["blocks.0.fc1.weight"].T)


def test_tiny_config_matches_jax():
    a, b = models.TransformerLMConfig.tiny(), \
        jax_models.TransformerLMConfig.tiny()
    assert vars(a) == vars(b)
    assert vars(models.TransformerLMConfig()) == \
        vars(jax_models.TransformerLMConfig())


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def test_token_logprobs_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    toks = np.array([0, 7, 49, 3])
    want = jax_gen.sampling.token_logprobs(jnp.asarray(logits),
                                           jnp.asarray(toks))
    got = sampling.token_logprobs(torch.from_numpy(logits),
                                  torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _support(logits, t, k, p):
    """The token set top-k then top-p leaves (numpy, as JAX masks)."""
    s = logits / t
    if k > 0:
        s = np.where(s < np.sort(s)[::-1][k - 1], -1e30, s)
    srt = np.sort(s)[::-1]
    e = np.exp(srt - srt.max())
    probs = e / e.sum()
    keep = (np.cumsum(probs) - probs) < p
    keep[0] = True
    thresh = srt[keep].min()
    return set(np.nonzero(s >= thresh)[0]) if p < 1 else \
        set(np.nonzero(s > -1e29)[0])


def test_sampling_greedy_rows_argmax_and_draws_stay_in_support():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 64)).astype(np.float32) * 3
    temp, top_k, top_p = [0.0, 0.8, 1.0], [0, 5, 0], [1.0, 1.0, 0.7]
    supports = [None] + [_support(logits[i], temp[i], top_k[i], top_p[i])
                         for i in (1, 2)]
    seen = [set(), set(), set()]
    for step in range(40):
        out = sampling.sample_tokens(torch.from_numpy(logits), [1, 2, 3],
                                     [step] * 3, temp, top_k, top_p)
        for i in range(3):
            seen[i].add(int(out[i]))
    assert seen[0] == {int(np.argmax(logits[0]))}
    assert seen[1] <= supports[1] and len(seen[1]) > 1
    assert seen[2] <= supports[2] and len(seen[2]) > 1


def test_sampled_token_depends_only_on_seed_and_step():
    rng = np.random.default_rng(6)
    row = rng.standard_normal(64).astype(np.float32)
    other = rng.standard_normal(64).astype(np.float32)
    alone = sampling.sample_tokens(torch.from_numpy(row[None]), [9], [4],
                                   [0.9], [0], [1.0])
    batch = sampling.sample_tokens(torch.from_numpy(np.stack([other, row])),
                                   [1, 9], [0, 4], [0.0, 0.9], [0, 0],
                                   [1.0, 1.0])
    assert int(alone[0]) == int(batch[1])


# ---------------------------------------------------------------------------
# KV-cache bookkeeping
# ---------------------------------------------------------------------------


def test_block_pool_allocates_like_jax():
    """The same alloc / free script yields the same block ids: lowest
    free first, block 0 pinned."""
    ours, theirs = kv_cache.BlockPool(9), jax_gen.kv_cache.BlockPool(9)
    rng = np.random.default_rng(0)
    held = []
    for _ in range(30):
        if held and rng.random() < 0.4:
            ids = held.pop(int(rng.integers(len(held))))
            assert ours.decref(ids) == theirs.decref(ids)
        else:
            n = int(rng.integers(1, 3))
            if n > ours.free_blocks:
                with pytest.raises(kv_cache.PoolExhausted):
                    ours.alloc(n)
                continue
            a, b = ours.alloc(n), theirs.alloc(n)
            assert a == list(b) and 0 not in a
            held.append(a)
        assert ours.free_blocks == theirs.free_blocks
    with pytest.raises(ValueError):
        ours.decref([0])


def test_paged_cache_shapes_and_table():
    c = kv_cache.PagedKVCache(2, 9, 16, 2, 64, slots=3, max_len=40,
                              device="cpu")
    assert c.shape == (2, 9, 16, 2, 64)
    assert c.max_blocks_per_slot == 3 and c.capacity_tokens == 128
    assert c.blocks_for(17) == 2
    c.assign(1, 0, 5)
    assert c.table_row(1).tolist() == [5, 0, 0]
    c.clear_slot(1)
    assert not c.block_tables.any()
    with pytest.raises(NotImplementedError):
        kv_cache.PagedKVCache(2, 9, 16, 2, 64, slots=3, max_len=40,
                              kv_dtype="int8", device="cpu")
