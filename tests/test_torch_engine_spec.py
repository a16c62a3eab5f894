"""Speculative decoding in `paddle_tpu_torch`'s generation engine, on the
CPU, held against the JAX engine and against the port's own engines.

* greedy streams and logprobs equal the JAX engine's with the same
  target, draft and ``draft_len=3``, f32 and int8 KV; the speculation
  counters (`stats()["speculative"]`: proposed and accepted) equal
  those of the JAX engine given the port's one extra draft step (which
  writes the last proposal's row, ROADMAP Queue C), and, with the
  reference's k draft steps, the JAX engine's own;
* greedy streams equal the port's dense engine's, and sampled streams
  the port's non-speculative engine's (a sampled slot takes row 0 of the
  verify only, sampled at its own step); every stream equals the
  speculative `sequential_oracle`;
* with the target as its own draft every proposal is accepted and the
  streams are the plain engine's;
* a stop token inside an accepted run ends the stream there; a slot
  within k + 1 of ``max_len`` takes plain steps and completes; a tight
  pool preempts (restart semantics, the draft re-prefilled) and still
  completes every request, with the pool drained.

Tiny sizes as tests/test_torch_engine_prefix.py: the target has hidden
128, 2 heads of 64, 2 layers, vocab 128; the draft vocab 128, hidden 64,
one head of 64, one layer, FFN 128, 128 positions.
"""

import numpy as np
import pytest

import paddle_tpu
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph
from paddle_tpu_torch import generation as gen
from paddle_tpu_torch import models

jax_gen = paddle_tpu.generation
KW = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
          intermediate_size=256, max_position_embeddings=128, dropout=0.0)
DRAFT_KW = dict(vocab_size=128, hidden_size=64, num_layers=1, num_heads=1,
                intermediate_size=128, max_position_embeddings=128,
                dropout=0.0)
BUCKETS = [8, 16, 40]
TOL = dict(atol=1e-5, rtol=1e-5)
K = 3


def _pair(kw, seed):
    with dygraph.guard():
        np.random.seed(seed)
        jm = jax_models.TransformerLM(jax_models.TransformerLMConfig(**kw))
    params = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = models.TransformerLM(models.TransformerLMConfig(**kw), device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(params))
    return jm, tm.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair(KW, 0)


@pytest.fixture(scope="module")
def draft():
    return _pair(DRAFT_KW, 3)


def make_engine(model, module=gen, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_buckets", BUCKETS)
    kw.setdefault("max_queue", 64)
    if module is gen:
        kw.setdefault("device", "cpu")
    return module.GenerationEngine(model, **kw)


def mixed_requests(module, n, max_new=8, lo=2, hi=30, greedy_only=False):
    rng = np.random.RandomState(1)
    reqs = []
    for i in range(n):
        prompt = rng.randint(0, KW["vocab_size"], int(rng.randint(lo, hi)))
        sp = (module.SamplingParams.greedy()
              if greedy_only or i % 2 == 0 else
              module.SamplingParams(temperature=0.9, top_k=20, top_p=0.9,
                                    seed=100 + i))
        reqs.append(module.GenerationRequest(
            prompt, max_new_tokens=max_new + (i % 3), sampling=sp,
            request_id="v%d" % i))
    return reqs


def serve(eng, reqs):
    handles = [eng.submit(r) for r in reqs]
    eng.run_until_idle()
    return [h.result(timeout=0) for h in handles], handles


class JaxDraftRowWritten(jax_gen.GenerationEngine):
    """The JAX engine with the port's k + 1 draft steps: after the k
    proposals of a speculative iteration, one more draft step writes
    the row of d_k, which the reference leaves unwritten."""

    def _spec_once(self):
        lengths, fn, outs = self._lengths.copy(), self._draft_decode_fn, []

        def record(*args):
            outs.append(fn(*args))
            return outs[-1]

        self._draft_decode_fn = record
        try:
            out = super()._spec_once()
        finally:
            self._draft_decode_fn = fn
        kd, vd, _ = fn(self._draft_params, *self._draft_cache.arrays(),
                       np.minimum(lengths + K, self.max_len - 1).astype(
                           np.int32), np.asarray(outs[-1][2]))
        self._draft_cache.update(kd, vd)
        return out


class ReferenceDraftSteps(gen.GenerationEngine):
    """The port's engine with the reference's k draft steps."""

    def _draft_propose(self):
        drafts = np.zeros((self.slots, self.draft_len), np.int64)
        cur = self._last_tokens
        for i in range(self.draft_len):
            cur = drafts[:, i] = self._draft_decode(
                np.minimum(self._lengths + i, self.max_len - 1), cur)
        return drafts


def self_draft(tm):
    """A second TransformerLM with the target's weights."""
    twin = models.TransformerLM(models.TransformerLMConfig(**KW),
                                device="cpu")
    twin.load_state_dict(tm.state_dict())
    return twin.eval()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_greedy_streams_logprobs_and_counters_equal_jax(pair, draft,
                                                        kv_dtype):
    jm, tm = pair
    jd, td = draft
    jeng = JaxDraftRowWritten(
        jm, slots=3, max_len=64, prefill_buckets=BUCKETS, draft_model=jd,
        draft_len=K, kv_dtype=kv_dtype, logprobs=True)
    want, jh = serve(jeng, mixed_requests(jax_gen, 6, greedy_only=True))
    eng = make_engine(tm, draft_model=td, draft_len=K, kv_dtype=kv_dtype,
                      logprobs=True)
    got, th = serve(eng, mixed_requests(gen, 6, greedy_only=True))
    assert got == want
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.logprobs(), b.logprobs(), **TOL)
    spec, jspec = eng.stats()["speculative"], jeng.stats()["speculative"]
    assert spec == jspec
    assert spec["draft_len"] == K and spec["proposed"] > 0
    assert 0 < spec["accepted"] < spec["proposed"]
    assert eng.cache.pool.used_blocks == 0


def test_reference_draft_steps_match_jax_counters(pair, draft):
    """Given the reference's k draft steps, the port's engine takes the
    JAX engine's decisions: the same streams and the same counters."""
    jm, tm = pair
    jd, td = draft
    jeng = make_engine(jm, jax_gen, draft_model=jd, draft_len=K)
    want, _ = serve(jeng, mixed_requests(jax_gen, 6, greedy_only=True))
    eng = ReferenceDraftSteps(tm, slots=3, max_len=64,
                              prefill_buckets=BUCKETS, draft_model=td,
                              draft_len=K, device="cpu")
    got, _ = serve(eng, mixed_requests(gen, 6, greedy_only=True))
    assert got == want
    assert eng.stats()["speculative"] == jeng.stats()["speculative"]
    assert eng.stats()["decode_steps"] == jeng.stats()["decode_steps"]


def test_greedy_equals_dense_and_sampled_equal_plain(pair, draft):
    """The reference's test_speculative_greedy_exact_vs_dense; and the
    sampled streams equal the non-speculative engine's."""
    _, tm = pair
    _, td = draft
    reqs = mixed_requests(gen, 7)
    eng = make_engine(tm, draft_model=td, draft_len=K)
    got, handles = serve(eng, reqs)
    dense, _ = serve(make_engine(tm, paged=False), reqs)
    plain, _ = serve(make_engine(tm), reqs)
    greedy = range(0, len(reqs), 2)
    assert [got[i] for i in greedy] == [dense[i] for i in greedy]
    assert got == plain
    assert all(h.finish_reason == "max_new_tokens" for h in handles)
    spec = eng.stats()["speculative"]
    assert spec["proposed"] > 0 and 0.0 <= spec["acceptance_rate"] <= 1.0


def test_streams_equal_speculative_sequential_oracle(pair, draft):
    _, tm = pair
    _, td = draft
    reqs = mixed_requests(gen, 6)

    def mk():
        return make_engine(tm, draft_model=td, draft_len=K)

    got, _ = serve(mk(), reqs)
    assert got == gen.sequential_oracle(mk, reqs)


def test_self_draft_accepts_everything(pair):
    """The target as its own draft: every greedy proposal is accepted
    (the accept-all path, lengths advancing by k + 1; the draft's cache
    holds every row the target's does), and the streams are the plain
    engine's."""
    _, tm = pair
    reqs = mixed_requests(gen, 6)
    eng = make_engine(tm, draft_model=self_draft(tm), draft_len=K)
    got, _ = serve(eng, reqs)
    plain, _ = serve(make_engine(tm), reqs)
    assert got == plain
    spec = eng.stats()["speculative"]
    assert spec["proposed"] > 0 and spec["acceptance_rate"] == 1.0
    # accept-all iterations: 8-10 greedy tokens in ceil((n - 1) / 4)
    assert eng.stats()["decode_steps"] < sum(r.max_new_tokens for r in reqs)


def test_stop_token_inside_an_accepted_run(pair):
    """With every proposal accepted an iteration emits tokens 1-4, 5-8,
    ...: a stop token at an index m that is not the last of its
    iteration arrives mid-accept and ends the stream there, as it ends
    the plain engine's.  The tiny model repeats tokens, so m is the
    first such index whose token is new to its stream."""
    _, tm = pair
    for r in mixed_requests(gen, 6):
        plain = make_engine(tm).generate([r.prompt_ids], max_new_tokens=12)[0]
        picks = [m for m in range(1, 12)
                 if m % (K + 1) and plain[m] not in plain[:m]]
        if picks:
            prompt, m = r.prompt_ids, picks[0]
            break
    eng = make_engine(tm, draft_model=self_draft(tm), draft_len=K)
    h = eng.submit(gen.GenerationRequest(prompt, max_new_tokens=12,
                                         stop_token_ids=[plain[m]]))
    eng.run_until_idle()
    assert h.result(0) == plain[:m + 1] and h.finish_reason == "stop_token"
    steps = eng.stats()["decode_steps"]
    assert steps == -(-m // (K + 1))
    spec = eng.stats()["speculative"]
    assert spec["proposed"] == spec["accepted"] == K * steps
    assert eng.cache.pool.used_blocks == 0


def test_slot_near_max_len_takes_plain_steps(pair, draft):
    """A 40-token prompt with 24 new tokens ends at max_len 64: the
    sampled slot advances one row an iteration, so from length 61 on no
    verify fits and the engine takes plain steps; both streams equal the
    plain engine's."""
    _, tm = pair
    _, td = draft
    rng = np.random.RandomState(9)
    reqs = [gen.GenerationRequest(
        rng.randint(0, 128, 40), max_new_tokens=24, sampling=sp,
        request_id="edge%d" % i) for i, sp in enumerate([
            gen.SamplingParams(temperature=0.9, top_k=20, seed=7),
            gen.SamplingParams.greedy()])]
    eng = make_engine(tm, draft_model=td, draft_len=K)
    viable = eng._spec_viable
    plain_steps = []

    def watch():
        ok = viable()
        if not ok and eng._active.any():
            plain_steps.append(eng._lengths[eng._active].max())
        return ok

    eng._spec_viable = watch
    got, handles = serve(eng, reqs)
    assert plain_steps and min(plain_steps) + K + 1 > 64
    want, _ = serve(make_engine(tm), reqs)
    assert got == want
    assert [len(s) for s in got] == [24, 24]
    assert all(h.finish_reason == "max_new_tokens" for h in handles)


def test_tight_pool_preempts_and_completes(pair, draft):
    """The reference's tiny-pool drill with a draft: 4 usable blocks
    cannot hold three 22-token sequences, so the engine preempts; every
    request completes at full length, equal to the dense engine's, and
    the pool drains."""
    _, tm = pair
    _, td = draft
    eng = make_engine(tm, draft_model=td, draft_len=K, kv_blocks=5,
                      block_size=16)
    reqs = [gen.GenerationRequest(list(range(1, 15)), max_new_tokens=8,
                                  request_id="tp%d" % i) for i in range(3)]
    got, _ = serve(eng, reqs)
    assert [len(t) for t in got] == [8, 8, 8]
    assert eng.stats()["preempted"] >= 1
    assert eng.cache.pool.used_blocks == 0
    dense, _ = serve(make_engine(tm, paged=False), reqs)
    assert got == dense
