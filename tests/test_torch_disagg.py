"""`paddle_tpu_torch.tp_serving`: the disaggregated prefill / decode pair
on the CPU, held against `paddle_tpu.tp_serving` (its
``TestDisaggregation``, tests/test_tp_serving.py) given the same
weights:

* a `DisaggPair`'s greedy streams equal the JAX pair's token for token,
  and every stream, sampled ones too, equals a single port engine's;
* the role pins: the decode engine never runs a prefill (its
  ``executables["prefill"]`` stay 0), the prefill engine never decodes;
* a handoff's ``describe()`` and ``nbytes`` equal the JAX handoff's, and
  its pages equal the JAX pages within f32 rounding;
* geometry, block size, kv dtype and a dense engine raise `ValueError`;
* an int8 pair hands over four pool arrays (int8 pages, f32 scales), and
  its streams equal a single int8 engine's and, greedy, the JAX int8
  pair's;
* `ShardGroupFleet` routes by headroom, ties to the lowest group id.
"""

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.tp_serving as jax_tps
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph
from paddle_tpu_torch import generation as gen
from paddle_tpu_torch import models
from paddle_tpu_torch import tp_serving as tps

jax_gen = paddle_tpu.generation
KW = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
          intermediate_size=256, max_position_embeddings=128, dropout=0.0)


@pytest.fixture(scope="module")
def pair_models():
    with dygraph.guard():
        np.random.seed(0)
        jm = jax_models.TransformerLM(jax_models.TransformerLMConfig(**KW))
    params = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = models.TransformerLM(models.TransformerLMConfig(**KW), device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(params))
    return jm, tm


def make_engine(model, module=gen, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_buckets", [8, 16])
    kw.setdefault("max_queue", 64)
    kw.setdefault("block_size", 16)
    kw.setdefault("kv_blocks", 14)
    if module is gen:
        kw.setdefault("device", "cpu")
    return module.GenerationEngine(model, **kw)


def make_pair(model, module=gen, tps_module=tps, **kw):
    return tps_module.DisaggPair(
        make_engine(model, module, slots=2, kv_blocks=10, **kw),
        make_engine(model, module, slots=3, kv_blocks=14, **kw),
        group_id=0)


def mixed_requests(module, n, max_new=6):
    """Mixed greedy / sampled traffic, prompts spanning both buckets (the
    reference test's)."""
    rng = np.random.RandomState(1)
    reqs = []
    for i in range(n):
        prompt = rng.randint(0, KW["vocab_size"], int(rng.randint(2, 14)))
        sp = (module.SamplingParams.greedy() if i % 2 == 0 else
              module.SamplingParams(temperature=0.9, top_k=20, top_p=0.9,
                                    seed=100 + i))
        reqs.append(module.GenerationRequest(
            prompt, max_new_tokens=max_new + (i % 3), sampling=sp,
            request_id="d%d" % i))
    return reqs


def serve_pair(pair, reqs):
    handles = [pair.submit(r) for r in reqs]
    pair.run_until_idle()
    return [h.result(timeout=0) for h in handles]


def serve_single(model, reqs, **kw):
    eng = make_engine(model, **kw)
    handles = [eng.submit(r) for r in reqs]
    eng.run_until_idle()
    return [h.result(timeout=0) for h in handles]


GREEDY = [0, 2, 4, 6]


def test_token_identity_and_role_pin(pair_models):
    jm, tm = pair_models
    want = serve_pair(make_pair(jm, jax_gen, jax_tps),
                      mixed_requests(jax_gen, 7))
    pair = make_pair(tm)
    got = serve_pair(pair, mixed_requests(gen, 7))
    assert [got[i] for i in GREEDY] == [want[i] for i in GREEDY]
    assert got == serve_single(tm, mixed_requests(gen, 7))
    dex = pair.decode.stats()["executables"]
    assert all(v == 0 for v in dex["prefill"].values()), dex
    assert dex["decode_step"] == 1
    pex = pair.prefill.stats()["executables"]
    assert pex["decode_step"] == 0
    assert sum(pex["prefill"].values()) >= 1
    st = pair.stats()
    assert st["handoffs"] == 7 and st["kv_transfer_bytes"] > 0
    assert st["roles"]["prefill"] != st["roles"]["decode"]
    assert st["prefill_executables"] == dex["prefill"]
    # every block went back to both pools
    assert pair.prefill.cache.pool.used_blocks == 0
    assert pair.decode.cache.pool.used_blocks == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_handoff_describe_nbytes_and_pages_equal_jax(pair_models, kv_dtype):
    jm, tm = pair_models
    kw = dict(kv_dtype=kv_dtype, prefill_buckets=[8, 16, 32])
    jeng, teng = make_engine(jm, jax_gen, **kw), make_engine(tm, **kw)
    prompt = [5, 9, 17, 33, 65, 1, 2, 3, 4, 7, 11, 13, 21, 34, 55, 89, 3, 8]
    jh = jeng.prefill_extract(jax_gen.GenerationRequest(
        prompt, max_new_tokens=2, request_id="h"))
    th = teng.prefill_extract(gen.GenerationRequest(
        prompt, max_new_tokens=2, request_id="h"))
    assert th.describe() == jh.describe()
    assert th.describe()["blocks"] == 2 and th.n_prompt == len(prompt)
    assert th.nbytes == jh.nbytes > 0
    assert th.tok0 == jh.tok0 and th.key == 0
    assert len(th.pages) == len(jh.pages) == (4 if kv_dtype else 2)
    n = len(prompt)
    for tp, jp in zip(th.pages, jh.pages):
        jp = torch.from_numpy(np.array(jp))
        assert tp.dtype == jp.dtype and tp.shape == jp.shape
        rows = (lambda a: a.reshape(a.shape[0], -1, *a.shape[3:])[:, :n])
        if tp.dtype == torch.int8:     # within one step of rounding
            assert (rows(tp).int() - rows(jp).int()).abs().max() <= 1
        else:
            torch.testing.assert_close(rows(tp), rows(jp), atol=1e-5,
                                       rtol=1e-5)
    # the slot and its blocks went back to the prefill engine
    assert teng.cache.pool.used_blocks == 0 and len(teng._free) == 3
    h = make_engine(tm, **kw).inject_prefilled(th)
    assert h.request.request_id == "h"


def test_handoff_decodes_as_a_single_engine(pair_models):
    _, tm = pair_models
    pair = make_pair(tm)
    req = gen.GenerationRequest([1, 2, 3, 4], max_new_tokens=2)
    handoff = pair.prefill.prefill_extract(req)
    h = pair.decode.inject_prefilled(handoff)
    pair.run_until_idle()
    assert h.result(timeout=0) == serve_single(tm, [req])[0]
    assert pair.stats()["handoffs"] == 0     # routed by hand, not metered


def test_geometry_validation(pair_models):
    _, tm = pair_models
    pair = make_pair(tm)
    handoff = pair.prefill.prefill_extract(
        gen.GenerationRequest([1, 2, 3], max_new_tokens=2))
    dense = make_engine(tm, slots=2, prefill_buckets=[8], max_queue=8,
                        paged=False, kv_blocks=None, block_size=None)
    with pytest.raises(ValueError, match="paged"):
        dense.inject_prefilled(handoff)
    with pytest.raises(ValueError, match="paged"):
        dense.prefill_extract(gen.GenerationRequest([1], max_new_tokens=1))
    with pytest.raises(ValueError, match="block_size"):
        make_engine(tm, slots=2, block_size=8,
                    kv_blocks=18).inject_prefilled(handoff)
    with pytest.raises(ValueError, match="kv_dtype"):
        make_engine(tm, kv_dtype="int8").inject_prefilled(handoff)
    one_layer = models.TransformerLM(models.TransformerLMConfig(
        **dict(KW, num_layers=1)), device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        make_engine(one_layer).inject_prefilled(handoff)
    with pytest.raises(ValueError, match="paged"):
        tps.DisaggPair(dense, pair.decode)
    with pytest.raises(ValueError, match="block_size mismatch"):
        tps.DisaggPair(pair.prefill, make_engine(tm, block_size=8,
                                                 kv_blocks=18))


def test_extract_sheds_and_refuses_when_it_cannot_run(pair_models):
    _, tm = pair_models
    eng = make_engine(tm, slots=1, kv_blocks=2)
    with pytest.raises(gen.ShedError) as err:       # 17 rows: 2 blocks
        eng.prefill_extract(gen.GenerationRequest(list(range(1, 18)),
                                                  max_new_tokens=1))
    assert err.value.reason == "kv_pool_exhausted"
    assert eng._free == [0] and eng.cache.pool.used_blocks == 0
    eng.submit(gen.GenerationRequest([1, 2], max_new_tokens=8))
    eng.step()                                       # the one slot busy
    with pytest.raises(gen.ShedError) as err:
        eng.prefill_extract(gen.GenerationRequest([3], max_new_tokens=1))
    assert err.value.reason == "slots_full"
    eng.kill()
    with pytest.raises(gen.EngineDeadError):
        eng.prefill_extract(gen.GenerationRequest([3], max_new_tokens=1))


def test_int8_pair_hands_over_pages_and_scales(pair_models):
    jm, tm = pair_models
    pair = make_pair(tm, kv_dtype="int8")
    handoff = pair.prefill.prefill_extract(
        gen.GenerationRequest([1, 2, 3, 4, 5], max_new_tokens=2))
    assert [p.dtype for p in handoff.pages] == [
        torch.int8, torch.int8, torch.float32, torch.float32]
    assert handoff.describe()["kv_dtype"] == "int8"
    pair.decode.inject_prefilled(handoff)
    pair.run_until_idle()
    got = serve_pair(pair, mixed_requests(gen, 7))
    assert got == serve_single(tm, mixed_requests(gen, 7), kv_dtype="int8")
    want = serve_pair(make_pair(jm, jax_gen, jax_tps, kv_dtype="int8"),
                      mixed_requests(jax_gen, 7))
    assert [got[i] for i in GREEDY] == [want[i] for i in GREEDY]
    assert all(v == 0 for v in
               pair.decode.stats()["executables"]["prefill"].values())


def test_decode_engine_death_hands_queued_handoffs_to_the_hook(pair_models):
    _, tm = pair_models
    pair = make_pair(tm)
    handles = [pair.submit(r) for r in mixed_requests(gen, 4)]
    seen = []
    pair.decode.on_death = lambda e, hs: seen.extend(hs)
    pair.decode.kill("drill")
    assert seen == handles and not any(h.done for h in handles)


# ---------------------------------------------------------------------------
# ShardGroupFleet (stub groups, as the reference's test)
# ---------------------------------------------------------------------------


class _StubGroup:
    def __init__(self, group_id, headroom):
        self.group_id = group_id
        self._headroom = headroom
        self.kv_transfer_bytes = 0
        self.submitted = []

    def headroom(self):
        return self._headroom - len(self.submitted)

    def submit(self, request):
        self.submitted.append(request)
        return request

    def stats(self):
        return {"group_id": self.group_id, "headroom": self.headroom()}


@pytest.mark.parametrize("heads,want", [((2, 2), (2, 2)), ((1, 5), (1, 4))],
                         ids=["tie_alternates", "drained_group_first"])
def test_shard_group_fleet_routes_as_jax(heads, want):
    n = sum(want)
    counts = []
    for module in (tps, jax_tps):
        groups = [_StubGroup(i, h) for i, h in enumerate(heads)]
        fleet = module.ShardGroupFleet(groups)
        for i in range(n):
            fleet.submit("r%d" % i)
        counts.append(tuple(len(g.submitted) for g in groups))
        assert fleet.stats()["submitted"] == n
    assert counts[0] == counts[1] == want


def test_shard_group_fleet_over_real_pairs(pair_models):
    _, tm = pair_models
    fleet = tps.ShardGroupFleet([make_pair(tm), make_pair(tm)])
    handles = [fleet.submit(r) for r in mixed_requests(gen, 4)]
    fleet.run_until_idle()
    got = [h.result(timeout=0) for h in handles]
    assert got == serve_single(tm, mixed_requests(gen, 4))
    st = fleet.stats()
    assert st["submitted"] == 4 and fleet.ready()
    assert [g["handoffs"] for g in st["shard_groups"]] == [2, 2]
    assert st["kv_transfer_bytes"] == sum(
        g["kv_transfer_bytes"] for g in st["shard_groups"])
    with pytest.raises(ValueError):
        tps.ShardGroupFleet([])
