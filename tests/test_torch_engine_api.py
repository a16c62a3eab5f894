"""The serving API of `paddle_tpu_torch.generation.GenerationEngine` on
the CPU, held against the JAX engine given the same weights:

* `snapshot_params` equals the JAX engine's (carried across by
  `models.from_jax_state_dict`) bitwise, before and after a swap;
* a `swap_params` at the same decode step of both engines, stepped by
  hand, gives token-identical greedy streams, and the swap moves the
  streams; names, shapes, dtypes and a dead engine raise as the
  reference raises, and change no weight;
* a swap never reaches a sibling engine built from the same module, nor
  the caller's model (copy-on-swap); of two swaps on one engine from two
  threads, the one that installs last serves;
* the kill drill, stepped by hand: `affected_on_death` names the same
  requests in the same order as the JAX engine's; an ``on_death`` hook
  takes them and none fails, without one every one fails;
* `recent_requests` holds the same records (keys, ids, outcomes,
  ``n_tokens``) as the JAX engine's, bounded at 256;
* ``stats()["executables"]`` equals the JAX engine's for the same
  traffic (plain, chunked, speculative), ``decode_executables == 1``.

Model: vocab 128, hidden 128, 2 layers, 2 heads of 64, f32; tokens are
compared exactly.
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph
from paddle_tpu_torch import generation as gen
from paddle_tpu_torch import models

jax_gen = paddle_tpu.generation
KW = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
          intermediate_size=256, max_position_embeddings=128, dropout=0.0)
DRAFT_KW = dict(KW, hidden_size=64, num_layers=1, num_heads=1,
                intermediate_size=128)


def _jax_model(kw, seed):
    with dygraph.guard():
        np.random.seed(seed)
        jm = jax_models.TransformerLM(jax_models.TransformerLMConfig(**kw))
    return jm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _torch_model(kw, params):
    tm = models.TransformerLM(models.TransformerLMConfig(**kw), device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(params))
    return tm


@pytest.fixture(scope="module")
def pair():
    jm, params = _jax_model(KW, 0)
    return jm, _torch_model(KW, params)


@pytest.fixture(scope="module")
def second_weights():
    """Another model's weights (JAX layout), the swap's target.  Drawn
    wider than the first's: at the default 0.02 both tiny models' greedy
    streams repeat the prompt's last token, and a swap would not show."""
    return _jax_model(dict(KW, initializer_range=0.5), 1)[1]


def make_engine(model, module=gen, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_buckets", [8, 16])
    kw.setdefault("max_queue", 64)
    if module is gen:
        kw.setdefault("device", "cpu")
    return module.GenerationEngine(model, **kw)


def mixed_requests(module, n, max_new=6, greedy_only=False):
    rng = np.random.RandomState(1)
    reqs = []
    for i in range(n):
        prompt = rng.randint(0, KW["vocab_size"], int(rng.randint(2, 14)))
        sp = (module.SamplingParams.greedy()
              if greedy_only or i % 2 == 0 else
              module.SamplingParams(temperature=0.9, top_k=20, top_p=0.9,
                                    seed=100 + i))
        reqs.append(module.GenerationRequest(
            prompt, max_new_tokens=max_new + (i % 3), sampling=sp,
            request_id="t%d" % i))
    return reqs


def serve(eng, reqs):
    handles = [eng.submit(r) for r in reqs]
    eng.run_until_idle()
    return [h.result(timeout=0) for h in handles]


def _equal_params(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# snapshot / swap
# ---------------------------------------------------------------------------


def test_snapshot_equals_the_jax_engine_bitwise(pair, second_weights):
    jm, tm = pair
    jeng, teng = make_engine(jm, jax_gen), make_engine(tm)
    snap = teng.snapshot_params()
    assert all(t.device.type == "cpu" for t in snap.values())
    assert _equal_params(
        snap, models.from_jax_state_dict(jeng.snapshot_params()))
    jeng.swap_params(second_weights)
    teng.swap_params(models.from_jax_state_dict(second_weights))
    assert _equal_params(
        teng.snapshot_params(),
        models.from_jax_state_dict(jeng.snapshot_params()))
    # a snapshot is a copy: editing it moves no served weight
    snap2 = teng.snapshot_params()
    snap2["word.weight"].zero_()
    assert not torch.equal(teng.snapshot_params()["word.weight"],
                           snap2["word.weight"])


def test_swap_mid_stream_token_identical_to_jax(pair, second_weights):
    """Both engines step by hand, swap after the same decode step and
    finish: greedy streams equal token for token, and differ from an
    unswapped run's (the swap took effect mid-stream)."""
    jm, tm = pair
    jeng, teng = make_engine(jm, jax_gen), make_engine(tm)
    jh = [jeng.submit(r) for r in mixed_requests(jax_gen, 5, 8, True)]
    th = [teng.submit(r) for r in mixed_requests(gen, 5, 8, True)]
    for _ in range(3):
        jeng.step()
        teng.step()
    assert jeng._decode_steps == teng._decode_steps == 3
    jeng.swap_params(second_weights)
    teng.swap_params(models.from_jax_state_dict(second_weights))
    jeng.run_until_idle()
    teng.run_until_idle()
    want = [h.result(timeout=0) for h in jh]
    got = [h.result(timeout=0) for h in th]
    assert got == want
    unswapped = serve(make_engine(tm), mixed_requests(gen, 5, 8, True))
    assert got != unswapped


def test_swap_reaches_neither_sibling_nor_caller(pair, second_weights):
    """Copy-on-swap: engines built from one module share it until one
    swaps; that one gets its own copy, and the module (the caller's)
    and the sibling keep the old weights.  A second swap copies into
    the engine's own copy in place."""
    _, tm = pair
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    reqs = mixed_requests(gen, 5)
    a, b = make_engine(tm), make_engine(tm)
    assert a.model is b.model is tm
    base = serve(b, reqs)
    a.swap_params(models.from_jax_state_dict(second_weights))
    assert a.model is not tm and b.model is tm
    assert _equal_params(tm.state_dict(), before)
    assert serve(b, reqs) == base
    assert serve(a, reqs) != base
    own = a.model
    a.swap_params(before)
    assert a.model is own
    assert serve(a, reqs) == base
    fresh = serve(make_engine(_torch_model(KW, second_weights)), reqs)
    a.swap_params(models.from_jax_state_dict(second_weights))
    assert serve(a, reqs) == fresh
    assert _equal_params(tm.state_dict(), before)


class _SwapsAnotherFirst(dict):
    """A swap dict whose first ``keys()`` runs a whole other swap of the
    same engine on another thread.  The engine reads the names after
    its first lock section, so the other swap installs its own copy of
    the model while this one is still staging."""

    def __init__(self, params, engine, other):
        super().__init__(params)
        self._engine, self._other, self._fired = engine, other, False

    def keys(self):
        if not self._fired:
            self._fired = True
            t = threading.Thread(target=self._engine.swap_params,
                                 args=(self._other,))
            t.start()
            t.join()
        return super().keys()


def test_two_threads_swapping_one_engine(pair, second_weights):
    """Both swaps start on the caller's module; the one that installs
    last serves, its tensors are not dropped, and the caller's model
    keeps its weights."""
    _, tm = pair
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    other = {k: v + 1 for k, v in before.items()}
    second = models.from_jax_state_dict(second_weights)
    eng = make_engine(tm)
    eng.swap_params(_SwapsAnotherFirst(second, eng, other))
    assert eng.model is not tm
    assert _equal_params(eng.snapshot_params(),
                         {k: v.cpu() for k, v in second.items()})
    assert _equal_params(tm.state_dict(), before)
    reqs = mixed_requests(gen, 5)
    fresh = serve(make_engine(_torch_model(KW, second_weights)), reqs)
    assert serve(eng, reqs) == fresh


def _bad_params(case, params):
    """One malformed swap dict (JAX layout when ``params`` is)."""
    p = dict(params)
    key = "blocks.0.fc1.bias"
    if case == "missing":
        del p[key]
    elif case == "extra":
        p["blocks.9.fc1.bias"] = p[key]
    elif case == "shape":
        p[key] = np.zeros(np.asarray(p[key]).shape[0] + 1, np.float32)
    else:       # the JAX engine casts float64 to its f32 without a word
        p[key] = np.asarray(p[key]).astype(np.int32)
    return p


@pytest.mark.parametrize("case", ["missing", "extra", "shape", "dtype"])
def test_swap_errors_match_jax_and_change_nothing(pair, second_weights,
                                                  case):
    jm, tm = pair
    jeng, teng = make_engine(jm, jax_gen), make_engine(tm)
    with pytest.raises(ValueError):
        jeng.swap_params(_bad_params(case, second_weights))
    snap = teng.snapshot_params()
    port_params = {k: torch.from_numpy(np.asarray(v)) for k, v in
                   _bad_params(case, {k: v.numpy() for k, v in
                                      snap.items()}).items()}
    port_params = {k: (v + 1 if v.dtype == torch.float32 else v)
                   for k, v in port_params.items()}
    with pytest.raises(ValueError, match="swap_params"):
        teng.swap_params(port_params)
    if case == "dtype":         # the port casts nothing, float64 neither
        port_params = dict(snap, **{"blocks.0.fc1.bias":
                                    snap["blocks.0.fc1.bias"].double()})
        with pytest.raises(ValueError, match="float64"):
            teng.swap_params(port_params)
    assert _equal_params(teng.snapshot_params(), snap)
    assert teng.model is tm


def test_swap_on_dead_engine_raises_as_jax(pair, second_weights):
    jm, tm = pair
    jeng, teng = make_engine(jm, jax_gen), make_engine(tm)
    jeng.kill()
    teng.kill()
    with pytest.raises(jax_gen.EngineDeadError):
        jeng.swap_params(second_weights)
    with pytest.raises(gen.EngineDeadError):
        teng.swap_params(models.from_jax_state_dict(second_weights))
    assert teng.model is tm


# ---------------------------------------------------------------------------
# death
# ---------------------------------------------------------------------------


def _kill_at(module, n):
    def hook(step_no):
        if step_no + 1 >= n:
            raise module.EngineDeadError("drill death at step %d" % n)
    return hook


def _run_to_death(eng):
    for _ in range(100):
        try:
            eng.step()
        except Exception as e:
            assert "drill death" in str(e) or "dead" in str(e)
            return
    raise AssertionError("the engine never died")


@pytest.mark.parametrize("hooked", [True, False], ids=["hook", "no_hook"])
def test_kill_drill_affected_equals_jax(pair, hooked):
    """Six requests on three slots, death before decode step 3: three in
    flight, three queued.  The hook receives them all and fails none;
    without one they all fail."""
    jm, tm = pair
    ids = {}
    for module, model in ((jax_gen, jm), (gen, tm)):
        eng = make_engine(model, module, step_hook=_kill_at(module, 3))
        seen = []
        if hooked:
            eng.on_death = lambda e, hs, seen=seen: seen.extend(hs)
        handles = [eng.submit(r) for r in mixed_requests(module, 6, 8)]
        _run_to_death(eng)
        assert eng.dead
        affected = eng.affected_on_death
        ids[module] = [h.request.request_id for h in affected]
        assert set(affected) == set(handles)
        if hooked:
            assert seen == affected
            assert not any(h.done for h in handles)
        else:
            assert all(h.done and "died" in h.error for h in handles)
        with pytest.raises(module.EngineDeadError):
            eng.submit(module.GenerationRequest([1, 2], max_new_tokens=2))
    assert ids[gen] == ids[jax_gen]
    assert len(ids[gen]) == 6


def test_kill_of_an_idle_engine_and_handle_defaults(pair):
    _, tm = pair
    eng = make_engine(tm)
    assert eng.on_death is None and eng.affected_on_death == []
    h = eng.submit(gen.GenerationRequest([1, 2, 3], max_new_tokens=2))
    assert h.requeued is False
    eng.kill("operator")
    assert eng.affected_on_death == [h]
    with pytest.raises(RuntimeError, match="operator"):
        h.result(timeout=1)


# ---------------------------------------------------------------------------
# request window
# ---------------------------------------------------------------------------


def _records(eng):
    return [(r["request_id"], r["outcome"], r["n_tokens"], sorted(r))
            for r in eng.recent_requests()]


def test_recent_requests_equal_jax(pair):
    jm, tm = pair
    records = {}
    for module, model in ((jax_gen, jm), (gen, tm)):
        eng = make_engine(model, module)
        serve(eng, mixed_requests(module, 7))
        records[module] = _records(eng)
    assert records[gen] == records[jax_gen]
    assert len(records[gen]) == 7
    assert {r[1] for r in records[gen]} == {"ok"}


def test_recent_requests_window_is_256(pair):
    """max_queue=0 sheds every submit: 300 shed records, the last 256
    kept, the same as the JAX engine's window."""
    jm, tm = pair
    records = {}
    for module, model in ((jax_gen, jm), (gen, tm)):
        eng = make_engine(model, module, max_queue=0)
        for i in range(300):
            with pytest.raises(Exception, match="shed"):
                eng.submit(module.GenerationRequest(
                    [1, 2], max_new_tokens=2, request_id="shed%d" % i))
        records[module] = _records(eng)
    assert records[gen] == records[jax_gen]
    assert [r[0] for r in records[gen]] == ["shed%d" % i
                                            for i in range(44, 300)]


# ---------------------------------------------------------------------------
# launch signatures (the reference's executable counts)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs", ["plain", "chunked", "speculative"])
def test_executables_equal_jax(pair, knobs):
    jm, tm = pair
    stats = {}
    for module, model in ((jax_gen, jm), (gen, tm)):
        kw = {}
        if knobs == "chunked":
            kw["prefill_chunk"] = 8
        elif knobs == "speculative":
            djm, dparams = _jax_model(DRAFT_KW, 3)
            kw.update(draft_model=djm if module is jax_gen
                      else _torch_model(DRAFT_KW, dparams), draft_len=2)
        eng = make_engine(model, module, **kw)
        assert eng.stats()["decode_executables"] == 0
        serve(eng, mixed_requests(module, 5))
        stats[module] = eng.stats()
    assert stats[gen]["executables"] == stats[jax_gen]["executables"]
    assert stats[gen]["decode_executables"] == \
        stats[jax_gen]["decode_executables"]
    ex = stats[gen]["executables"]
    if knobs == "speculative":
        # every iteration here is a verify: the plain step never runs
        assert ex["verify"] == 1 and ex["draft_decode"] == 1
        assert ex["decode_step"] == 0
        assert ex["draft_prefill"] == ex["prefill"] == {8: 1, 16: 1}
    elif knobs == "chunked":
        assert ex["chunk"] == {8: 1} and set(ex["prefill"].values()) == {0}
    else:
        assert ex["prefill"] == {8: 1, 16: 1} and ex["chunk"] == {}
    if knobs != "speculative":
        assert stats[gen]["decode_executables"] == ex["decode_step"] == 1
