"""`paddle_tpu_torch.generation.GenerationEngine` on the CPU, held against
the JAX engine and against its own sequential oracle.

* greedy streams equal the JAX engine's token for token, paged and
  dense, on the mixed traffic of tests/test_generation.py (more
  requests than slots, staggered finishes, mid-flight refill);
* every stream, greedy or sampled, equals the port's
  `sequential_oracle` (sampled streams are the port's own: torch and
  JAX draw other random numbers from one seed);
* a pool too small for the load preempts and still completes every
  stream; the int8 and speculative knobs refuse what the reference
  refuses, and the prefix and chunk knobs need the paged cache; the
  package imports neither JAX nor `paddle_tpu`; and an entry point with
  no device raises on a box without a card.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph
from paddle_tpu_torch import generation as gen
from paddle_tpu_torch import models

jax_gen = paddle_tpu.generation
ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
          intermediate_size=256, max_position_embeddings=128, dropout=0.0)


@pytest.fixture(scope="module")
def pair():
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
    if module is gen:
        kw.setdefault("device", "cpu")
    return module.GenerationEngine(model, **kw)


def mixed_requests(module, n, max_new=6):
    """The traffic of tests/test_generation.py: prompts of 2-13 tokens,
    alternating greedy and sampled, staggered max_new_tokens."""
    rng = np.random.RandomState(1)
    reqs = []
    for i in range(n):
        plen = int(rng.randint(2, 14))
        prompt = rng.randint(0, KW["vocab_size"], plen)
        sp = (module.SamplingParams.greedy() if i % 2 == 0 else
              module.SamplingParams(temperature=0.9, top_k=20, top_p=0.9,
                                    seed=100 + i))
        reqs.append(module.GenerationRequest(
            prompt, max_new_tokens=max_new + (i % 3), sampling=sp,
            request_id="t%d" % i))
    return reqs


def serve(eng, reqs):
    handles = [eng.submit(r) for r in reqs]
    eng.run_until_idle()
    return [h.result(timeout=0) for h in handles], handles


@pytest.mark.parametrize("paged", [True, False])
def test_greedy_streams_equal_jax_engine(pair, paged):
    jm, tm = pair
    want, _ = serve(make_engine(jm, jax_gen, paged=paged),
                    mixed_requests(jax_gen, 7))
    got, handles = serve(make_engine(tm, paged=paged),
                         mixed_requests(gen, 7))
    greedy = [i for i in range(7) if i % 2 == 0]
    assert [got[i] for i in greedy] == [want[i] for i in greedy]
    assert all(len(s) == 6 + (i % 3) for i, s in enumerate(got))
    assert all(h.finish_reason == "max_new_tokens" for h in handles)


def test_streams_equal_sequential_oracle_and_blocks_return(pair):
    _, tm = pair
    reqs = mixed_requests(gen, 7)
    eng = make_engine(tm)
    got, _ = serve(eng, reqs)
    assert got == gen.sequential_oracle(lambda: make_engine(tm), reqs)
    assert eng.cache.pool.used_blocks == 0
    assert not eng.cache.block_tables.any()


def test_paged_equals_dense_on_sampled_streams_too(pair):
    _, tm = pair
    reqs = mixed_requests(gen, 5)
    paged, _ = serve(make_engine(tm), reqs)
    dense, _ = serve(make_engine(tm, paged=False), reqs)
    assert paged == dense


def test_small_pool_preempts_and_completes(pair):
    """Block size 4 and 7 usable blocks for 3 slots: slots grow their
    tables while decoding, the pool runs dry, the least-progressed slot
    restarts — and every stream still equals the oracle."""
    _, tm = pair
    reqs = mixed_requests(gen, 6, max_new=10)
    eng = make_engine(tm, block_size=4, kv_blocks=8)
    got, handles = serve(eng, reqs)
    assert eng.stats()["preempted"] > 0
    assert all(h.finish_reason == "max_new_tokens" for h in handles)
    assert got == gen.sequential_oracle(lambda: make_engine(tm), reqs)
    assert eng.cache.pool.used_blocks == 0


def test_background_loop_generate_and_stats(pair):
    _, tm = pair
    eng = make_engine(tm).start()
    try:
        out = eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=4)
    finally:
        eng.stop()
    assert [len(s) for s in out] == [4, 4]
    st = eng.stats()
    assert st["device"] == "cpu" and st["decode_steps"] > 0
    assert st["cache"]["paged"] and st["cache"]["block_size"] == 16
    assert eng.occupancy() == {"slots": 3, "active": 0, "chunking": 0,
                               "free": 3, "pending": 0}


def test_admission_sheds_and_refuses(pair):
    _, tm = pair
    eng = make_engine(tm, max_queue=1)
    eng.submit(gen.GenerationRequest([1, 2], max_new_tokens=2))
    with pytest.raises(gen.ShedError) as err:
        eng.submit(gen.GenerationRequest([3], max_new_tokens=2))
    assert err.value.reason == "slots_full"
    with pytest.raises(ValueError):
        eng.submit(gen.GenerationRequest(list(range(20)), max_new_tokens=2))
    with pytest.raises(ValueError):
        eng.submit(gen.GenerationRequest([1], max_new_tokens=64))


def _draft(max_positions=128):
    cfg = models.TransformerLMConfig(**dict(
        KW, hidden_size=64, num_layers=1, num_heads=1,
        intermediate_size=128, max_position_embeddings=max_positions))
    return models.TransformerLM(cfg, device="cpu")


@pytest.mark.parametrize("knob,match", [
    (dict(draft=128, draft_len=0), "draft_model needs draft_len >= 1"),
    (dict(draft=128, draft_len=2, paged=False),
     "speculative decoding requires paged=True"),
    (dict(kv_dtype="int8", paged=False),
     "prefix_cache / prefill_chunk / kv_dtype require paged=True"),
    (dict(draft=32, draft_len=2),
     "draft model max_position_embeddings 32 < engine max_len 64"),
    (dict(kv_dtype="fp8"), "kv_dtype must be None or 'int8'")],
    ids=["draft_len0", "draft_dense", "int8_dense", "draft_short",
         "fp8"])
def test_unported_knobs_raise(pair, knob, match):
    """The int8 and speculative knobs, once unported, now raise the
    reference's ValueErrors on the combinations it refuses."""
    _, tm = pair
    knob = dict(knob)
    if "draft" in knob:
        knob["draft_model"] = _draft(knob.pop("draft"))
    with pytest.raises(ValueError, match=match):
        make_engine(tm, **knob)


@pytest.mark.parametrize("knob", [{"prefix_cache": True},
                                  {"prefill_chunk": 8}])
def test_prefix_and_chunk_need_paged(pair, knob):
    _, tm = pair
    with pytest.raises(ValueError, match="paged=True"):
        make_engine(tm, paged=False, **knob)


def test_default_device_raises_without_a_card(monkeypatch, pair):
    _, tm = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.TransformerLM(models.TransformerLMConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        gen.GenerationEngine(tm, slots=2, max_len=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        gen.KVCache(1, 1, 8, 1, 64)


def _imports(path):
    """Top-level names of every module a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_sources_never_import_jax_or_the_jax_package():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "paddle_tpu"}
        assert not bad, "%s imports %s" % (f, bad)


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import paddle_tpu_torch as p\n"
        "from paddle_tpu_torch import device, generation, models, ops\n"
        "from paddle_tpu_torch import observability\n"
        "from paddle_tpu_torch import incubate, serving, tp_serving\n"
        "from paddle_tpu_torch.incubate import fault\n"
        "from paddle_tpu_torch.observability import slo\n"
        "from paddle_tpu_torch.ops import _build\n"
        "from paddle_tpu_torch import clip, learning_rate_scheduler\n"
        "from paddle_tpu_torch import optimizer, regularizer\n"
        "from paddle_tpu_torch.observability import cost\n"
        "import torch\n"
        "fault.FaultPlan().arm_lock_delays()\n"
        "slo.RegressionSentinel({})\n"
        "w = torch.nn.Parameter(torch.ones(2))\n"
        "w.grad = torch.ones(2)\n"
        "optimizer.LambOptimizer(0.1).minimize(None, parameter_list=[w])\n"
        "regularizer.L2Decay(0.1)([w], [w.grad])\n"
        "clip.GradientClipByGlobalNorm(1.0)([(w, w.grad)])\n"
        "learning_rate_scheduler.NoamDecay(8, 2)()\n"
        "cost.feed_signature({'x': w})\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """In the checkout with no CUDA device, and alone in a directory
    (no package beside it), the script exits non-zero and prints no
    result line."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
