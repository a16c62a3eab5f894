"""`paddle_tpu_torch.inference`'s Predictor held against
`paddle_tpu.inference`'s on the CPU.

Directories written by the JAX package — a tiny BERT with the fused FFN
on, the same BERT with it off (served as saved, and after
``matmul_bias_act_fuse``) and a small fc/relu MLP — are served by both
predictors on the same seeded feeds: outputs within rtol / atol 1e-5
(f32).  The port's predictor runs with ``device="cpu"``: its kernels'
plain versions.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.fluid import ir as jir
from paddle_tpu.inference import AnalysisConfig as JaxConfig
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu_torch.fluid import ir
from paddle_tpu_torch.inference import (
    AnalysisConfig, create_predictor, export_stablehlo, load_stablehlo,
)

from torch_static_common import (
    TOL, bert_feed, jax_bert, jax_mlp, jax_save, jax_state_unchanged,
)


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{name: directory} of the JAX-saved models."""
    root = tmp_path_factory.mktemp("static_models")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for fused in (True, False):
            mp.setenv("PADDLE_TPU_FUSED_FFN", "1" if fused else "0")
            d = str(root / ("bert_fused" if fused else "bert"))
            jax_save(d, *jax_bert(), perturb=0.05)
            out["bert_fused" if fused else "bert"] = d
    d = str(root / "mlp")
    jax_save(d, *jax_mlp(), perturb=0.1)
    out["mlp"] = d
    return out


def _feed(name, b=3):
    if name == "mlp":
        return {"x": np.random.RandomState(2).standard_normal(
            (b, 4)).astype(np.float32)}
    return bert_feed(b=b)


def _port(d, passes=()):
    pred = create_predictor(AnalysisConfig(d), device="cpu")
    if passes:
        ir.apply_passes(pred._program, list(passes))
    return pred


def _jax(d, passes=()):
    pred = jax_predictor(JaxConfig(d))
    if passes:          # before its first run, as the JAX jit traces then
        jir.apply_passes(pred._program, list(passes))
    return pred


@pytest.mark.parametrize("name,passes", [
    ("bert_fused", ()),
    ("bert", ()),
    ("bert", ("matmul_bias_act_fuse",)),
    ("mlp", ()),
    ("mlp", ("matmul_bias_act_fuse",)),
])
def test_port_predictor_matches_the_jax_predictor(saved, name, passes):
    feed = _feed(name)
    want = _jax(saved[name], passes).run(feed)
    port = _port(saved[name], passes)
    got = port.run(feed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **TOL)
    fused = [o for o in port._program.global_block.ops
             if o.type == "matmul_bias_act"]
    if name == "bert_fused" or (name == "bert" and passes):
        assert len(fused) == (2 if name == "bert_fused" else 3)
    assert port.get_input_names() == _jax(saved[name]).get_input_names()
    assert port.get_output_names() == _jax(saved[name]).get_output_names()


def test_a_pass_applied_after_loading_reaches_the_next_run(saved):
    feed = _feed("bert")
    port = _port(saved["bert"])
    before = port.run(feed)
    ir.apply_passes(port._program, ["matmul_bias_act_fuse"])
    after = port.run(feed)
    assert sum(o.type == "matmul_bias_act" for o in port._ops) == 3
    for a, b in zip(after, before):
        np.testing.assert_allclose(a, b, **TOL)


def test_weights_are_transposed_once_at_load(saved):
    port = _port(saved["bert_fused"])
    feed = _feed("bert_fused")
    port.run(feed)
    ops, weights = port._plan()
    mba = [o for o in ops if o.type == "matmul_bias_act"]
    assert all(o.attrs["weight_layout"] == "NK" and
               o.inputs["Y"][0].endswith("@NK") for o in mba)
    for o in mba:
        name = o.inputs["Y"][0]
        w = weights[name]
        assert w.is_contiguous()
        kn = port._scope.find_var(name[:-3])
        assert torch.equal(w, kn.t())
        assert kn.data_ptr() == w.data_ptr()    # one copy of the weight
    ptrs = {n: weights[n].data_ptr() for n in weights}
    port.run(feed)
    assert port._plan()[1] is weights
    assert {n: t.data_ptr() for n, t in port._plan()[1].items()} == ptrs


def test_a_scope_written_after_loading_reaches_the_next_run(saved):
    port = _port(saved["bert_fused"], passes=["matmul_bias_act_fuse"])
    feed = _feed("bert_fused")
    before = port.run(feed)
    mba = [o for o in port._ops if o.type == "matmul_bias_act"]
    name = mba[-1].inputs["Y"][0][:-3]          # the pooler's [K, N]
    port._scope.set(name, torch.zeros_like(port._scope.find_var(name)))
    after = port.run(feed)
    assert not torch.any(port._plan()[1][name + "@NK"])
    np.testing.assert_allclose(after[0], before[0], **TOL)
    np.testing.assert_allclose(after[1], np.tanh(np.broadcast_to(
        port._scope.find_var(mba[-1].inputs["Bias"][0]).numpy(),
        after[1].shape)), **TOL)


def test_compile_count_counts_feed_signatures(saved):
    port = _port(saved["bert"])
    jax = _jax(saved["bert"])
    for b in (1, 4, 1, 2):
        port.run(_feed("bert", b))
        jax.run(_feed("bert", b))
    assert port.compile_count == jax.compile_count == 3
    spec = {n: (2, 16) for n in port.get_input_names()}
    assert port.warmup([spec]) == 3
    assert port.warmup([{n: (5, 16) for n in spec}]) == 4


def test_run_async_and_cost_analysis(saved):
    port = _port(saved["mlp"])
    feed = _feed("mlp", b=5)
    outs = port.run_async(feed)
    assert isinstance(outs[0], torch.Tensor)
    np.testing.assert_array_equal(outs[0].numpy(), port.run(feed)[0])
    cost = port.cost_analysis(feed)
    assert cost == {"flops": 2 * 5 * (4 * 8 + 8 * 3)}
    assert port.cost_analysis(feed) == cost
    bert = _port(saved["bert"], ("matmul_bias_act_fuse",))
    b, s, d, f, layers = 3, 16, 32, 64, 2
    want = layers * (2 * b * s * d * (3 * d + d + 2 * f)   # the GEMMs
                     + 4 * b * 4 * s * s * (d // 4))       # attention
    want += 2 * b * d * d                                  # the pooler
    assert bert.cost_analysis(_feed("bert"))["flops"] == want


def test_feed_errors_and_unported_entry_points(saved):
    port = _port(saved["mlp"])
    with pytest.raises(ValueError, match="missing"):
        port.run({})
    with pytest.raises(ValueError, match="length mismatch"):
        port.run([])
    with pytest.raises(NotImplementedError, match="later slice"):
        AnalysisConfig(saved["mlp"]).enable_int8()
    with pytest.raises(NotImplementedError, match="later slice"):
        export_stablehlo("unused", port, [])
    with pytest.raises(NotImplementedError, match="later slice"):
        load_stablehlo("unused")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_predictor(AnalysisConfig(saved["mlp"]))
    cfg = AnalysisConfig(saved["mlp"])
    cfg.disable_gpu()
    assert create_predictor(cfg).device == torch.device("cpu")
