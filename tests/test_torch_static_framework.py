"""`paddle_tpu_torch.fluid`'s Program IR, Executor and static BERT held
against `paddle_tpu.fluid` on the CPU.

* The JSON IR round-trips in both directions: a program either package
  builds gives the same ``to_dict`` in the other after ``to_json`` /
  ``from_json``.
* `models.bert_program` emits, under a fresh ``unique_name.guard()``,
  exactly the program (ops, attrs, parameter and variable names, shapes
  and dtypes) and the startup program that the JAX ``BertModel``
  traced in static mode gives, with the fused FFN on and off.
* With the JAX startup values copied into a port `Scope` by name
  (`Scope.set`), the port's `Executor` runs that program to the JAX
  Executor's outputs within rtol / atol 1e-5 (f32; the two sum in
  another order).
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu_torch import fluid, models
from paddle_tpu_torch.fluid import framework, layers, unique_name
from paddle_tpu_torch.models import bert_program

from torch_static_common import (
    S, TOL, bert_feed, jax_bert, jax_mlp, jax_state_unchanged,
)


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


@pytest.mark.parametrize("fused_ffn", [False, True])
def test_bert_program_is_the_traced_jax_bert(monkeypatch, fused_ffn):
    if fused_ffn:
        monkeypatch.setenv("PADDLE_TPU_FUSED_FFN", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_FUSED_FFN", raising=False)
    jmain, jstart, jfeeds, (jseq, jpooled) = jax_bert()
    main, start, feeds, (seq, pooled) = bert_program.bert_program(
        models.BertConfig.tiny(), S)
    assert [o.type for o in main.global_block.ops] == \
        [o.type for o in jmain.global_block.ops]
    assert [(p.name, p.shape) for p in main.all_parameters()] == \
        [(p.name, p.shape) for p in jmain.all_parameters()]
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()
    assert (feeds, seq.name, pooled.name) == (jfeeds, jseq.name,
                                              jpooled.name)
    types = [o.type for o in main.global_block.ops]
    assert types.count("matmul_bias_act") == (2 if fused_ffn else 0)
    assert types.count("flash_attention") == 2
    assert {o.type for o in start.global_block.ops} == {
        "gaussian_random", "fill_constant"}


def test_bert_program_refuses_the_bhsd_layout(monkeypatch):
    """The BHSD layout it once refused: now the traced JAX program, its
    q / k / v and context transposes included, dict for dict."""
    monkeypatch.delenv("PADDLE_TPU_FUSED_FFN", raising=False)
    monkeypatch.setenv("PADDLE_TPU_BERT_HEAD_LAYOUT", "BHSD")
    jmain, jstart, _, _ = jax_bert()
    main, start, _, _ = bert_program.bert_program(models.BertConfig.tiny(),
                                                  S)
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()
    types = [o.type for o in main.global_block.ops]
    assert types.count("transpose2") == 4 * 2
    assert all(o.attrs["layout"] == "BHSD" for o in main.global_block.ops
               if o.type == "flash_attention")


@pytest.mark.parametrize("build", ["bert", "mlp"])
def test_json_round_trips_both_ways(monkeypatch, build):
    jmain, jstart, _, _ = jax_bert() if build == "bert" else jax_mlp()
    for prog in (jmain, jstart):
        port = framework.Program.from_json(prog.to_json())
        assert port.to_dict() == prog.to_dict()
        back = jfluid.Program.from_json(port.to_json())
        assert back.to_dict() == prog.to_dict()
    monkeypatch.setenv("PADDLE_TPU_FUSED_FFN", "1")
    main, start, _, _ = bert_program.bert_program(models.BertConfig.tiny(),
                                                  S)
    for prog in (main, start):
        jax_side = jfluid.Program.from_json(prog.to_json())
        assert jax_side.to_dict() == prog.to_dict()
        assert framework.Program.from_json(
            jax_side.to_json()).to_dict() == prog.to_dict()


def _copy_scope(jscope, names):
    scope = fluid.Scope()
    for n in names:
        scope.set(n, torch.from_numpy(np.array(jscope.find_var(n))))
    return scope


@pytest.mark.parametrize("fused_ffn", [False, True])
def test_executor_runs_bert_to_the_jax_outputs(monkeypatch, fused_ffn):
    monkeypatch.setenv("PADDLE_TPU_FUSED_FFN", "1" if fused_ffn else "0")
    jmain, jstart, feeds, jouts = jax_bert()
    main, start, _, outs = bert_program.bert_program(
        models.BertConfig.tiny(), S)
    feed = bert_feed()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        want = jexe.run(jmain, feed=feed, fetch_list=list(jouts))
    scope = _copy_scope(jscope, [p.name for p in jmain.all_parameters()])
    exe = fluid.Executor(fluid.CPUPlace())
    got = exe.run(main, feed=feed, fetch_list=list(outs), scope=scope)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **TOL)


def test_startup_program_initializes_every_parameter():
    cfg = models.BertConfig.tiny()
    main, start, _, outs = bert_program.bert_program(cfg, S)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(start, scope=scope)
    for p in main.all_parameters():
        v = scope.find_var(p.name)
        assert tuple(v.shape) == p.shape and v.dtype == torch.float32
    w = scope.find_var("embedding.w_0")
    assert abs(w.std().item() - cfg.initializer_range) < 0.1 * \
        cfg.initializer_range
    assert torch.equal(scope.find_var("layernorm.w_0"), torch.ones(32))
    # two runs of the startup program draw different values (the run
    # counter moves the seed); a program's random_seed makes them
    # reproducible across executors
    exe.run(start, scope=scope)
    assert not torch.equal(scope.find_var("embedding.w_0"), w)
    start.random_seed = 5
    a, b = fluid.Scope(), fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(start, scope=a)
    fluid.Executor(fluid.CPUPlace()).run(start, scope=b)
    assert torch.equal(a.find_var("linear.w_0"), b.find_var("linear.w_0"))


def test_build_time_shape_inference_keeps_dynamic_dims():
    main, start = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, start):
        x = fluid.data("x", [-1, 5, 4], "float32")
        h = layers.fc(x, 6, num_flatten_dims=2, act="relu")
        s = layers.reshape(layers.slice(h, [1], [0], [1]), [0, 6])
        m = layers.cast(s, "float64")
    assert h.shape == (-1, 5, 6) and h.dtype == "float32"
    assert s.shape == (-1, 6)
    assert m.dtype == "float64"
    with pytest.raises(RuntimeError, match="shape inference failed"):
        with fluid.program_guard(main, start):
            layers.reshape(x, [7, 7])
    with pytest.raises(RuntimeError, match="not registered in the port"):
        with fluid.program_guard(main, start):
            layers.common.append_simple_op("shuffle_channel", {"X": x},
                                           {"group": 5})


def test_executor_errors_and_places():
    main, start = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, start):
        x = fluid.data("x", [-1, 4], "float32")
        y = layers.fc(x, 2)
    exe = fluid.Executor(fluid.CPUPlace())
    with pytest.raises(RuntimeError, match="startup program first"):
        exe.run(main, feed={"x": np.zeros((1, 4), np.float32)},
                fetch_list=[y], scope=fluid.Scope())
    assert fluid.CPUPlace().get_device() == torch.device("cpu")
    assert fluid.CUDAPlace(1).get_device() == torch.device("cuda", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fluid.Executor()


def test_scope_guard_and_program_guard_restore():
    main = fluid.Program()
    old_main, old_scope = fluid.default_main_program(), fluid.global_scope()
    s = fluid.Scope()
    with fluid.program_guard(main), fluid.scope_guard(s):
        assert fluid.default_main_program() is main
        assert fluid.global_scope() is s
    assert fluid.default_main_program() is old_main
    assert fluid.global_scope() is old_scope
    with unique_name.guard():
        assert unique_name.generate("fc") == "fc_0"
    clone = bert_program.bert_program(models.BertConfig.tiny(), S)[0].clone(
        for_test=True)
    assert all(o.attrs["is_test"] for o in clone.global_block.ops
               if o.type == "dropout")


def test_port_registry_is_its_own():
    from paddle_tpu.fluid.core import registry as jregistry
    from paddle_tpu_torch.fluid.core import registry as tregistry

    from paddle_tpu_torch.fluid.framework import OPTIMIZER_OP_TYPES

    # the ops `fluid.layers.ops` reaches, and concat
    from test_torch_static_surface import SURFACE
    # the rest of `fluid.layers.tensor`, the index ops, lr_schedule
    from test_torch_static_tensor import NEW_OP_TYPES

    SURFACE_OPS = {c[0] for c in SURFACE.values()}
    assert len(SURFACE_OPS) == 78        # 77 and elementwise_floordiv
    ports = set(tregistry.registered_ops())
    assert ports == {
        "cast", "dropout", "elementwise_add", "fill_constant",
        "flash_attention", "gaussian_random", "gelu", "layer_norm",
        "lookup_table", "lookup_table_v2", "matmul_bias_act", "mul",
        "relu", "reshape2",
        "scale", "slice", "tanh", "uniform_random",
        # the static training slice's ops and the 13 update ops
        "elementwise_sub", "elementwise_mul", "elementwise_div", "square",
        "matmul", "sum", "reduce_sum", "reduce_mean", "mean",
        "softmax_with_cross_entropy", "square_error_cost", "dropout_grad",
        "assign", "fill_zeros_like", "take_along_axis",
        # the vision slice's ops
        "conv2d", "depthwise_conv2d", "pool2d", "batch_norm",
        "fused_batch_norm_act", "softmax", "sigmoid", "cross_entropy",
        "top_k", "top_k_v2", "accuracy",
        "vjp_grad"} | OPTIMIZER_OP_TYPES | set(SURFACE_OPS) | set(
            NEW_OP_TYPES)
    assert ports < set(jregistry.registered_ops())
    assert tregistry.get_op_def("mul") is not jregistry.get_op_def("mul")
    with pytest.raises(ValueError, match="registered twice"):
        tregistry.register_op("mul", ["X"], ["Out"])(lambda *a: None)
