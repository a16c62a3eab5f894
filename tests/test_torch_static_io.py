"""`paddle_tpu_torch.fluid.io` held against `paddle_tpu.fluid.io` on the
CPU, in the one on-disk format both write (``__model__.json``,
``__meta__.pkl``, one ``.npy`` per persistable or one ``.npz``).

* A directory the JAX package writes loads in the port: the same
  program (``to_dict``), feeds, fetches and values, bitwise.
* A directory the port writes loads in the JAX package the same way,
  and JAX's `Predictor` serves it to the port's outputs within rtol /
  atol 1e-5.
* The pruned inference program is the JAX package's, dict for dict.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import io as jio
from paddle_tpu.inference import AnalysisConfig as JaxConfig
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu_torch import fluid, models
from paddle_tpu_torch.analysis import ProgramVerificationError
from paddle_tpu_torch.fluid import io
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.models import bert_program

from torch_static_common import (
    S, TOL, bert_feed, jax_bert, jax_mlp, jax_save, jax_state_unchanged,
)


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


def _port_save(dirname, main, startup, feeds, fetches, **kw):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        io.save_inference_model(dirname, feeds, list(fetches), exe, main,
                                **kw)
    return scope


def test_a_jax_directory_loads_in_the_port(tmp_path):
    main, startup, feeds, fetches = jax_bert()
    d = str(tmp_path / "jax_bert")
    values = jax_save(d, main, startup, feeds, fetches, perturb=0.1)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        prog, got_feeds, fetch_vars = io.load_inference_model(d, exe)
    with jfluid.scope_guard(jfluid.Scope()):
        jprog, jfeeds, jfetch = jio.load_inference_model(
            d, jfluid.Executor(jfluid.CPUPlace()))
    assert prog.to_dict() == jprog.to_dict()
    assert got_feeds == jfeeds == feeds
    assert [v.name for v in fetch_vars] == [v.name for v in jfetch]
    for name, v in values.items():
        t = scope.find_var(name)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), v)


def test_a_port_directory_loads_and_serves_in_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("PADDLE_TPU_FUSED_FFN", raising=False)
    main, startup, feeds, fetches = bert_program.bert_program(
        models.BertConfig.tiny(), S)
    d = str(tmp_path / "port_bert")
    scope = _port_save(d, main, startup, feeds, fetches)
    assert os.path.exists(os.path.join(d, "__model__.json"))
    with jfluid.scope_guard(jfluid.Scope()):
        jscope = jfluid.global_scope()
        jprog, jfeeds, jfetch = jio.load_inference_model(
            d, jfluid.Executor(jfluid.CPUPlace()))
        for p in main.all_parameters():
            np.testing.assert_array_equal(
                np.asarray(jscope.find_var(p.name)),
                scope.find_var(p.name).numpy())
    port_prog = io.load_inference_model(
        d, fluid.Executor(fluid.CPUPlace()))[0]
    assert jprog.to_dict() == port_prog.to_dict()
    assert jfeeds == feeds
    feed = bert_feed()
    want = jax_predictor(JaxConfig(d)).run(feed)
    got = create_predictor(AnalysisConfig(d), device="cpu").run(feed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_the_pruned_program_is_the_jax_one(tmp_path):
    jmain, jstart, feeds, (jseq, jpooled) = jax_bert()
    main, start, _, (seq, pooled) = bert_program.bert_program(
        models.BertConfig.tiny(), S)
    for targets in ([jpooled.name], [jseq.name, jpooled.name]):
        want = jio._prune_program(jmain, feeds, targets)
        got = io._prune_program(main, feeds, targets)
        assert got.to_dict() == want.to_dict()
        assert all(o.attrs["is_test"] for o in got.global_block.ops
                   if o.type == "dropout")


@pytest.mark.parametrize("filename", [None, "params.npz"])
def test_vars_round_trip_through_both_packages(tmp_path, filename):
    main, startup, feeds, fetches = jax_mlp()
    d = str(tmp_path / "vars")
    exe = fluid.Executor(fluid.CPUPlace())
    port_main = fluid.Program.from_json(main.to_json())
    src = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(
        fluid.Program.from_json(startup.to_json()), scope=src)
    with fluid.scope_guard(src):
        io.save_persistables(exe, d, port_main, filename=filename)
    dst = fluid.Scope()
    with fluid.scope_guard(dst):
        io.load_params(exe, d, port_main, filename=filename)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jio.load_persistables(jfluid.Executor(jfluid.CPUPlace()), d, main,
                              filename=filename)
    for p in main.all_parameters():
        want = src.find_var(p.name)
        assert torch.equal(dst.find_var(p.name), want)
        np.testing.assert_array_equal(np.asarray(jscope.find_var(p.name)),
                                      want.numpy())


def test_save_refuses_a_broken_program(tmp_path):
    main, startup, feeds, fetches = jax_mlp()
    port_main = fluid.Program.from_json(main.to_json())
    with pytest.raises(ProgramVerificationError, match="missing-fetch|"
                       "static verification"):
        _port_save(str(tmp_path / "bad"), port_main,
                   fluid.Program.from_json(startup.to_json()), feeds,
                   ["no_such_var"])


def test_load_refuses_an_op_the_port_lacks(tmp_path):
    main, startup = jfluid.Program(), jfluid.Program()
    from paddle_tpu.fluid import layers as jlayers
    from paddle_tpu.fluid import unique_name as jun

    with jun.guard(), jfluid.program_guard(main, startup):
        x = jfluid.data("x", [-1, 4, 2, 2], "float32")
        out = jlayers.shuffle_channel(jlayers.scale(x, 2.0), 2)
    d = str(tmp_path / "shuffle_channel")
    jax_save(d, main, startup, ["x"], [out])
    with pytest.raises(ProgramVerificationError) as e:
        io.load_inference_model(d, fluid.Executor(fluid.CPUPlace()))
    assert any(f.code == "unknown-op" and f.op_type == "shuffle_channel"
               for f in e.value.diagnostics.errors())
