"""`paddle_tpu_torch.fluid.ir`'s passes held against `paddle_tpu.fluid.ir`
on the CPU: each pass applied to the same program (built once by the
JAX package, carried to the port through its JSON) must leave the same
program in both packages — op types in order, and the whole ``to_dict``.
"""

import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import ir as jir
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu_torch import fluid, models
from paddle_tpu_torch.analysis import ProgramVerificationError
from paddle_tpu_torch.fluid import ir
from paddle_tpu_torch.models import bert_program

from torch_static_common import S, jax_bert, jax_state_unchanged


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


def _jax_program(build):
    main, startup = jfluid.Program(), jfluid.Program()
    with jun.guard(), jfluid.program_guard(main, startup):
        build()
    return main


def _dead_ops():
    x = jfluid.data("x", [-1, 4], "float32")
    h = jlayers.fc(x, 8, act="relu")
    jlayers.scale(jlayers.fc(h, 2), 3.0)        # nothing reads it
    jlayers.fc(h, 3, act="tanh")


def _bn_act():
    x = jfluid.data("x", [-1, 3, 4, 4], "float32")
    y = jlayers.batch_norm(x)
    jlayers.relu(y)
    jlayers.tanh(jlayers.batch_norm(y))


def _transposes():
    a = jfluid.data("a", [4, 6], "float32")
    b = jfluid.data("b", [5, 6], "float32")
    t = jlayers.transpose(jlayers.transpose(a, [1, 0]), [1, 0])
    jlayers.matmul(t, jlayers.transpose(b, [1, 0]))


def _cases(monkeypatch):
    """Per pass: the program it rewrites first, then one it may leave
    as it is."""
    monkeypatch.delenv("PADDLE_TPU_FUSED_FFN", raising=False)
    bert = jax_bert()[0]
    monkeypatch.setenv("PADDLE_TPU_BERT_HEAD_LAYOUT", "BHSD")
    bert_bhsd = jax_bert()[0]
    monkeypatch.delenv("PADDLE_TPU_BERT_HEAD_LAYOUT")
    dead = _jax_program(_dead_ops)
    return {
        "matmul_bias_act_fuse": [bert, dead],
        "dead_op_elimination": [dead, bert],
        "batch_norm_act_fuse": [_jax_program(_bn_act)],
        "transpose_fold": [bert_bhsd, _jax_program(_transposes)],
    }


@pytest.mark.parametrize("name", ["matmul_bias_act_fuse",
                                  "dead_op_elimination",
                                  "batch_norm_act_fuse", "transpose_fold"])
def test_pass_rewrites_as_the_jax_pass(monkeypatch, name):
    progs = _cases(monkeypatch)[name]
    for i, prog in enumerate(progs):
        keep = [prog.global_block.ops[-1].all_output_names()[0]]
        jp = jfluid.Program.from_json(prog.to_json())
        tp = fluid.Program.from_json(prog.to_json())
        jpass, tpass = jir.get_pass(name), ir.get_pass(name)
        jpass.set("keep", keep)
        tpass.set("keep", keep)
        want = jir.apply_passes(jp, [jpass])
        got = ir.apply_passes(tp, [tpass])
        assert [o.type for o in got.global_block.ops] == \
            [o.type for o in want.global_block.ops]
        assert got.to_dict() == want.to_dict()
        if i == 0:      # the program each pass is meant to rewrite
            assert len(want.global_block.ops) < len(prog.global_block.ops)


def test_fused_bert_has_one_matmul_bias_act_per_ffn_and_the_pooler(
        monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FUSED_FFN", raising=False)
    main = bert_program.bert_program(models.BertConfig.tiny(), S)[0]
    fused = ir.apply_passes(main.clone(), ["matmul_bias_act_fuse"],
                            verify=True)
    ops = [o for o in fused.global_block.ops if o.type == "matmul_bias_act"]
    assert [o.attrs["act_type"] for o in ops] == ["gelu", "gelu", "tanh"]
    assert not any(o.type in ("gelu", "tanh") for o in fused.global_block.ops)
    # clone_and_apply leaves the original alone
    again = ir.clone_and_apply(main, ["matmul_bias_act_fuse"])
    assert again.to_dict()["blocks"] == fused.to_dict()["blocks"]
    assert sum(o.type == "gelu" for o in main.global_block.ops) == 2


def test_verify_names_the_pass_that_broke_the_program():
    main = bert_program.bert_program(models.BertConfig.tiny(), S)[0]

    class Breaker(ir.Pass):
        name = "breaker"

        def apply(self, program):
            program.global_block.ops.pop(0)
            return program

    with pytest.raises(ProgramVerificationError) as e:
        ir.apply_passes(main, [Breaker()], verify=True)
    assert e.value.pass_name == "breaker"
    with pytest.raises(KeyError, match="no pass named"):
        ir.get_pass("no_such_pass")
