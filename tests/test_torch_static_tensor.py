"""The rest of `fluid.layers.tensor` in the port held against
`paddle_tpu.fluid` on the CPU.

* `TENSOR`: the inputs on which each tensor op the layers reach (and
  arg_max, arg_min, argsort, lr_schedule) is held, numpy only
  (`chip_smoke.py`'s op sweep runs the same cases on the card against
  the CPU).  Each case's forward against the JAX lowering within 1e-6,
  integers and booleans exactly (the int64 outputs the reference's
  32-bit JAX computes as int32 compared by `dtypes.recorded`), its
  shapes on meta tensors (build-time inference) the JAX outputs'; each
  ``vjp_grad`` against JAX's within 1e-5, recomputed and taped.
* Every public function of the reference's `layers/tensor.py` and
  `layers/learning_rate_scheduler.py` is in `fluid.layers` with the
  reference's signature; the 45 functions this slice adds (and
  ``assign`` of a numpy array) build the JAX program dict for dict and
  run to JAX's fetches; ``Print`` prints what the JAX one prints.

This module imports numpy and torch only at its top; the JAX package is
imported inside the tests.
"""

import inspect

import numpy as np
import pytest
import torch


def _r(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _i(shape, high, seed=1, dtype=np.int32, low=0):
    return np.random.RandomState(seed).randint(low, high, shape).astype(dtype)


def _b(*shape, seed=2):
    return np.random.RandomState(seed).rand(*shape) > 0.5


# ties in every row and column, for the index ops' first / stable rules
_TIES = np.array([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 1.0, 2.0],
                  [0.5, 0.5, 0.5, 0.5]], np.float32)

# (op type, {slot: [numpy inputs]}, attrs)
TENSOR = {
    "transpose2": ("transpose2", {"X": [_r(2, 3, 4)]}, {"axis": [2, 0, 1]}),
    "flatten2": ("flatten2", {"X": [_r(2, 3, 4, 5)]}, {"axis": 2}),
    "flatten2-axis0": ("flatten2", {"X": [_r(2, 3, 4)]}, {"axis": 0}),
    "squeeze2": ("squeeze2", {"X": [_r(2, 1, 3, 1)]}, {"axes": [1]}),
    "squeeze2-all": ("squeeze2", {"X": [_r(2, 1, 3, 1)]}, {"axes": []}),
    "squeeze2-negative": ("squeeze2", {"X": [_r(2, 1, 3, 1)]},
                          {"axes": [-1]}),
    "unsqueeze2": ("unsqueeze2", {"X": [_r(2, 3)]}, {"axes": [0, 2]}),
    "unsqueeze2-negative": ("unsqueeze2", {"X": [_r(2, 3)]},
                            {"axes": [-1]}),
    "split-num": ("split", {"X": [_r(4, 6)]}, {"num": 3, "axis": 1}),
    "split-sections": ("split", {"X": [_r(4, 6)]},
                       {"sections": [1, 2, 3], "axis": 1}),
    "split-sections-rest": ("split", {"X": [_r(5, 2)]},
                            {"sections": [2, -1], "axis": 0}),
    "stack": ("stack", {"X": [_r(2, 3), _r(2, 3, seed=1), _r(2, 3, seed=2)]},
              {"axis": 1}),
    "unstack": ("unstack", {"X": [_r(3, 2, 4)]}, {"axis": 1}),
    "assign_value": ("assign_value", {},
                     {"shape": [2, 3], "dtype": "float32",
                      "values": _r(6).tolist()}),
    "assign_value-int32": ("assign_value", {},
                           {"shape": [3], "dtype": "int32",
                            "values": [4, -1, 7]}),
    "fill_constant_batch_size_like": (
        "fill_constant_batch_size_like", {"Input": [_r(5, 3)]},
        {"shape": [-1, 4], "value": 2.5, "dtype": "float32",
         "input_dim_idx": 0, "output_dim_idx": 0}),
    "fill_constant_batch_size_like-dims": (
        "fill_constant_batch_size_like", {"Input": [_r(5, 3)]},
        {"shape": [2, -1], "value": -1.0, "dtype": "int32",
         "input_dim_idx": 1, "output_dim_idx": 1}),
    "fill_any_like": ("fill_any_like", {"X": [_r(3, 4)]}, {"value": 1.0}),
    "fill_any_like-int32": ("fill_any_like", {"X": [_r(3, 4)]},
                            {"value": 7.0, "dtype": "int32"}),
    # a repeated index: its rows' gradients add up
    "gather": ("gather", {"X": [_r(5, 3)],
                          "Index": [np.array([4, 0, 2, 2], np.int64)]},
               {"axis": 0}),
    "gather-axis1": ("gather", {"X": [_r(2, 5, 3)],
                                "Index": [np.array([3, 1], np.int32)]},
                     {"axis": 1}),
    "gather_nd": ("gather_nd", {"X": [_r(3, 4, 5)],
                                "Index": [np.array([[0, 1], [2, 3], [1, 0],
                                                    [0, 1]], np.int64)]},
                  {}),
    # overwrite on unique ids (repeated ones name no winner on the card);
    # adding, repeated ids sum
    "scatter-overwrite": ("scatter",
                          {"X": [_r(5, 3)],
                           "Ids": [np.array([4, 0, 2], np.int64)],
                           "Updates": [_r(3, 3, seed=1)]},
                          {"overwrite": True}),
    "scatter-add": ("scatter",
                    {"X": [_r(5, 3)], "Ids": [np.array([1, 3, 1], np.int64)],
                     "Updates": [_r(3, 3, seed=1)]},
                    {"overwrite": False}),
    "one_hot": ("one_hot", {"X": [_i((4, 1), 6, dtype=np.int64)]},
                {"depth": 6}),
    # an id outside [0, depth) gives a zero row
    "one_hot-out-of-range": ("one_hot",
                             {"X": [np.array([[0, 4, -1], [5, 2, 4]],
                                             np.int32)]},
                             {"depth": 5}),
    "expand": ("expand", {"X": [_r(2, 3)]}, {"expand_times": [2, 3]}),
    "expand-unit-dim": ("expand", {"X": [_r(2, 1, 3)]},
                        {"expand_times": [1, 4, 1]}),
    "tile-fewer": ("tile", {"X": [_r(2, 3)]}, {"repeat_times": [3]}),
    "tile-more": ("tile", {"X": [_r(2, 3)]}, {"repeat_times": [2, 1, 2]}),
    "pad": ("pad", {"X": [_r(2, 3)]}, {"paddings": [1, 0, 2, 1],
                                       "pad_value": 0.5}),
    "pad-3d": ("pad", {"X": [_r(2, 3, 2)]}, {"paddings": [0, 1, 1, 1, 0, 2]}),
    "arange-int64": ("arange", {}, {"start": 0.0, "end": 7.0, "step": 2.0,
                                    "dtype": "int64"}),
    "arange-float32": ("arange", {}, {"start": 0.5, "end": 3.0, "step": 0.5,
                                      "dtype": "float32"}),
    "linspace": ("linspace", {}, {"start": -1.0, "stop": 2.0, "num": 7,
                                  "dtype": "float32"}),
    "equal-int32": ("equal", {"X": [_i((3, 4), 3)],
                              "Y": [_i((3, 4), 3, seed=2)]}, {}),
    "not_equal-broadcast": ("not_equal", {"X": [_i((3, 4), 3)],
                                          "Y": [_i((4,), 3, seed=2)]}, {}),
    "less_than": ("less_than", {"X": [_r(3, 4)], "Y": [_r(4, seed=1)]}, {}),
    "greater_than": ("greater_than", {"X": [_r(3, 4)],
                                      "Y": [_r(3, 4, seed=1)]}, {}),
    "logical_and": ("logical_and", {"X": [_b(3, 4)], "Y": [_b(3, 4, seed=3)]},
                    {}),
    "logical_or": ("logical_or", {"X": [_b(3, 4)], "Y": [_b(3, 4, seed=3)]},
                   {}),
    "logical_not": ("logical_not", {"X": [_b(3, 4)]}, {}),
    # each branch's gradient only where it was chosen
    "where": ("where", {"Condition": [_b(3, 4)], "X": [_r(3, 4)],
                        "Y": [_r(3, 4, seed=1)]}, {}),
    "where-broadcast": ("where", {"Condition": [_b(3, 1)], "X": [_r(3, 4)],
                                  "Y": [_r(4, seed=1)]}, {}),
    "shape": ("shape", {"Input": [_r(2, 3, 4)]}, {}),
    "size": ("size", {"Input": [_r(2, 3, 4)]}, {}),
    "increment": ("increment", {"X": [np.array([3.0], np.float32)]},
                  {"step": 1.0}),
    "increment-int32": ("increment", {"X": [np.array([3, 4], np.int32)]},
                        {"step": 2.0}),
    "print": ("print", {"In": [_r(3, 4)]},
              {"message": "case", "summarize": 5,
               "print_tensor_shape": True}),
    "crop_tensor": ("crop_tensor", {"X": [_r(4, 5, 6)]},
                    {"shape": [2, -1, 3], "offsets": [1, 2, 2]}),
    # offsets past the end are clamped so that the window fits
    "crop_tensor-clamped": ("crop_tensor", {"X": [_r(4, 5, 6)]},
                            {"shape": [3, 3, 3], "offsets": [3, 0, 5]}),
    "crop_tensor-no-offsets": ("crop_tensor", {"X": [_r(4, 5)]},
                               {"shape": [2, 0], "offsets": []}),
    "unbind": ("unbind", {"X": [_r(3, 4)]}, {"axis": 1}),
    "gather_tree": ("gather_tree",
                    {"Ids": [_i((4, 2, 3), 10, dtype=np.int64)],
                     "Parents": [_i((4, 2, 3), 3, seed=4, dtype=np.int64)]},
                    {}),
    "masked_fill": ("masked_fill", {"X": [_r(3, 4)], "Mask": [_b(3, 4)]},
                    {"value": 2.5}),
    "masked_fill-int-mask": ("masked_fill",
                             {"X": [_r(3, 4)],
                              "Mask": [_b(3, 4).astype(np.int32)]},
                             {"value": -1e4}),
    "partial_sum": ("partial_sum", {"X": [_r(3, 5), _r(3, 5, seed=1)]},
                    {"start_index": 1, "length": 2}),
    "partial_sum-negative-start": ("partial_sum",
                                   {"X": [_r(3, 5), _r(3, 5, seed=1)]},
                                   {"start_index": -3, "length": 3}),
    "partial_concat": ("partial_concat",
                       {"X": [_r(3, 5), _r(3, 5, seed=1), _r(3, 5, seed=2)]},
                       {"start_index": 2, "length": -1}),
    "arg_max": ("arg_max", {"X": [_r(3, 5)]}, {"axis": 1, "keepdims": True}),
    "arg_max-ties": ("arg_max", {"X": [_TIES]}, {"axis": 0}),
    "arg_min-ties": ("arg_min", {"X": [_TIES]}, {"axis": -1}),
    "argsort": ("argsort", {"X": [_r(3, 5)]}, {"axis": -1}),
    "argsort-descending-ties": ("argsort", {"X": [_TIES]},
                                {"axis": 1, "descending": True}),
    "argsort-ties-axis0": ("argsort", {"X": [_TIES]}, {"axis": 0}),
}

_STEP = np.array([7.0], np.float32)
LR_SCHEDULES = {
    "noam": {"kind": "noam", "d_model": 512.0, "warmup_steps": 4.0,
             "learning_rate": 2.0},
    "exponential": {"kind": "exponential", "learning_rate": 0.1,
                    "decay_steps": 3.0, "decay_rate": 0.5,
                    "staircase": False},
    "exponential-staircase": {"kind": "exponential", "learning_rate": 0.1,
                              "decay_steps": 3.0, "decay_rate": 0.5,
                              "staircase": True},
    "natural_exp": {"kind": "natural_exp", "learning_rate": 0.1,
                    "decay_steps": 3.0, "decay_rate": 0.5,
                    "staircase": True},
    "inverse_time": {"kind": "inverse_time", "learning_rate": 0.1,
                     "decay_steps": 3.0, "decay_rate": 0.5,
                     "staircase": False},
    "polynomial": {"kind": "polynomial", "learning_rate": 0.1,
                   "decay_steps": 10.0, "end_learning_rate": 0.001,
                   "power": 2.0, "cycle": False},
    "polynomial-cycle": {"kind": "polynomial", "learning_rate": 0.1,
                         "decay_steps": 3.0, "end_learning_rate": 0.001,
                         "power": 1.0, "cycle": True},
    "cosine": {"kind": "cosine", "learning_rate": 0.1,
               "step_each_epoch": 2.0, "epochs": 10.0},
    "piecewise": {"kind": "piecewise", "boundaries": [3.0, 7.0, 9.0],
                  "values": [0.1, 0.05, 0.01, 0.001]},
    "warmup": {"kind": "warmup", "warmup_steps": 10.0, "start_lr": 0.0,
               "end_lr": 0.1, "main_lr": 0.5},
}
TENSOR.update({"lr_schedule-" + k: ("lr_schedule", {"Step": [_STEP]}, a)
               for k, a in LR_SCHEDULES.items()})

# int64 outputs the reference's 32-bit JAX computes as int32
RECORDED_INT64 = {"shape", "size", "arg_max", "arg_min", "argsort",
                  "arange", "gather_tree"}
FWD_TOL = dict(rtol=1e-6, atol=1e-6)

# the op types of this slice: TENSOR's, every one a case
NEW_OP_TYPES = sorted({c[0] for c in TENSOR.values()})


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    from torch_static_common import jax_state_unchanged

    with jax_state_unchanged():
        yield


def test_the_slice_registers_its_41_op_types():
    from paddle_tpu.fluid.core import registry as jregistry
    from paddle_tpu_torch.fluid.core import registry as tregistry

    assert len(NEW_OP_TYPES) == 41
    assert set(NEW_OP_TYPES) <= set(tregistry.registered_ops())
    for t in NEW_OP_TYPES:
        mine, ref = tregistry.get_op_def(t), jregistry.get_op_def(t)
        assert (mine.input_slots, mine.output_slots, mine.no_grad_slots,
                mine.grad_maker is None) == (
            ref.input_slots, ref.output_slots, ref.no_grad_slots,
            ref.grad_maker is None), t


@pytest.mark.parametrize("case", sorted(TENSOR))
def test_tensor_op_matches_the_jax_lowering(case, capsys):
    from paddle_tpu_torch.fluid.core import dtypes as tdtypes
    from test_torch_static_ops import _jax_run, _port_run

    op_type, ins, attrs = TENSOR[case]
    want = _jax_run(op_type, ins, attrs)
    got = _port_run(op_type, ins, attrs)
    meta = _port_run(op_type, ins, attrs, device="meta")
    assert sorted(got) == sorted(want)
    for slot in want:
        assert len(got[slot]) == len(meta[slot]) == len(want[slot])
        for g, m, w in zip(got[slot], meta[slot], want[slot]):
            dtype = (tdtypes.recorded(g.dtype) if op_type in RECORDED_INT64
                     else tdtypes.to_str(g.dtype))
            assert dtype == str(w.dtype), (case, slot)
            assert tuple(m.shape) == w.shape == tuple(g.shape), (case, slot)
            assert m.dtype == g.dtype, (case, slot)
            if g.is_floating_point():
                np.testing.assert_allclose(g.numpy(), w, **FWD_TOL,
                                           err_msg="%s %s" % (case, slot))
            else:
                np.testing.assert_array_equal(g.numpy(), w,
                                              err_msg="%s %s" % (case, slot))
    if op_type == "print":
        out = capsys.readouterr().out.splitlines()
        assert out[0] == out[1] and out[0].startswith("case shape=(3, 4)")


def grad_cases():
    """The cases whose op differentiates a floating input."""
    from paddle_tpu_torch.fluid.core import registry as tregistry

    out = []
    for name, (op_type, ins, attrs) in sorted(TENSOR.items()):
        opdef = tregistry.get_op_def(op_type)
        if opdef.grad_maker is None:
            continue
        if any(s not in opdef.no_grad_slots
               and all(np.issubdtype(a.dtype, np.floating) for a in arrs)
               for s, arrs in ins.items()):
            out.append(name)
    return out


@pytest.mark.parametrize("case", grad_cases())
@pytest.mark.parametrize("taped", [False, True])
def test_tensor_vjp_grad_matches_the_jax_vjp_grad(case, taped):
    from test_torch_static_backward import assert_vjp_grad_matches

    assert_vjp_grad_matches(case, *TENSOR[case], taped)


def test_where_and_masked_fill_pass_gradient_only_where_chosen():
    from test_torch_static_backward import vjp_pair

    op_type, ins, attrs = TENSOR["where"]
    got, _ = vjp_pair(op_type, ins, attrs, taped=False)
    cond = ins["Condition"][0]
    assert (got["DX$X"][0].numpy()[~cond] == 0).all()
    assert (got["DX$Y"][0].numpy()[cond] == 0).all()
    op_type, ins, attrs = TENSOR["masked_fill"]
    got, _ = vjp_pair(op_type, ins, attrs, taped=False)
    assert (got["DX$X"][0].numpy()[ins["Mask"][0]] == 0).all()


def test_every_case_lies_in_its_op_domain():
    """Finite outputs everywhere, so no parity check compares NaNs."""
    from paddle_tpu_torch.fluid.core import registry

    for case, (op_type, ins, attrs) in TENSOR.items():
        outs = registry.get_op_def(op_type).lower(
            registry.LowerContext(),
            {k: [torch.from_numpy(a) for a in v] for k, v in ins.items()},
            attrs)
        assert all(torch.isfinite(o).all() for v in outs.values()
                   for o in v if o.is_floating_point()), case


# ---------------------------------------------------------------------------
# the layer functions
# ---------------------------------------------------------------------------


def _public_functions(module):
    return {n: v for n, v in vars(module).items()
            if inspect.isfunction(v) and not n.startswith("_")
            and v.__module__ == module.__name__}


@pytest.mark.parametrize("module", ["tensor", "learning_rate_scheduler"])
def test_fluid_layers_has_every_public_function_with_its_signature(module):
    import importlib

    from paddle_tpu_torch.fluid import layers

    ref = _public_functions(importlib.import_module(
        "paddle_tpu.fluid.layers." + module))
    mine = importlib.import_module("paddle_tpu_torch.fluid.layers." + module)
    for name, fn in sorted(ref.items()):
        assert hasattr(layers, name), name
        got = getattr(mine, name)
        assert getattr(layers, name) is got, name
        assert inspect.signature(got) == inspect.signature(fn), name


# data vars each build reads: name -> (shape, dtype, value)
FEED = {
    "x": ([3, 4], "float32", _r(3, 4, seed=5)),
    "y": ([3, 4], "float32", _r(3, 4, seed=6)),
    "b": ([3, 4], "bool", _b(3, 4, seed=7)),
    "c": ([3, 4], "bool", _b(3, 4, seed=8)),
    "idx": ([3], "int64", np.array([2, 0, 1], np.int64)),
    "nd": ([2, 2], "int64", np.array([[0, 1], [2, 3]], np.int64)),
    "ids": ([4, 2, 3], "int64", _i((4, 2, 3), 10, dtype=np.int64)),
    "parents": ([4, 2, 3], "int64", _i((4, 2, 3), 3, seed=4,
                                         dtype=np.int64)),
    "label": ([3, 1], "int64", np.array([[1], [3], [0]], np.int64)),
    "upd": ([3, 4], "float32", _r(3, 4, seed=9)),
}


def _d(L, name):
    shape, dtype, _ = FEED[name]
    return L.data(name, shape=shape, dtype=dtype, append_batch_size=False)


LAYER_BUILDS = {
    "Print": lambda L: [L.Print(_d(L, "x"), message="m", summarize=3)],
    "arange": lambda L: [L.arange(0, 10, 2, "int64")],
    "argmax": lambda L: [L.argmax(_d(L, "x"), axis=1, keepdims=True)],
    "argmin": lambda L: [L.argmin(_d(L, "x"), axis=0)],
    "argsort": lambda L: list(L.argsort(_d(L, "x"), axis=0,
                                        descending=True)),
    "create_parameter": lambda L: [_d(L, "x") + L.create_parameter(
        [3, 4], name="w")],
    "crop_tensor": lambda L: [L.crop_tensor(_d(L, "x"), [2, 2], [1, 1])],
    "equal": lambda L: [L.equal(_d(L, "x"), _d(L, "y"))],
    "expand": lambda L: [L.expand(_d(L, "x"), [2, 1])],
    "fill_constant_batch_size_like": lambda L: [
        L.fill_constant_batch_size_like(_d(L, "x"), [-1, 5], "float32",
                                        0.5)],
    "flatten": lambda L: [L.flatten(_d(L, "x"), axis=0)],
    "full_like": lambda L: [L.full_like(_d(L, "x"), 3.0, "int32")],
    "gather": lambda L: [L.gather(_d(L, "x"), _d(L, "idx"))],
    "gather_nd": lambda L: [L.gather_nd(_d(L, "x"), _d(L, "nd"))],
    "gather_tree": lambda L: [L.gather_tree(_d(L, "ids"),
                                            _d(L, "parents"))],
    "greater_than": lambda L: [L.greater_than(_d(L, "x"), _d(L, "y"))],
    "increment": lambda L: [L.increment(L.fill_constant([1], "float32", 2),
                                        value=3.0),
                            L.increment(L.fill_constant([1], "int32", 2),
                                        in_place=False)],
    "less_than": lambda L: [L.less_than(_d(L, "x"), _d(L, "y"))],
    "linspace": lambda L: [L.linspace(0, 1, 5)],
    "logical_and": lambda L: [L.logical_and(_d(L, "b"), _d(L, "c"))],
    "logical_not": lambda L: [L.logical_not(_d(L, "b"))],
    "logical_or": lambda L: [L.logical_or(_d(L, "b"), _d(L, "c"))],
    "masked_fill": lambda L: [L.masked_fill(_d(L, "x"), _d(L, "b"), -1.0)],
    "not_equal": lambda L: [L.not_equal(_d(L, "x"), _d(L, "y"))],
    "one_hot": lambda L: [L.one_hot(_d(L, "label"), 5)],
    "ones": lambda L: [L.ones([2, 3], "int64")],
    "ones_like": lambda L: [L.ones_like(_d(L, "x"))],
    "pad": lambda L: [L.pad(_d(L, "x"), [1, 0, 0, 2], 9.0)],
    "partial_concat": lambda L: [L.partial_concat([_d(L, "x"), _d(L, "y")],
                                                  1, 2)],
    "partial_sum": lambda L: [L.partial_sum([_d(L, "x"), _d(L, "y")], -2)],
    "range": lambda L: [L.range(1.0, 4.0, 0.5, "float32")],
    "scatter": lambda L: [L.scatter(_d(L, "x"), _d(L, "idx"),
                                    _d(L, "upd"))],
    "shape": lambda L: [L.shape(_d(L, "x"))],
    "size": lambda L: [L.size(_d(L, "x"))],
    "split": lambda L: (L.split(_d(L, "x"), 2) +
                        L.split(_d(L, "y"), [1, 3], dim=1)),
    "squeeze": lambda L: [L.squeeze(L.unsqueeze(_d(L, "x"), [1]), [1])],
    "stack": lambda L: [L.stack([_d(L, "x"), _d(L, "y")], axis=1)],
    "tile": lambda L: [L.tile(_d(L, "x"), [1, 2, 1])],
    "transpose": lambda L: [L.transpose(_d(L, "x"), [1, 0])],
    "unbind": lambda L: L.unbind(_d(L, "x"), axis=1),
    "unsqueeze": lambda L: [L.unsqueeze(_d(L, "x"), [0, 3])],
    "unstack": lambda L: L.unstack(_d(L, "x")),
    "where": lambda L: [L.where(_d(L, "b"), _d(L, "x"), _d(L, "y"))],
    "zeros": lambda L: [L.zeros([4], "float32")],
    "zeros_like": lambda L: [L.zeros_like(_d(L, "x"))],
    "assign-numpy": lambda L: [L.assign(_r(2, 3, seed=3)),
                               L.assign(np.arange(4, dtype=np.int32))],
}


def test_the_builds_cover_the_45_functions():
    assert len(set(LAYER_BUILDS) - {"assign-numpy"}) == 45


def _build_both(fn):
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid import layers as jlayers
    from paddle_tpu.fluid import unique_name as jun
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import layers, unique_name

    out = []
    for pkg, L, guard in ((jfluid, jlayers, jun.guard),
                          (fluid, layers, unique_name.guard)):
        main, startup = pkg.Program(), pkg.Program()
        with guard(), pkg.program_guard(main, startup):
            fetches = fn(L)
        out.append((main, startup, fetches))
    return out


@pytest.mark.parametrize("name", sorted(LAYER_BUILDS))
def test_layer_builds_the_jax_program_and_runs_to_its_fetches(name, capsys):
    import jax
    import paddle_tpu.fluid as jfluid
    from paddle_tpu_torch import fluid

    (jmain, jstart, jout), (main, start, out) = _build_both(
        LAYER_BUILDS[name])
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()
    assert [v.name for v in out] == [v.name for v in jout]
    feed = {n: FEED[n][2] for n in FEED
            if main.global_block.has_var(n)}
    jscope, scope = jfluid.Scope(), fluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        want = jexe.run(jmain, feed=feed, fetch_list=jout)
        jax.effects_barrier()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(start, scope=scope)
    for v in jmain.list_vars():
        if v.persistable and jscope.has(v.name):
            scope.set(v.name, torch.from_numpy(
                np.array(jscope.find_var(v.name))))
    got = exe.run(main, feed=feed, fetch_list=out, scope=scope)
    for v, g, w in zip(out, got, want):
        assert g.shape == w.shape, v.name
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, **FWD_TOL, err_msg=v.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=v.name)
    if name == "Print":
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == 2 and lines[0] == lines[1], lines
        assert lines[0].startswith("m x shape=(3, 4) values=[")
