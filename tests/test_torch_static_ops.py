"""The port's op library held against the JAX package's lowerings on the
CPU: each registered op of `paddle_tpu_torch.fluid.ops` on the same
seeded numpy inputs and attrs as the JAX op of the same type.

Tolerance f32 rtol 1e-5 (atol 1e-6): the two frameworks sum and round
in another order.  Output dtypes must agree, and the op's lowering on
meta tensors (the port's build-time shape inference) must give the
JAX outputs' shapes.  The random ops cannot match value for value
(torch's generators are not JAX's threefry): they are held to their
law, their dtype and shape, and to one reproducible draw per ``seed``
attr.  Dropout in training mode likewise (keep rate and scaling).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.core import registry as jregistry
from paddle_tpu_torch.fluid.core import dtypes as tdtypes
from paddle_tpu_torch.fluid.core import registry as tregistry

from test_torch_static_surface import SURFACE, _r
from test_torch_static_tensor import TENSOR
from torch_static_common import jax_state_unchanged

RTOL, ATOL = 1e-5, 1e-6
RECORDED_INT64 = {"top_k", "top_k_v2"}


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


def _ids(shape, high, seed=1):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.int64)


# (op type, {slot: [numpy inputs]}, attrs) — every deterministic case
CASES = {
    "reshape2": ("reshape2", {"X": [_r(2, 3, 4)]}, {"shape": [0, -1, 2]}),
    "slice": ("slice", {"Input": [_r(2, 5, 4)]},
              {"axes": [1, 2], "starts": [1, 0], "ends": [4, 100]}),
    "slice-decrease": ("slice", {"Input": [_r(2, 5, 4)]},
                       {"axes": [1], "starts": [0], "ends": [1],
                        "decrease_axis": [1]}),
    "cast-int-to-f32": ("cast", {"X": [_ids((2, 6), 2)]},
                        {"out_dtype": "float32"}),
    "cast-f32-to-int32": ("cast", {"X": [3 * _r(3, 4)]},
                          {"out_dtype": "int32"}),
    "fill_constant": ("fill_constant", {},
                      {"shape": [2, 3], "value": 1.5, "dtype": "float32"}),
    "elementwise_add": ("elementwise_add", {"X": [_r(2, 3, 4)],
                                            "Y": [_r(4, seed=1)]},
                        {"axis": -1}),
    "elementwise_add-axis1": ("elementwise_add",
                              {"X": [_r(2, 3, 4)], "Y": [_r(3, seed=1)]},
                              {"axis": 1}),
    "relu": ("relu", {"X": [_r(3, 7)]}, {}),
    "tanh": ("tanh", {"X": [2 * _r(3, 7)]}, {}),
    "gelu": ("gelu", {"X": [2 * _r(3, 7)]}, {"approximate": False}),
    "gelu-tanh": ("gelu", {"X": [2 * _r(3, 7)]}, {"approximate": True}),
    "scale": ("scale", {"X": [_r(3, 4)]}, {"scale": 2.0, "bias": -1.0}),
    "scale-bias-first": ("scale", {"X": [_r(3, 4)]},
                         {"scale": 10000.0, "bias": -1.0,
                          "bias_after_scale": False}),
    "mul": ("mul", {"X": [_r(2, 3, 8)], "Y": [_r(8, 5, seed=1)]},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "matmul_bias_act-mul-gelu": (
        "matmul_bias_act",
        {"X": [_r(2, 3, 8)], "Y": [_r(8, 5, seed=1)], "Bias": [_r(5, seed=2)]},
        {"act_type": "gelu", "approximate": False, "x_num_col_dims": 2,
         "y_num_col_dims": 1}),
    "matmul_bias_act-matmul-relu": (
        "matmul_bias_act",
        {"X": [_r(6, 8)], "Y": [_r(5, 8, seed=1)], "Bias": [_r(5, seed=2)]},
        {"act_type": "relu", "transpose_Y": True, "alpha": 0.5}),
    "matmul_bias_act-tanh-nobias": (
        "matmul_bias_act", {"X": [_r(4, 2, 8)], "Y": [_r(8, 6, seed=1)]},
        {"act_type": "tanh", "x_num_col_dims": 2, "y_num_col_dims": 1}),
    "matmul_bias_act-batched-y": (
        "matmul_bias_act",
        {"X": [_r(2, 3, 8)], "Y": [_r(2, 8, 5, seed=1)],
         "Bias": [_r(5, seed=2)]},
        {"act_type": "none"}),
    "layer_norm": ("layer_norm",
                   {"X": [3 * _r(2, 3, 8) + 1], "Scale": [_r(8, seed=1)],
                    "Bias": [_r(8, seed=2)]},
                   {"begin_norm_axis": 2, "epsilon": 1e-5}),
    "layer_norm-axis1": ("layer_norm", {"X": [_r(4, 2, 5)]},
                         {"begin_norm_axis": 1, "epsilon": 1e-3}),
    "dropout-test-downgrade": ("dropout", {"X": [_r(3, 4)]},
                               {"dropout_prob": 0.3, "is_test": True}),
    "dropout-test-upscale": ("dropout", {"X": [_r(3, 4)]},
                             {"dropout_prob": 0.3, "is_test": True,
                              "dropout_implementation": "upscale_in_train"}),
    "flash_attention-bshd-bias": (
        "flash_attention",
        {"Q": [_r(2, 5, 3, 8)], "K": [_r(2, 5, 3, 8, seed=1)],
         "V": [_r(2, 5, 3, 8, seed=2)],
         "Bias": [np.where(_ids((2, 1, 1, 5), 2) > 0, 0.0,
                           -1e4).astype(np.float32)]},
        {"scale": 8 ** -0.5, "causal": False, "layout": "BSHD"}),
    "flash_attention-bhsd-causal": (
        "flash_attention",
        {"Q": [_r(2, 3, 4, 8)], "K": [_r(2, 3, 6, 8, seed=1)],
         "V": [_r(2, 3, 6, 8, seed=2)]},
        {"causal": True, "layout": "BHSD"}),
    "flash_attention-segments": (
        "flash_attention",
        {"Q": [_r(2, 6, 2, 8)], "K": [_r(2, 6, 2, 8, seed=1)],
         "V": [_r(2, 6, 2, 8, seed=2)],
         "QSeg": [np.array([[0, 0, 0, 1, 1, 1]] * 2, np.int32)]},
        {"layout": "BSHD"}),
    "lookup_table": ("lookup_table", {"W": [_r(10, 4)], "Ids": [_ids(
        (2, 3), 10)]}, {"padding_idx": -1}),
    "lookup_table-padding": ("lookup_table", {"W": [_r(10, 4)], "Ids": [
        _ids((2, 3, 1), 10)]}, {"padding_idx": 2}),
    "lookup_table_v2": ("lookup_table_v2", {"W": [_r(10, 4)], "Ids": [
        _ids((2, 3), 10)]}, {"padding_idx": 4}),
    # the ops of the static training slice
    "elementwise_sub": ("elementwise_sub", {"X": [_r(2, 3, 4)],
                                            "Y": [_r(4, seed=1)]},
                        {"axis": -1}),
    "elementwise_mul-axis1": ("elementwise_mul", {"X": [_r(2, 3, 4)],
                                                  "Y": [_r(3, seed=1)]},
                              {"axis": 1}),
    "elementwise_div": ("elementwise_div",
                        {"X": [_r(3, 4)],
                         "Y": [np.abs(_r(3, 4, seed=1)) + 0.5]},
                        {"axis": -1}),
    "square": ("square", {"X": [_r(3, 5)]}, {}),
    "square_error_cost": ("square_error_cost",
                          {"X": [_r(4, 1)], "Y": [_r(4, 1, seed=1)]}, {}),
    "matmul-transpose-y": ("matmul", {"X": [_r(2, 3, 8)],
                                      "Y": [_r(5, 8, seed=1)]},
                           {"transpose_X": False, "transpose_Y": True,
                            "alpha": 1.0}),
    "matmul-batched-alpha": ("matmul", {"X": [_r(2, 8, 3)],
                                        "Y": [_r(2, 8, 5, seed=1)]},
                             {"transpose_X": True, "transpose_Y": False,
                              "alpha": 0.5}),
    "sum": ("sum", {"X": [_r(3, 4), _r(3, 4, seed=1), _r(3, 4, seed=2)]},
            {}),
    "reduce_sum-all": ("reduce_sum", {"X": [_r(3, 4)]},
                       {"keep_dim": False, "reduce_all": True}),
    "reduce_sum-dim-keep": ("reduce_sum", {"X": [_r(2, 3, 4)]},
                            {"dim": [1], "keep_dim": True}),
    "reduce_mean-all": ("reduce_mean", {"X": [_r(3, 4)]},
                        {"keep_dim": False, "reduce_all": True}),
    "reduce_mean-dim": ("reduce_mean", {"X": [_r(2, 3, 4)]},
                        {"dim": [-1], "keep_dim": False}),
    "mean": ("mean", {"X": [_r(3, 4)]}, {}),
    "softmax_with_cross_entropy": (
        "softmax_with_cross_entropy",
        {"Logits": [3 * _r(6, 10)], "Label": [_ids((6, 1), 10)]},
        {"soft_label": False, "ignore_index": -100, "axis": -1}),
    "softmax_with_cross_entropy-ignore": (
        "softmax_with_cross_entropy",
        {"Logits": [3 * _r(6, 10)],
         "Label": [np.array([[1], [-100], [4], [9], [-100], [0]],
                            np.int64)]},
        {"soft_label": False, "ignore_index": -100, "axis": -1}),
    "softmax_with_cross_entropy-soft": (
        "softmax_with_cross_entropy",
        {"Logits": [3 * _r(4, 7)],
         "Label": [np.full((4, 7), 1 / 7, np.float32)]},
        {"soft_label": True, "axis": -1}),
    "dropout_grad-upscale": (
        "dropout_grad",
        {"Mask": [_ids((3, 4), 2).astype(np.uint8)],
         "Out@GRAD": [_r(3, 4)]},
        {"dropout_prob": 0.25, "dropout_implementation": "upscale_in_train"}),
    "dropout_grad-downgrade": (
        "dropout_grad",
        {"Mask": [_ids((3, 4), 2).astype(np.uint8)],
         "Out@GRAD": [_r(3, 4)]}, {"dropout_prob": 0.25}),
    "assign": ("assign", {"X": [_r(3, 4)]}, {}),
    "fill_zeros_like": ("fill_zeros_like", {"X": [_r(3, 4)]}, {}),
    "take_along_axis": ("take_along_axis",
                        {"Input": [_r(2, 5, 4)],
                         "Index": [_ids((2, 3, 1), 5)]}, {"Axis": 1}),
    # the vision ops (the Fluid book's programs); the max pools' inputs
    # are tie-free, so both packages route each gradient to one position
    "conv2d-stride2-pad4": ("conv2d", {"Input": [_r(2, 3, 9, 8)],
                                       "Filter": [_r(4, 3, 3, 3, seed=1)]},
                            {"strides": [2, 2], "paddings": [1, 0, 2, 1],
                             "dilations": [1, 1], "groups": 1}),
    "conv2d-same": ("conv2d", {"Input": [_r(2, 3, 9, 8)],
                               "Filter": [_r(4, 3, 4, 3, seed=1)]},
                    {"strides": [2, 3], "paddings": [0, 0],
                     "padding_algorithm": "SAME"}),
    "conv2d-valid-dilation2": ("conv2d", {"Input": [_r(2, 3, 9, 8)],
                                          "Filter": [_r(4, 3, 3, 3, seed=1)]},
                               {"paddings": [1, 1], "dilations": [2, 2],
                                "padding_algorithm": "VALID"}),
    "conv2d-groups2": ("conv2d", {"Input": [_r(2, 4, 6, 6)],
                                  "Filter": [_r(6, 2, 3, 3, seed=1)]},
                       {"paddings": [1, 1], "groups": 2}),
    "conv2d-nhwc": ("conv2d", {"Input": [_r(2, 7, 6, 3)],
                               "Filter": [_r(5, 3, 3, 3, seed=1)]},
                    {"strides": [1, 2], "paddings": [1, 1],
                     "data_format": "NHWC"}),
    "depthwise_conv2d": ("depthwise_conv2d",
                         {"Input": [_r(2, 3, 7, 7)],
                          "Filter": [_r(3, 1, 3, 3, seed=1)]},
                         {"strides": [2, 2], "paddings": [1, 1]}),
    "pool2d-max": ("pool2d", {"X": [_r(2, 3, 8, 7)]},
                   {"pooling_type": "max", "ksize": [2, 2],
                    "strides": [2, 2], "paddings": [0, 0]}),
    "pool2d-max-padded": ("pool2d", {"X": [_r(2, 3, 8, 7)]},
                          {"pooling_type": "max", "ksize": [3, 3],
                           "strides": [2, 2], "paddings": [1, 1]}),
    "pool2d-avg-exclusive-padded": ("pool2d", {"X": [_r(2, 3, 8, 7)]},
                                    {"pooling_type": "avg", "ksize": [3, 3],
                                     "strides": [2, 2], "paddings": [1, 1],
                                     "exclusive": True}),
    "pool2d-avg-inclusive-padded": ("pool2d", {"X": [_r(2, 3, 8, 7)]},
                                    {"pooling_type": "avg", "ksize": [3, 2],
                                     "strides": [1, 2], "paddings": [1, 1],
                                     "exclusive": False}),
    "pool2d-global-avg": ("pool2d", {"X": [_r(2, 3, 5, 6)]},
                          {"pooling_type": "avg", "ksize": [1, 1],
                           "global_pooling": True}),
    "pool2d-adaptive-max": ("pool2d", {"X": [_r(2, 3, 8, 6)]},
                            {"pooling_type": "max", "ksize": [4, 3],
                             "adaptive": True}),
    "pool2d-adaptive-avg-uneven": ("pool2d", {"X": [_r(2, 3, 7, 5)]},
                                   {"pooling_type": "avg", "ksize": [3, 2],
                                    "adaptive": True}),
    "pool2d-adaptive-max-uneven-nhwc": ("pool2d", {"X": [_r(2, 7, 5, 3)]},
                                        {"pooling_type": "max",
                                         "ksize": [3, 4], "adaptive": True,
                                         "data_format": "NHWC"}),
    "batch_norm-train": ("batch_norm",
                         {"X": [2 * _r(4, 3, 5, 5) + 3],
                          "Scale": [_r(3, seed=1)], "Bias": [_r(3, seed=2)],
                          "Mean": [_r(3, seed=3)],
                          "Variance": [np.abs(_r(3, seed=4)) + 0.5]},
                         {"momentum": 0.9, "epsilon": 1e-5,
                          "is_test": False, "data_layout": "NCHW"}),
    "batch_norm-train-2d": ("batch_norm",
                            {"X": [_r(6, 5)], "Scale": [_r(5, seed=1)],
                             "Bias": [_r(5, seed=2)],
                             "Mean": [_r(5, seed=3)],
                             "Variance": [np.abs(_r(5, seed=4)) + 0.5]},
                            {"is_test": False}),
    "batch_norm-test": ("batch_norm",
                        {"X": [_r(4, 3, 5, 5)], "Scale": [_r(3, seed=1)],
                         "Bias": [_r(3, seed=2)], "Mean": [_r(3, seed=3)],
                         "Variance": [np.abs(_r(3, seed=4)) + 0.5]},
                        {"is_test": True, "epsilon": 1e-5}),
    "batch_norm-test-nhwc": ("batch_norm",
                             {"X": [_r(2, 4, 5, 3)],
                              "Scale": [_r(3, seed=1)],
                              "Bias": [_r(3, seed=2)],
                              "Mean": [_r(3, seed=3)],
                              "Variance": [np.abs(_r(3, seed=4)) + 0.5]},
                             {"is_test": True, "data_layout": "NHWC"}),
    "fused_batch_norm_act-relu": ("fused_batch_norm_act",
                                  {"X": [_r(4, 3, 5, 5)],
                                   "Scale": [_r(3, seed=1)],
                                   "Bias": [_r(3, seed=2)],
                                   "Mean": [_r(3, seed=3)],
                                   "Variance": [np.abs(_r(3, seed=4)) + 0.5]},
                                  {"act_type": "relu", "is_test": False}),
    "fused_batch_norm_act-sigmoid-test": (
        "fused_batch_norm_act",
        {"X": [_r(6, 5)], "Scale": [_r(5, seed=1)], "Bias": [_r(5, seed=2)],
         "Mean": [_r(5, seed=3)], "Variance": [np.abs(_r(5, seed=4)) + 0.5]},
        {"act_type": "sigmoid", "is_test": True}),
    "softmax": ("softmax", {"X": [3 * _r(4, 10)]}, {"axis": -1}),
    "softmax-axis1": ("softmax", {"X": [_r(2, 5, 3)]}, {"axis": 1}),
    "sigmoid": ("sigmoid", {"X": [3 * _r(3, 7)]}, {}),
    # probabilities on both clip bounds: 1.0 passes half its gradient,
    # 0.0 none, as jnp.clip's
    "cross_entropy": ("cross_entropy",
                      {"X": [np.array([[0.2, 0.5, 0.3], [1.0, 0.0, 0.0],
                                       [0.1, 0.1, 0.8], [0.0, 1.0, 0.0]],
                                      np.float32)],
                       "Label": [np.array([[2], [0], [1], [2]], np.int64)]},
                      {"soft_label": False}),
    "cross_entropy-soft": ("cross_entropy",
                           {"X": [np.abs(_r(4, 6)) / 3 + 0.01],
                            "Label": [np.full((4, 6), 1 / 6, np.float32)]},
                           {"soft_label": True}),
    "top_k": ("top_k", {"X": [_r(5, 8)]}, {"k": 3}),
    "top_k_v2": ("top_k_v2", {"X": [_r(2, 3, 6)]}, {"k": 2}),
    "accuracy": ("accuracy",
                 {"Out": [_r(6, 2)],
                  "Indices": [np.array([[0, 1], [2, 3], [4, 5], [6, 7],
                                        [8, 9], [1, 0]], np.int64)],
                  "Label": [np.array([[1], [3], [0], [6], [5], [2]],
                                     np.int64)]}, {}),
}


CASES.update(SURFACE)


def _jax_run(op_type, ins, attrs):
    ctx = jregistry.LowerContext(base_key=jax.random.PRNGKey(0),
                                 is_test=False)
    out = jregistry.get_op_def(op_type).lower(
        ctx, {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}, attrs)
    return {k: [np.asarray(a) for a in v] for k, v in out.items()}


def _port_run(op_type, ins, attrs, device="cpu", generator=None):
    ctx = tregistry.LowerContext(generator=generator, device=device)
    conv = {k: [torch.from_numpy(a).to(device) for a in v]
            for k, v in ins.items()}
    with torch.no_grad():
        return tregistry.get_op_def(op_type).lower(ctx, conv, attrs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_the_jax_lowering(case):
    op_type, ins, attrs = CASES[case]
    want = _jax_run(op_type, ins, attrs)
    got = _port_run(op_type, ins, attrs)
    meta = _port_run(op_type, ins, attrs, device="meta")
    assert sorted(got) == sorted(want)
    for slot in want:
        for g, m, w in zip(got[slot], meta[slot], want[slot]):
            # top_k's int64 indices run int64 and are recorded int32, as
            # the reference's 32-bit JAX computes them; every other
            # output's dtype is JAX's exactly
            dtype = (tdtypes.recorded(g.dtype) if op_type in RECORDED_INT64
                     else tdtypes.to_str(g.dtype))
            assert dtype == str(w.dtype), slot
            assert tuple(m.shape) == w.shape and m.dtype == g.dtype, slot
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL,
                                       err_msg="%s %s" % (case, slot))


def test_every_registered_op_has_a_case():
    # the update ops are held in test_torch_static_train.py and vjp_grad
    # in test_torch_static_backward.py
    from paddle_tpu_torch.fluid.framework import OPTIMIZER_OP_TYPES

    # the tensor ops of `fluid.layers.tensor`, arg_max / arg_min /
    # argsort and lr_schedule are held in test_torch_static_tensor.py
    covered = {c[0] for c in CASES.values()} | {"gaussian_random",
                                                 "uniform_random",
                                                 "vjp_grad"} | {
        c[0] for c in TENSOR.values()}
    assert covered | OPTIMIZER_OP_TYPES == set(tregistry.registered_ops())


@pytest.mark.parametrize("op_type,attrs,mean,std", [
    ("gaussian_random", {"mean": 0.5, "std": 2.0}, 0.5, 2.0),
    ("uniform_random", {"min": -1.0, "max": 3.0}, 1.0, 4 / 12 ** 0.5),
])
def test_random_ops_follow_the_jax_law(op_type, attrs, mean, std):
    attrs = dict(attrs, shape=[64, 128], dtype="float32")
    want = _jax_run(op_type, {}, attrs)["Out"][0]
    got = _port_run(op_type, {}, attrs,
                    generator=torch.Generator().manual_seed(0))["Out"][0]
    meta = _port_run(op_type, {}, attrs, device="meta")["Out"][0]
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert tuple(got.shape) == want.shape == tuple(meta.shape)
    n = got.numel()
    for x in (got.numpy(), want):
        assert abs(x.mean() - mean) < 5 * std / n ** 0.5
        assert abs(x.std() - std) < 0.05 * std
    if op_type == "uniform_random":
        assert got.min() >= -1.0 and got.max() < 3.0
    # a nonzero seed attr gives the op a generator of its own
    seeded = dict(attrs, seed=7)
    a = _port_run(op_type, {}, seeded,
                  generator=torch.Generator().manual_seed(1))["Out"][0]
    b = _port_run(op_type, {}, seeded,
                  generator=torch.Generator().manual_seed(2))["Out"][0]
    assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="torch.Generator"):
        _port_run(op_type, {}, attrs)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_training_keeps_and_scales_as_jax(impl):
    x = np.ones((256, 256), np.float32)
    attrs = {"dropout_prob": 0.25, "dropout_implementation": impl}
    want = _jax_run("dropout", {"X": [x]}, attrs)
    got = _port_run("dropout", {"X": [x]}, attrs,
                    generator=torch.Generator().manual_seed(0))
    scale = 1 / 0.75 if impl == "upscale_in_train" else 1.0
    for out, mask in ((got["Out"][0].numpy(), got["Mask"][0].numpy()),
                      (want["Out"][0], want["Mask"][0])):
        assert mask.dtype == np.uint8
        assert abs(mask.mean() - 0.75) < 0.01
        np.testing.assert_allclose(out, mask * scale, rtol=1e-6)
