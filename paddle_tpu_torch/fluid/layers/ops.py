"""Op wrappers: the activations, the elementwise ops, reductions,
softmax, matmul, the linalg and breadth ops, and cos_sim (counterpart
of `paddle_tpu/fluid/layers/ops.py`, every public function of it, with
its signatures and attrs; the unary ones generated from ``_UNARY`` as
the reference generates them).
"""

import sys

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from .common import append_simple_op

_UNARY = [
    "relu", "sigmoid", "tanh", "exp", "log", "sqrt", "rsqrt", "abs",
    "square", "reciprocal", "floor", "ceil", "round", "sin", "cos",
    "softplus", "softsign", "silu", "erf", "sign", "logsigmoid",
    # the breadth table (extra_ops.py; cf. activation_op.cc full registry)
    "sinh", "cosh", "tan", "asin", "acos", "atan", "asinh", "acosh",
    "atanh", "expm1", "log1p", "log2", "log10", "lgamma", "digamma",
    "erfinv", "erfc", "trunc", "frac", "tanh_shrink", "mish", "selu",
]

_module = sys.modules[__name__]


def _make_unary(name):
    def fn(x, name=None):
        return append_simple_op(name_, {"X": x})

    name_ = name
    fn.__name__ = name
    fn.__doc__ = "Elementwise %s (cf. reference activation_op.cc)." % name
    return fn


for _n in _UNARY:
    setattr(_module, _n, _make_unary(_n))


def leaky_relu(x, alpha=0.02):
    return append_simple_op("leaky_relu", {"X": x}, {"alpha": alpha})


def elu(x, alpha=1.0):
    return append_simple_op("elu", {"X": x}, {"alpha": alpha})


def gelu(x, approximate=False):
    return append_simple_op("gelu", {"X": x}, {"approximate": approximate})


def hard_sigmoid(x, slope=0.2, offset=0.5):
    return append_simple_op("hard_sigmoid", {"X": x}, {"slope": slope, "offset": offset})


def swish(x, beta=1.0):
    return append_simple_op("swish", {"X": x}, {"beta": beta})


def relu6(x, threshold=6.0):
    return append_simple_op("relu6", {"X": x}, {"threshold": threshold})


def pow(x, factor=1.0):
    return append_simple_op("pow", {"X": x}, {"factor": factor})


def prelu(x, mode="all", param_attr=None):
    helper = LayerHelper("prelu")
    if mode == "all":
        shape = [1]
    elif mode == "channel":
        shape = [x.shape[1]]
    else:
        shape = [int(s) for s in x.shape[1:]]
    alpha = helper.create_parameter(
        param_attr, shape, dtype=x.dtype, default_initializer=ConstantInitializer(0.25)
    )
    return append_simple_op("prelu", {"X": x, "Alpha": alpha}, {"mode": mode})


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    out = append_simple_op(
        "scale", {"X": x},
        {"scale": float(scale), "bias": float(bias), "bias_after_scale": bias_after_scale},
    )
    if act:
        out = append_simple_op(act, {"X": out})
    return out


def clip(x, min, max, name=None):
    return append_simple_op("clip", {"X": x}, {"min": float(min), "max": float(max)})


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mod", x, y, axis, act)


def _elementwise(op, x, y, axis, act):
    out = append_simple_op(op, {"X": x, "Y": y}, {"axis": axis})
    if act:
        out = append_simple_op(act, {"X": out})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim)


def _reduce(op, input, dim, keep_dim):
    attrs = {"keep_dim": keep_dim}
    if dim is None:
        attrs["reduce_all"] = True
    else:
        attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
    return append_simple_op(op, {"X": input}, attrs)


def mean(x, name=None):
    return append_simple_op("mean", {"X": x})


def sum(x):
    return append_simple_op("sum", {"X": list(x) if isinstance(x, (list, tuple)) else [x]})


def sums(input, out=None):
    return sum(input)


def sqrt_(x):
    return append_simple_op("sqrt", {"X": x})


def softmax(input, axis=-1, use_cudnn=False, name=None):
    return append_simple_op("softmax", {"X": input}, {"axis": axis})


def log_softmax(input, axis=-1):
    return append_simple_op("log_softmax", {"X": input}, {"axis": axis})


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    return append_simple_op(
        "matmul", {"X": x, "Y": y},
        {"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": float(alpha)},
    )


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    return append_simple_op(
        "mul", {"X": x, "Y": y},
        {"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
    )


def dot(x, y):
    return append_simple_op("dot", {"X": x, "Y": y})


def topk(input, k, name=None):
    return append_simple_op("top_k", {"X": input}, {"k": k}, out_slots=("Out", "Indices"))


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    return append_simple_op(
        "cumsum", {"X": x}, {"axis": axis, "exclusive": exclusive, "reverse": reverse}
    )


# -- round-2 breadth wrappers (linalg_ops.py / extra_ops.py) -----------------

def kron(x, y, name=None):
    return append_simple_op("kron", {"X": x, "Y": y})


def einsum(equation, *operands):
    return append_simple_op("einsum", {"Operands": list(operands)},
                            {"equation": equation})


def cholesky(x, upper=False, name=None):
    return append_simple_op("cholesky", {"X": x}, {"upper": upper})


def inverse(x, name=None):
    return append_simple_op("inverse", {"Input": x}, out_slots=("Output",))


def matrix_power(x, n, name=None):
    return append_simple_op("matrix_power", {"X": x}, {"n": int(n)})


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    return append_simple_op(
        "triangular_solve", {"X": x, "Y": y},
        {"upper": upper, "transpose": transpose,
         "unitriangular": unitriangular})


def cross(x, y, axis=None, name=None):
    return append_simple_op("cross", {"X": x, "Y": y}, {"dim": axis})


def multi_dot(xs, name=None):
    return append_simple_op("multi_dot", {"X": list(xs)})


def roll(x, shifts, axis=None, name=None):
    shifts = shifts if isinstance(shifts, (list, tuple)) else [shifts]
    axis = axis if axis is None or isinstance(axis, (list, tuple)) else [axis]
    return append_simple_op("roll", {"X": x}, {"shifts": list(shifts),
                                               "axis": axis})


def flip(x, axis, name=None):
    axis = axis if isinstance(axis, (list, tuple)) else [axis]
    return append_simple_op("flip", {"X": x}, {"axis": list(axis)})


def broadcast_to(x, shape, name=None):
    return append_simple_op("broadcast_to", {"X": x}, {"shape": list(shape)})


def logsumexp(x, axis=None, keepdim=False, name=None):
    return append_simple_op("logsumexp", {"X": x},
                            {"axis": axis, "keepdim": keepdim})


def instance_norm(x, scale=None, bias=None, epsilon=1e-5, name=None):
    ins = {"X": x}
    if scale is not None:
        ins["Scale"] = scale
    if bias is not None:
        ins["Bias"] = bias
    return append_simple_op("instance_norm", ins, {"epsilon": epsilon},
                            out_slots=("Y",))


def grid_sampler(x, grid, align_corners=True, name=None):
    return append_simple_op("grid_sampler", {"X": x, "Grid": grid},
                            {"align_corners": align_corners},
                            out_slots=("Output",))


def affine_grid(theta, out_shape, align_corners=True, name=None):
    return append_simple_op("affine_grid", {"Theta": theta},
                            {"output_shape": list(out_shape),
                             "align_corners": align_corners},
                            out_slots=("Output",))


def pixel_shuffle(x, upscale_factor, name=None):
    return append_simple_op("pixel_shuffle", {"X": x},
                            {"upscale_factor": int(upscale_factor)})


def kldiv_loss(x, target, reduction="mean", name=None):
    return append_simple_op("kldiv_loss", {"X": x, "Target": target},
                            {"reduction": reduction}, out_slots=("Loss",))


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    ins = {"X": label}
    if prior_dist is not None:
        ins["PriorDist"] = prior_dist
    return append_simple_op("label_smooth", ins, {"epsilon": epsilon})


def cos_sim(x, y, name=None):
    return append_simple_op("cos_sim", {"X": x, "Y": y})


# every public function, for ``fluid.layers``' star import (the
# reference's module exports the same names)
__all__ = sorted(n for n, v in vars(_module).items()
                 if callable(v) and not n.startswith("_")
                 and getattr(v, "__module__", None) == __name__)
