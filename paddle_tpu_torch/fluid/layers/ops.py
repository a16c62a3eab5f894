"""Op wrappers: activations, scale, the elementwise ops, reductions,
softmax, topk, matmul and mul (counterpart of the matching parts of
`paddle_tpu/fluid/layers/ops.py`)."""

from .common import append_simple_op


def relu(x, name=None):
    return append_simple_op("relu", {"X": x})


def sigmoid(x, name=None):
    return append_simple_op("sigmoid", {"X": x})


def tanh(x, name=None):
    return append_simple_op("tanh", {"X": x})


def square(x, name=None):
    return append_simple_op("square", {"X": x})


def gelu(x, approximate=False):
    return append_simple_op("gelu", {"X": x}, {"approximate": approximate})


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    out = append_simple_op(
        "scale", {"X": x},
        {"scale": float(scale), "bias": float(bias), "bias_after_scale": bias_after_scale},
    )
    if act:
        out = append_simple_op(act, {"X": out})
    return out


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act)


def _elementwise(op, x, y, axis, act):
    out = append_simple_op(op, {"X": x, "Y": y}, {"axis": axis})
    if act:
        out = append_simple_op(act, {"X": out})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim)


def _reduce(op, input, dim, keep_dim):
    attrs = {"keep_dim": keep_dim}
    if dim is None:
        attrs["reduce_all"] = True
    else:
        attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
    return append_simple_op(op, {"X": input}, attrs)


def mean(x, name=None):
    return append_simple_op("mean", {"X": x})


def softmax(input, axis=-1, use_cudnn=False, name=None):
    return append_simple_op("softmax", {"X": input}, {"axis": axis})


def topk(input, k, name=None):
    return append_simple_op("top_k", {"X": input}, {"k": k},
                            out_slots=("Out", "Indices"))


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    return append_simple_op(
        "matmul", {"X": x, "Y": y},
        {"transpose_X": transpose_x, "transpose_Y": transpose_y,
         "alpha": float(alpha)},
    )


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    return append_simple_op(
        "mul", {"X": x, "Y": y},
        {"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
    )
