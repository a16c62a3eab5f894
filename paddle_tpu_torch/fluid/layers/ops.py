"""Op wrappers: activations, scale, elementwise_add and mul (counterpart
of the matching parts of `paddle_tpu/fluid/layers/ops.py`)."""

from .common import append_simple_op


def relu(x, name=None):
    return append_simple_op("relu", {"X": x})


def tanh(x, name=None):
    return append_simple_op("tanh", {"X": x})


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
    out = append_simple_op("elementwise_add", {"X": x, "Y": y}, {"axis": axis})
    if act:
        out = append_simple_op(act, {"X": out})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    return append_simple_op(
        "mul", {"X": x, "Y": y},
        {"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
    )
