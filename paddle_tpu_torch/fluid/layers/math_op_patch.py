"""Python-operator overloads on Variable (counterpart of
`paddle_tpu/fluid/layers/math_op_patch.py`)."""

import numpy as np


def binary(var, other, op_type, reverse=False):
    from .common import append_simple_op
    from .tensor import fill_constant

    if isinstance(other, (int, float, np.floating, np.integer)):
        # scalar fast paths through the `scale` op
        if not reverse and op_type == "elementwise_add":
            return append_simple_op("scale", {"X": var}, {"scale": 1.0, "bias": float(other)})
        if not reverse and op_type == "elementwise_mul":
            return append_simple_op("scale", {"X": var}, {"scale": float(other), "bias": 0.0})
        if not reverse and op_type == "elementwise_sub":
            return append_simple_op("scale", {"X": var}, {"scale": 1.0, "bias": -float(other)})
        if not reverse and op_type == "elementwise_div":
            return append_simple_op("scale", {"X": var}, {"scale": 1.0 / float(other), "bias": 0.0})
        other = fill_constant([1], var.dtype, float(other))
    x, y = (other, var) if reverse else (var, other)
    return append_simple_op(op_type, {"X": x, "Y": y}, {"axis": -1})
