"""Tensor-creation / manipulation layers (counterpart of the matching
parts of `paddle_tpu/fluid/layers/tensor.py`)."""

from .. import framework
from ..core import dtypes as dtypes_mod
from .common import append_simple_op


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True):
    """Declare a feed variable (cf. reference layers/io.py data / fluid.data).

    fluid.layers.data prepends a -1 batch dim by default; fluid.data does not
    (pass append_batch_size=False for that behavior).
    """
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    block = framework.default_main_program().global_block
    return block.create_var(
        name=name, shape=shape, dtype=dtype, is_data=True, stop_gradient=True
    )


def fill_constant(shape, dtype, value, name=None):
    return append_simple_op(
        "fill_constant",
        {},
        {"shape": list(shape), "dtype": dtypes_mod.to_str(dtype), "value": float(value)},
        dtype=dtypes_mod.to_str(dtype),
        stop_gradient=True,
    )


def cast(x, dtype):
    return append_simple_op(
        "cast", {"X": x}, {"out_dtype": dtypes_mod.to_str(dtype)},
        dtype=dtypes_mod.to_str(dtype),
    )


def reshape(x, shape, name=None, **kw):
    return append_simple_op("reshape2", {"X": x}, {"shape": list(shape)})


def slice(input, axes, starts, ends):
    return append_simple_op(
        "slice",
        {"Input": input},
        {"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )


def concat(input, axis=0, name=None):
    return append_simple_op("concat", {"X": list(input)}, {"axis": axis})


def assign(input, output=None):
    """cf. reference layers/tensor.py assign (a Variable input; the numpy
    form needs ``assign_value``, not ported yet)."""
    if output is None:
        return append_simple_op("assign", {"X": input})
    block = framework.default_main_program().current_block()
    block.append_op(
        "assign", inputs={"X": [input.name]}, outputs={"Out": [output.name]}
    )
    return output


def take_along_axis(input, index, axis):
    return append_simple_op(
        "take_along_axis", {"Input": input, "Index": index},
        {"Axis": int(axis)}, out_slots=("Result",))
