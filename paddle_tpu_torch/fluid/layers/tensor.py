"""Tensor-creation / manipulation layers (counterpart of
`paddle_tpu/fluid/layers/tensor.py`, every public function of it, with
its signatures, and `layers/io.py`'s ``data``)."""

import sys

import numpy as np

from .. import framework, unique_name
from ..core import dtypes as dtypes_mod
from .common import append_simple_op
from .ops import cumsum  # noqa: F401  (the reference's module has it too)


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


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A standalone trainable parameter (a persistable var the startup
    program initializes)."""
    import copy

    from ..layer_helper import LayerHelper, ParamAttr

    helper = LayerHelper("create_parameter")
    if attr is False:
        return None
    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr = copy.copy(attr)            # never mutate the caller's attr
        attr.name = name
    return helper.create_parameter(attr, list(shape), dtype=dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)


def fill_constant(shape, dtype, value, name=None):
    return append_simple_op(
        "fill_constant",
        {},
        {"shape": list(shape), "dtype": dtypes_mod.to_str(dtype), "value": float(value)},
        dtype=dtypes_mod.to_str(dtype),
        stop_gradient=True,
    )


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    return append_simple_op(
        "fill_constant_batch_size_like",
        {"Input": input},
        {
            "shape": list(shape),
            "dtype": dtypes_mod.to_str(dtype),
            "value": float(value),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
        dtype=dtypes_mod.to_str(dtype),
        stop_gradient=True,
    )


def cast(x, dtype):
    return append_simple_op(
        "cast", {"X": x}, {"out_dtype": dtypes_mod.to_str(dtype)},
        dtype=dtypes_mod.to_str(dtype),
    )


def concat(input, axis=0, name=None):
    return append_simple_op("concat", {"X": list(input)}, {"axis": axis})


def assign(input, output=None):
    """A copy of a Variable, or a numpy array's values as an
    ``assign_value`` op."""
    block = framework.default_main_program().current_block()
    if isinstance(input, np.ndarray):
        if output is None:
            output = block.create_var(
                name=unique_name.generate("assign.tmp"),
                shape=list(input.shape), dtype=str(input.dtype))
        block.append_op(
            "assign_value", outputs={"Out": [output.name]},
            attrs={"shape": list(input.shape), "dtype": output.dtype,
                   "values": input.ravel().tolist()},
            infer=False)
        return output
    if output is None:
        return append_simple_op("assign", {"X": input})
    block.append_op(
        "assign", inputs={"X": [input.name]}, outputs={"Out": [output.name]}
    )
    return output


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x):
    return append_simple_op("fill_zeros_like", {"X": x})


def ones_like(x):
    return append_simple_op("fill_any_like", {"X": x}, {"value": 1.0})


def full_like(x, fill_value, dtype=None):
    attrs = {"value": float(fill_value)}
    if dtype:
        attrs["dtype"] = dtypes_mod.to_str(dtype)
    return append_simple_op("fill_any_like", {"X": x}, attrs)


def reshape(x, shape, name=None, **kw):
    return append_simple_op("reshape2", {"X": x}, {"shape": list(shape)})


def transpose(x, perm, name=None):
    return append_simple_op("transpose2", {"X": x}, {"axis": list(perm)})


def flatten(x, axis=1, name=None):
    return append_simple_op("flatten2", {"X": x}, {"axis": axis})


def squeeze(input, axes, name=None):
    return append_simple_op("squeeze2", {"X": input}, {"axes": list(axes)})


def unsqueeze(input, axes, name=None):
    return append_simple_op("unsqueeze2", {"X": input}, {"axes": list(axes)})


def split(input, num_or_sections, dim=-1, name=None):
    """A list of ``num_or_sections`` equal parts, or parts of the given
    sizes, along ``dim``."""
    axis = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": axis}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": axis}
    out = append_simple_op("split", {"X": input}, attrs, n_outs={"Out": n})
    return out if isinstance(out, list) else [out]


def stack(x, axis=0):
    return append_simple_op("stack", {"X": list(x)}, {"axis": axis},
                            out_slots=("Y",))


def unstack(x, axis=0, num=None):
    n = num if num is not None else x.shape[axis]
    out = append_simple_op("unstack", {"X": x}, {"axis": axis},
                           out_slots=("Y",), n_outs={"Y": n})
    return out if isinstance(out, list) else [out]


def slice(input, axes, starts, ends):
    return append_simple_op(
        "slice",
        {"Input": input},
        {"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )


def gather(input, index, axis=0):
    return append_simple_op("gather", {"X": input, "Index": index},
                            {"axis": axis})


def take_along_axis(input, index, axis):
    return append_simple_op(
        "take_along_axis", {"Input": input, "Index": index},
        {"Axis": int(axis)}, out_slots=("Result",))


def gather_nd(input, index):
    return append_simple_op("gather_nd", {"X": input, "Index": index})


def scatter(input, index, updates, overwrite=True):
    return append_simple_op(
        "scatter", {"X": input, "Ids": index, "Updates": updates},
        {"overwrite": overwrite})


def one_hot(input, depth, allow_out_of_range=False):
    return append_simple_op("one_hot", {"X": input}, {"depth": depth},
                            dtype="float32")


def expand(x, expand_times):
    return append_simple_op("expand", {"X": x},
                            {"expand_times": list(expand_times)})


def tile(x, repeat_times):
    return append_simple_op("tile", {"X": x},
                            {"repeat_times": list(repeat_times)})


def range(start, end, step, dtype):
    return append_simple_op(
        "arange",
        {},
        {"start": float(start), "end": float(end), "step": float(step),
         "dtype": dtypes_mod.to_str(dtype)},
        dtype=dtypes_mod.to_str(dtype),
        stop_gradient=True,
    )


arange = range


def linspace(start, stop, num, dtype="float32"):
    return append_simple_op(
        "linspace",
        {},
        {"start": float(start), "stop": float(stop), "num": int(num),
         "dtype": dtypes_mod.to_str(dtype)},
        dtype=dtypes_mod.to_str(dtype),
        stop_gradient=True,
    )


def where(condition, x, y):
    return append_simple_op("where", {"Condition": condition, "X": x, "Y": y})


def shape(input):
    return append_simple_op("shape", {"Input": input}, dtype="int32",
                            stop_gradient=True)


def pad(x, paddings, pad_value=0.0):
    return append_simple_op("pad", {"X": x}, {"paddings": list(paddings),
                                              "pad_value": pad_value})


def increment(x, value=1.0, in_place=True):
    """x + value; in place (the op writes x itself) by default."""
    if in_place:
        framework.default_main_program().current_block().append_op(
            "increment", inputs={"X": [x.name]}, outputs={"Out": [x.name]},
            attrs={"step": float(value)}, infer=False)
        return x
    return append_simple_op("increment", {"X": x}, {"step": float(value)})


def argmax(x, axis=-1, keepdims=False):
    return append_simple_op(
        "arg_max", {"X": x}, {"axis": axis, "keepdims": keepdims},
        dtype="int64", stop_gradient=True,
    )


def argmin(x, axis=-1):
    return append_simple_op("arg_min", {"X": x}, {"axis": axis},
                            dtype="int64", stop_gradient=True)


def argsort(x, axis=-1, descending=False):
    return append_simple_op(
        "argsort", {"X": x}, {"axis": axis, "descending": descending},
        out_slots=("Out", "Indices"),
    )


def _compare(op_type, x, y=None):
    ins = {"X": x} if y is None else {"X": x, "Y": y}
    return append_simple_op(op_type, ins, dtype="bool", stop_gradient=True)


def equal(x, y):
    return _compare("equal", x, y)


def not_equal(x, y):
    return _compare("not_equal", x, y)


def less_than(x, y):
    return _compare("less_than", x, y)


def greater_than(x, y):
    return _compare("greater_than", x, y)


def logical_and(x, y):
    return _compare("logical_and", x, y)


def logical_or(x, y):
    return _compare("logical_or", x, y)


def logical_not(x):
    return _compare("logical_not", x)


def Print(input, first_n=-1, message="", summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """An identity op that prints the tensor on every run (``first_n``,
    the type, LoD and phase knobs are taken for the reference's
    signature and change nothing, as there)."""
    msg = message or ""
    if print_tensor_name:
        msg = ("%s %s" % (msg, input.name)).strip()
    return append_simple_op(
        "print", {"In": input},
        {"message": msg, "summarize": summarize,
         "print_tensor_shape": print_tensor_shape},
    )


def crop_tensor(x, shape, offsets=None):
    return append_simple_op(
        "crop_tensor", {"X": x},
        {"shape": list(shape), "offsets": list(offsets or [])})


def unbind(input, axis=0):
    return append_simple_op("unbind", {"X": input}, {"axis": axis},
                            n_outs={"Out": int(input.shape[axis])})


def size(input):
    return append_simple_op("size", {"Input": input}, dtype="int64",
                            stop_gradient=True)


def gather_tree(ids, parents):
    return append_simple_op("gather_tree", {"Ids": ids, "Parents": parents},
                            dtype="int64", stop_gradient=True)


def masked_fill(x, mask, value):
    return append_simple_op("masked_fill", {"X": x, "Mask": mask},
                            {"value": float(value)})


def partial_sum(input, start_index=0, length=-1):
    return append_simple_op(
        "partial_sum", {"X": input},
        {"start_index": start_index, "length": length})


def partial_concat(input, start_index=0, length=-1):
    return append_simple_op(
        "partial_concat", {"X": input},
        {"start_index": start_index, "length": length})


# every public function, for ``fluid.layers``' star import (``range``
# and ``slice`` shadow the builtins there, as in the reference)
__all__ = sorted(n for n, v in vars(sys.modules[__name__]).items()
                 if callable(v) and not n.startswith("_")
                 and getattr(v, "__module__", None) == __name__)
