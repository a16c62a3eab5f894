"""NN layers: fc, embedding, layer_norm, dropout (counterpart of the
matching parts of `paddle_tpu/fluid/layers/nn.py`).  Each layer creates
its parameters through LayerHelper (startup-program init ops) and
appends its compute ops to the main program."""

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from .common import append_simple_op, to_var_list


def fc(
    input,
    size,
    num_flatten_dims=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    """Fully-connected (cf. reference nn.py fc): mul + bias + act.  One
    input only; the reference's multi-input form sums through a ``sum``
    op the port does not have yet."""
    inputs = to_var_list(input)
    if len(inputs) != 1:
        raise NotImplementedError(
            "fc over %d inputs needs the sum op, not yet ported"
            % len(inputs))
    helper = LayerHelper("fc", name=name)
    x = inputs[0]
    in_features = 1
    for s in x.shape[num_flatten_dims:]:
        in_features *= int(s)
    w = helper.create_parameter(param_attr, [in_features, size], dtype=x.dtype)
    out = append_simple_op(
        "mul",
        {"X": x, "Y": w},
        {"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
    )
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], dtype=out.dtype, is_bias=True)
        out = helper.append_bias_op(out, b, axis=num_flatten_dims)
    return helper.append_activation(out, act)


def embedding(input, size, padding_idx=None, param_attr=None,
              dtype="float32"):
    """cf. reference nn.py embedding / lookup_table op (dense W)."""
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, list(size), dtype=dtype)
    if padding_idx is None:
        pad = -1  # op-level sentinel: no padding row
    elif padding_idx < 0:
        pad = int(size[0]) + padding_idx  # reference converts negatives
    else:
        pad = padding_idx
    return append_simple_op(
        "lookup_table", {"W": w, "Ids": input}, {"padding_idx": pad},
        dtype=dtype,
    )


def layer_norm(
    input,
    scale=True,
    shift=True,
    begin_norm_axis=1,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    """cf. reference nn.py layer_norm (layer_norm_op.cc)."""
    helper = LayerHelper("layer_norm", name=name)
    norm_shape = [1]
    for s in input.shape[begin_norm_axis:]:
        norm_shape[0] *= int(s)
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            param_attr, norm_shape, dtype="float32",
            default_initializer=ConstantInitializer(1.0),
        )
    if shift:
        inputs["Bias"] = helper.create_parameter(
            bias_attr, norm_shape, dtype="float32", is_bias=True
        )
    out, _, _ = append_simple_op(
        "layer_norm",
        inputs,
        {"begin_norm_axis": begin_norm_axis, "epsilon": epsilon},
        out_slots=("Y", "Mean", "Variance"),
    )
    return helper.append_activation(out, act)


def dropout(
    x,
    dropout_prob,
    is_test=False,
    seed=None,
    name=None,
    dropout_implementation="downgrade_in_infer",
):
    """cf. reference nn.py dropout (dropout_op.cc)."""
    out, _mask = append_simple_op(
        "dropout",
        {"X": x},
        {
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed or 0,
            "dropout_implementation": dropout_implementation,
        },
        out_slots=("Out", "Mask"),
    )
    return out
