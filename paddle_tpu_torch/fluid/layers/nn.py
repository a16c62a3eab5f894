"""NN layers: fc, embedding, conv2d, pool2d, batch_norm, layer_norm,
dropout, accuracy (counterpart of the matching parts of
`paddle_tpu/fluid/layers/nn.py`).  Each layer creates
its parameters through LayerHelper (startup-program init ops) and
appends its compute ops to the main program."""

import math

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper, ParamAttr
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
    """Fully-connected (cf. reference nn.py fc): mul per input + sum + bias + act."""
    helper = LayerHelper("fc", name=name)
    mul_results = []
    for x in to_var_list(input):
        in_features = 1
        for s in x.shape[num_flatten_dims:]:
            in_features *= int(s)
        w = helper.create_parameter(
            param_attr, [in_features, size], dtype=x.dtype)
        mul_results.append(append_simple_op(
            "mul",
            {"X": x, "Y": w},
            {"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        ))
    out = (mul_results[0] if len(mul_results) == 1
           else append_simple_op("sum", {"X": mul_results}))
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], dtype=out.dtype, is_bias=True)
        out = helper.append_bias_op(out, b, axis=num_flatten_dims)
    return helper.append_activation(out, act)


def embedding(
    input,
    size,
    is_sparse=False,
    is_distributed=False,
    padding_idx=None,
    param_attr=None,
    dtype="float32",
):
    """cf. reference nn.py embedding / lookup_table op, with the
    reference's signature.  ``is_sparse`` is recorded on the op; its
    backward (SelectedRows gradients) raises until Queue A 3 (b) 3
    ports it.  ``is_distributed`` (a host-RAM table) raises."""
    if is_distributed:
        raise NotImplementedError(
            "embedding(is_distributed=True) needs the host-RAM table "
            "(fluid/host_embedding.py), not ported yet (ROADMAP Queue A "
            "5); set is_distributed=False")
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, list(size), dtype=dtype)
    if padding_idx is None:
        pad = -1  # op-level sentinel: no padding row
    elif padding_idx < 0:
        pad = int(size[0]) + padding_idx  # reference converts negatives
    else:
        pad = padding_idx
    return append_simple_op(
        "lookup_table", {"W": w, "Ids": input},
        {"padding_idx": pad, "is_sparse": bool(is_sparse)}, dtype=dtype,
    )


def conv2d(
    input,
    num_filters,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups=1,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    act=None,
    name=None,
    data_format="NCHW",
):
    """cf. reference nn.py conv2d (conv_op.cc): conv, bias at axis 1,
    act; the filter N(0, sqrt(2 / fan_in))."""
    helper = LayerHelper("conv2d", name=name)
    num_channels = int(input.shape[1])
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        param_attr,
        filter_shape,
        dtype=input.dtype,
        default_initializer=NormalInitializer(0.0, math.sqrt(2.0 / fan_in)),
    )
    out = append_simple_op(
        "conv2d",
        {"Input": input, "Filter": w},
        {
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups,
        },
        out_slots=("Output",),
    )
    if bias_attr is not False:
        b = helper.create_parameter(
            bias_attr, [num_filters], dtype=out.dtype, is_bias=True
        )
        out = helper.append_bias_op(out, b, axis=1)
    return helper.append_activation(out, act)


def pool2d(
    input,
    pool_size=-1,
    pool_type="max",
    pool_stride=1,
    pool_padding=0,
    global_pooling=False,
    use_cudnn=True,
    ceil_mode=False,
    exclusive=True,
    name=None,
):
    """cf. reference nn.py pool2d (pool_op.cc)."""
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    if isinstance(pool_stride, int):
        pool_stride = [pool_stride, pool_stride]
    if isinstance(pool_padding, int):
        pool_padding = [pool_padding, pool_padding]
    return append_simple_op(
        "pool2d",
        {"X": input},
        {
            "pooling_type": pool_type,
            "ksize": pool_size,
            "strides": pool_stride,
            "paddings": pool_padding,
            "global_pooling": global_pooling,
            "exclusive": exclusive,
        },
    )


def batch_norm(
    input,
    act=None,
    is_test=False,
    momentum=0.9,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    data_layout="NCHW",
    name=None,
    moving_mean_name=None,
    moving_variance_name=None,
    use_global_stats=False,
):
    """cf. reference nn.py batch_norm (batch_norm_op.cc): Scale 1, Bias
    0, and the running Mean 0 and Variance 1 as persistable parameters
    that are not trained, updated in place (MeanOut aliases Mean,
    VarianceOut Variance)."""
    helper = LayerHelper("batch_norm", name=name)
    c_axis = 1 if data_layout == "NCHW" else len(input.shape) - 1
    channels = int(input.shape[c_axis])

    scale = helper.create_parameter(
        param_attr, [channels], dtype="float32",
        default_initializer=ConstantInitializer(1.0),
    )
    bias = helper.create_parameter(
        bias_attr, [channels], dtype="float32", is_bias=True
    )
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False),
        [channels],
        dtype="float32",
        default_initializer=ConstantInitializer(0.0),
    )
    var = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False),
        [channels],
        dtype="float32",
        default_initializer=ConstantInitializer(1.0),
    )

    block = helper.main_program.current_block()
    y = helper.create_variable_for_type_inference(input.dtype)
    saved_mean = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    helper.append_op(
        "batch_norm",
        inputs={
            "X": [input.name],
            "Scale": [scale.name],
            "Bias": [bias.name],
            "Mean": [mean.name],
            "Variance": [var.name],
        },
        outputs={
            "Y": [y.name],
            "MeanOut": [mean.name],
            "VarianceOut": [var.name],
            "SavedMean": [saved_mean.name],
            "SavedVariance": [saved_var.name],
        },
        attrs={
            "momentum": momentum,
            "epsilon": epsilon,
            "is_test": is_test or use_global_stats,
            "data_layout": data_layout,
        },
    )
    return helper.append_activation(block.var(y.name), act)


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


def accuracy(input, label, k=1, correct=None, total=None):
    """cf. reference layers/metric_op.py accuracy: ``top_k`` then
    ``accuracy``; the fraction of rows whose label is among the k
    largest."""
    topk_out, topk_ind = append_simple_op(
        "top_k", {"X": input}, {"k": k}, out_slots=("Out", "Indices")
    )
    acc, _, _ = append_simple_op(
        "accuracy",
        {"Out": topk_out, "Indices": topk_ind, "Label": label},
        out_slots=("Accuracy", "Correct", "Total"),
        dtype="float32",
        stop_gradient=True,
    )
    return acc
