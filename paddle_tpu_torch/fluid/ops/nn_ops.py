"""NN ops: conv2d, depthwise_conv2d, pool2d, batch_norm, layer_norm,
dropout and its grad, flash_attention, lookup_table, lookup_table_v2,
softmax_with_cross_entropy, cross_entropy, square_error_cost, prelu.

Counterpart of `paddle_tpu/fluid/ops/nn_ops.py` (conv2d :23,
depthwise_conv2d :62, pool2d :116 and `_adaptive_pool_general` :162,
batch_norm :258, layer_norm :372, dropout :402, dropout_grad :425,
flash_attention :438, lookup_table :603, lookup_table_v2 :621,
softmax_with_cross_entropy :652, cross_entropy :683, square_error_cost
:708, prelu :737).
``flash_attention`` is the op that reaches a hand kernel: it calls
`ops.attention.scaled_dot_product_attention` (kernel 1), which
launches the kernel on a CUDA tensor and takes its plain version on a
CPU or meta one.  The reference computes convolutions and pooling with
XLA outside any Pallas kernel; here they are PyTorch's (cuDNN on the
card).  ``batch_norm`` in training runs the reference's one-pass
statistics and backward (`ops.nn_ops.batch_norm_train`'s).
"""

import math

import torch
import torch.nn.functional as F

from ...ops import attention as _attention
from ...ops import nn_ops as _nn
from ..core.registry import register_op
from .math_ops import clip


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _same_pads(size, k, stride, dilation):
    """XLA's SAME padding of one spatial axis: (before, after) so that
    the output has ceil(size / stride) positions, the odd one after."""
    total = max((-(-size // stride) - 1) * stride + (k - 1) * dilation + 1
                - size, 0)
    return total // 2, total - total // 2


@register_op("conv2d", inputs=["Input", "Filter"], outputs=["Output"])
def _conv2d(ctx, ins, attrs):
    """Conv (cf. conv_op.cc).  groups>1 -> grouped conv.

    data_format NCHW (reference default) or NHWC; the filter stays OIHW
    (paddle layout) either way.  ``paddings`` [h, w] or [top, bottom,
    left, right]; ``padding_algorithm`` SAME / VALID overrides them."""
    x, w = ins["Input"][0], ins["Filter"][0]
    # AMP white-list behavior: a float input meets a lower-precision
    # filter (bf16 params under amp) at the filter's dtype
    if x.dtype != w.dtype and x.is_floating_point():
        x = x.to(w.dtype)
    strides = _pair(attrs.get("strides", [1, 1]))
    dilations = _pair(attrs.get("dilations", [1, 1]))
    groups = int(attrs.get("groups", 1))
    nhwc = attrs.get("data_format", attrs.get("data_layout", "NCHW")) == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    pads = [int(p) for p in attrs.get("paddings", [0, 0])]
    if len(pads) == 2:
        pads = [pads[0], pads[0], pads[1], pads[1]]
    alg = attrs.get("padding_algorithm")
    if alg == "SAME":
        pads = list(_same_pads(x.shape[2], w.shape[2], strides[0],
                               dilations[0])
                    + _same_pads(x.shape[3], w.shape[3], strides[1],
                                 dilations[1]))
    elif alg == "VALID":
        pads = [0, 0, 0, 0]
    top, bottom, left, right = pads
    if top == bottom and left == right:
        out = F.conv2d(x, w, None, strides, (top, left), dilations, groups)
    else:
        out = F.conv2d(F.pad(x, (left, right, top, bottom)), w, None,
                       strides, 0, dilations, groups)
    return {"Output": [out.permute(0, 2, 3, 1) if nhwc else out]}


@register_op("depthwise_conv2d", inputs=["Input", "Filter"],
             outputs=["Output"])
def _depthwise_conv2d(ctx, ins, attrs):
    """conv2d with one group a channel (``groups`` = Input's dim 1)."""
    attrs = dict(attrs, groups=int(ins["Input"][0].shape[1]))
    return _conv2d(ctx, ins, attrs)


@register_op("pool2d", inputs=["X"], outputs=["Out"])
def _pool2d(ctx, ins, attrs):
    """max/avg pooling (cf. pool_op.cc); NCHW or NHWC.  Padding is -inf
    for max; avg divides by the window's unpadded count when
    ``exclusive`` (the default) and the window is padded.
    ``global_pooling`` takes the whole plane; ``adaptive`` reads ksize
    as the output size, bin i covering [floor(i·I/O), ceil((i+1)·I/O))
    (pool_op.cc AdaptStartIndex / AdaptEndIndex), divisible or not."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", ksize))
    pads = _pair(attrs.get("paddings", [0, 0]))
    nhwc = attrs.get("data_format", attrs.get("data_layout", "NCHW")) != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    if attrs.get("global_pooling", False):
        ksize = strides = tuple(x.shape[2:])
        pads = (0, 0)
    pad4 = (pads[1], pads[1], pads[0], pads[0])
    if attrs.get("adaptive", False):
        pool = F.adaptive_max_pool2d if ptype == "max" \
            else F.adaptive_avg_pool2d
        out = pool(x, ksize)
    elif ptype == "max":
        if pads != (0, 0):
            x = F.pad(x, pad4, value=-math.inf)
        out = F.max_pool2d(x, ksize, strides)
    elif pads == (0, 0):
        out = F.avg_pool2d(x, ksize, strides)
    else:
        out = F.avg_pool2d(F.pad(x, pad4), ksize, strides)
        if attrs.get("exclusive", True):
            ones = F.pad(torch.ones_like(x[:1, :1]), pad4)
            out = out / F.avg_pool2d(ones, ksize, strides)
    out = out.to(x.dtype)
    return {"Out": [out.permute(0, 2, 3, 1) if nhwc else out]}


def _channels_at_1(x, c_axis):
    """x as ``[N, C, rest, 1]`` (or its own ``[N, C, H, W]``), a view
    where it can be, with the inverse map."""
    xc = x.movedim(c_axis, 1) if c_axis != 1 else x
    if xc.dim() == 4:
        return xc, lambda y: y.movedim(1, c_axis)
    shape = xc.shape
    return (xc.reshape(shape[0], shape[1], -1, 1),
            lambda y: y.reshape(shape).movedim(1, c_axis))


@register_op(
    "batch_norm",
    inputs=["X", "Scale", "Bias", "Mean", "Variance"],
    outputs=["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
    no_grad_slots=("Mean", "Variance"),
    stateful_out_slots=("MeanOut", "VarianceOut"),
)
def _batch_norm(ctx, ins, attrs):
    """cf. batch_norm_op.cc.  Training: batch stats + running update of
    the running statistics (MeanOut / VarianceOut alias the Mean /
    Variance persistables) with Paddle's momentum and the biased batch
    variance; SavedMean holds the batch mean and SavedVariance
    1/sqrt(var + eps), neither differentiable.  ``is_test`` (the attr or
    the run's) normalizes with the running statistics."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    momentum = attrs.get("momentum", 0.9)
    eps = float(attrs.get("epsilon", 1e-5))
    is_test = attrs.get("is_test", False) or ctx.is_test
    layout = attrs.get("data_layout", attrs.get("data_format", "NCHW"))
    x4, back = _channels_at_1(x, 1 if layout == "NCHW" else x.dim() - 1)
    if is_test:
        inv_std = torch.rsqrt(var.float() + eps)
        y = F.batch_norm(x4.float(), mean.float(), var.float(),
                         scale.float(), bias.float(), False, 0.0, eps)
        return {"Y": [back(y).to(x.dtype)], "MeanOut": [mean],
                "VarianceOut": [var], "SavedMean": [mean.float()],
                "SavedVariance": [inv_std]}
    y, m, rstd = _nn._BatchNormTrain.apply(x4, scale, bias, None, None, eps)
    mean_out, var_out = _nn.running_update(mean, var, m, rstd, momentum, eps)
    return {"Y": [back(y)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [m],
            "SavedVariance": [rstd]}


@register_op(
    "layer_norm",
    inputs=["X", "Scale", "Bias"],
    outputs=["Y", "Mean", "Variance"],
)
def _layer_norm(ctx, ins, attrs):
    """cf. layer_norm_op.cc: normalize over dims >= begin_norm_axis, in
    f32; Mean and Variance per normalized row, flat."""
    x = ins["X"][0]
    eps = float(attrs.get("epsilon", 1e-5))
    bna = attrs.get("begin_norm_axis", 1)
    norm_shape = tuple(x.shape[bna:])
    scale = ins["Scale"][0] if ins.get("Scale") else None
    bias = ins["Bias"][0] if ins.get("Bias") else None
    y, mean, rstd = torch.native_layer_norm(
        x.float(), norm_shape,
        None if scale is None else scale.reshape(norm_shape).float(),
        None if bias is None else bias.reshape(norm_shape).float(), eps)
    flat = (math.prod(x.shape[:bna]),)
    var = (1.0 / rstd.square() - eps).clamp_min(0.0)
    return {
        "Y": [y.to(x.dtype)],
        "Mean": [mean.reshape(flat)],
        "Variance": [var.reshape(flat)],
    }


@register_op("dropout", inputs=["X"], outputs=["Out", "Mask"],
             grad="dropout_grad_maker", needs_rng=True)
def _dropout(ctx, ins, attrs):
    """cf. dropout_op.cc.  Training draws the keep mask from the run's
    generator; at test time ``downgrade_in_infer`` scales by 1 - p and
    ``upscale_in_train`` passes X through."""
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False) or ctx.is_test
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test:
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        return {"Out": [out.to(x.dtype)],
                "Mask": [torch.ones_like(x, dtype=torch.uint8)]}
    if ctx.is_meta:
        keep = torch.empty(x.shape, dtype=torch.bool, device="meta")
    else:
        keep = torch.rand(x.shape, generator=ctx.rng(),
                          device=x.device) < (1.0 - p)
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), 0.0)
    else:
        out = torch.where(keep, x, 0.0)
    return {"Out": [out.to(x.dtype)], "Mask": [keep.to(torch.uint8)]}


@register_op("dropout_grad", inputs=["Mask", "Out@GRAD"],
             outputs=["X@GRAD"], grad=None)
def _dropout_grad(ctx, ins, attrs):
    """The forward's own keep mask times the output gradient (scaled by
    1 / (1 - p) under ``upscale_in_train``): nothing is redrawn."""
    g = ins["Out@GRAD"][0]
    mask = ins["Mask"][0].to(g.dtype)
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("dropout_implementation",
                 "downgrade_in_infer") == "upscale_in_train":
        gx = g * mask / (1.0 - p)
    else:
        gx = g * mask
    return {"X@GRAD": [gx]}


@register_op(
    "flash_attention",
    inputs=["Q", "K", "V", "Bias", "QSeg", "KSeg"],
    outputs=["Out"],
    no_grad_slots=("QSeg", "KSeg"),
)
def _flash_attention(ctx, ins, attrs):
    """Fused scaled-dot-product attention through kernel 1.

    Q/K/V: [batch, heads, seq, head_dim] (attrs layout="BHSD", default)
    or [batch, seq, heads, head_dim] ("BSHD"); optional additive Bias
    broadcastable to [batch, heads, 1, k_seq]; optional QSeg/KSeg
    [batch, seq] int segment ids.  attrs: scale (default
    1/sqrt(head_dim)), causal, layout."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    qseg = ins["QSeg"][0] if ins.get("QSeg") else None
    kseg = ins["KSeg"][0] if ins.get("KSeg") else None
    if kseg is not None and qseg is None:
        raise ValueError(
            "flash_attention: KSeg without QSeg is meaningless (equality "
            "masking needs both sides); feed QSeg too"
        )
    segment_ids = None
    if qseg is not None:
        segment_ids = (qseg, kseg if kseg is not None else qseg)
    scale = attrs.get("scale") or float(q.shape[-1]) ** -0.5
    out = _attention.scaled_dot_product_attention(
        q, k, v, bias=bias, segment_ids=segment_ids, scale=scale,
        causal=attrs.get("causal", False),
        layout=attrs.get("layout", "BHSD"))
    return {"Out": [out]}


@register_op("lookup_table", inputs=["W", "Ids"], outputs=["Out"],
             no_grad_slots=("Ids",), grad="lookup_table_grad_maker")
def _lookup_table(ctx, ins, attrs):
    """Embedding gather (cf. lookup_table_op.cc).  padding_idx rows
    zeroed.  The rows are `ops.nn_ops.take`'s, the reference's
    ``jnp.take``: an id in [-V, 0) counts from the end, one outside
    [-V, V) gives a NaN row and no gradient."""
    w, ids = ins["W"][0], ins["Ids"][0]
    padding_idx = attrs.get("padding_idx", -1)
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = _nn.take(w, ids, 0)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None], 0.0, out)
    return {"Out": [out]}


register_op("lookup_table_v2", inputs=["W", "Ids"], outputs=["Out"],
            no_grad_slots=("Ids",), grad="lookup_table_grad_maker")(
    _lookup_table)


@register_op(
    "softmax_with_cross_entropy",
    inputs=["Logits", "Label"],
    outputs=["Softmax", "Loss"],
    no_grad_slots=("Label",),
)
def _softmax_with_cross_entropy(ctx, ins, attrs):
    """cf. softmax_with_cross_entropy_op.cc: log-softmax in f32, then the
    label's entry (hard labels, ``ignore_index`` rows 0) or the sum over
    a soft label; Softmax and Loss in the logits' dtype."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1)
    logp = torch.log_softmax(logits.float(), dim=axis)
    softmax = logp.exp()
    if attrs.get("soft_label", False):
        loss = -(label.float() * logp).sum(dim=axis, keepdim=True)
    else:
        lab = label
        if lab.dim() == logits.dim() and lab.shape[axis] == 1:
            lab = lab.squeeze(axis)
        valid = (lab != attrs.get("ignore_index", -100)).unsqueeze(axis)
        idx = torch.where(valid, lab.long().unsqueeze(axis), 0)
        loss = torch.where(valid, -logp.gather(axis, idx), 0.0)
    return {"Softmax": [softmax.to(logits.dtype)],
            "Loss": [loss.to(logits.dtype)]}


@register_op("cross_entropy", inputs=["X", "Label"], outputs=["Y"],
             no_grad_slots=("Label",))
def _cross_entropy(ctx, ins, attrs):
    """cf. cross_entropy_op.cc: X is a probability distribution, clipped
    to [1e-8, 1] before the log (as the reference's ``jnp.clip``: a
    value on a bound passes half its gradient); hard labels ``[..., 1]``
    or ``[...]``, or soft labels summed over the last axis."""
    x, label = ins["X"][0], ins["Label"][0]
    logp = torch.log(clip(x, 1e-8, 1.0))
    if attrs.get("soft_label", False):
        y = -(label * logp).sum(dim=-1, keepdim=True)
    else:
        lab = label
        if lab.dim() == x.dim() and lab.shape[-1] == 1:
            lab = lab.squeeze(-1)
        y = -logp.gather(-1, lab.long().unsqueeze(-1))
    return {"Y": [y]}


@register_op("square_error_cost", inputs=["X", "Y"], outputs=["Out"])
def _square_error_cost(ctx, ins, attrs):
    return {"Out": [torch.square(ins["X"][0] - ins["Y"][0])]}


@register_op("prelu", inputs=["X", "Alpha"], outputs=["Out"])
def _prelu(ctx, ins, attrs):
    """cf. prelu_op.cc: x where x >= 0, else alpha x; ``mode`` all (one
    alpha), channel (one a dim-1 channel) or element (one an element
    of a sample)."""
    x, alpha = ins["X"][0], ins["Alpha"][0]
    if attrs.get("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": [torch.where(x >= 0, x, alpha * x)]}
