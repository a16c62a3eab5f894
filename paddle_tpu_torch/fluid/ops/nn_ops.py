"""NN ops: layer_norm, dropout and its grad, flash_attention,
lookup_table, softmax_with_cross_entropy, square_error_cost.

Counterpart of `paddle_tpu/fluid/ops/nn_ops.py` (layer_norm :372,
dropout :402, dropout_grad :425, flash_attention :438, lookup_table
:603, softmax_with_cross_entropy :652, square_error_cost :708).
``flash_attention`` is the op that reaches a hand kernel: it calls
`ops.attention.scaled_dot_product_attention` (kernel 1), which
launches the kernel on a CUDA tensor and takes its plain version on a
CPU or meta one.
"""

import math

import torch
import torch.nn.functional as F

from ...ops import attention as _attention
from ..core.registry import register_op


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
    """Embedding gather (cf. lookup_table_op.cc).  padding_idx rows zeroed."""
    w, ids = ins["W"][0], ins["Ids"][0]
    padding_idx = attrs.get("padding_idx", -1)
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = F.embedding(ids.long(), w)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None], 0.0, out)
    return {"Out": [out]}


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


@register_op("square_error_cost", inputs=["X", "Y"], outputs=["Out"])
def _square_error_cost(ctx, ins, attrs):
    return {"Out": [torch.square(ins["X"][0] - ins["Y"][0])]}
