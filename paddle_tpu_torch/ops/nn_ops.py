"""The plain operators of the training and ResNet eval paths, with the
reference's conventions where they differ from PyTorch's defaults.

Counterparts of `paddle_tpu/fluid/ops/nn_ops.py` (`layer_norm` :413,
`dropout` :401, `softmax_with_cross_entropy` :652, `batch_norm`'s
``is_test`` branch :279, `pool2d` :116) and of the `fluid.layers`
`gelu` / `take_along_axis` / `reduce_mean` ops.  No Pallas kernel lies
here: each is a PyTorch composition.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["BN_EPS", "LN_EPS", "batch_norm_eval", "dropout", "gelu",
           "global_avg_pool", "layer_norm", "max_pool_3x3s2",
           "softmax_with_cross_entropy", "take_along_axis"]

# `fluid/dygraph/nn.py:259` LayerNorm's default epsilon
LN_EPS = 1e-5
# `fluid/dygraph/nn.py:145` BatchNorm's default epsilon
BN_EPS = 1e-5


def layer_norm(x, weight, bias, eps=LN_EPS):
    """Normalize over the last dim.  The statistics are computed in f32
    and the result cast back to x's dtype, as the reference's
    `_ln_fwd_impl` does; bf16 parameters meet a bf16 x under AMP."""
    y = F.layer_norm(x.float(), (x.shape[-1],),
                     None if weight is None else weight.float(),
                     None if bias is None else bias.float(), eps)
    return y.to(x.dtype)


def dropout(x, p, generator=None, training=True):
    """``upscale_in_train`` dropout: kept values scaled by 1 / (1 - p) in
    training, identity in eval.  The keep mask comes from ``generator``
    (a `torch.Generator` on x's device), so a step's noise is a function
    of its seed alone."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) >= p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def gelu(x):
    """Exact-erf gelu (`gelu` op with ``approximate=False``)."""
    return F.gelu(x)


def take_along_axis(x, idx, axis):
    """`jnp.take_along_axis`: ``idx`` has x's rank, broadcast along the
    other axes as `torch.gather` needs it."""
    shape = list(x.shape)
    shape[axis] = idx.shape[axis]
    return torch.gather(x, axis, idx.long().expand(shape))


def softmax_with_cross_entropy(logits, label, ignore_index=-100):
    """Per-row loss ``[..., 1]`` of hard labels (``label`` ``[..., 1]`` or
    ``[...]``), from log-softmax of the f32-upcast logits and cast back
    to the logits' dtype, as `nn_ops.py:665-680`.  Rows whose label is
    ``ignore_index`` get 0."""
    if label.dim() == logits.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    label = label.long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = label != ignore_index
    loss = -torch.gather(logp, -1, torch.where(valid, label, 0)[..., None])
    loss = torch.where(valid[..., None], loss, 0.0)
    return loss.to(logits.dtype)


def batch_norm_eval(x, weight, bias, mean, var, eps=BN_EPS):
    """Eval-mode BatchNorm over dim 1 of an ``[B, C, H, W]`` tensor (any
    memory format): ``(x − mean) · rsqrt(var + eps) · weight + bias``
    computed in f32 from f32 statistics and cast back to x's dtype, the
    reference's ``is_test`` formula (`nn_ops.py:279-288`).  A bf16 x
    meets f32 statistics in one pass (`F.batch_norm`'s mixed types)."""
    return F.batch_norm(x, mean.float(), var.float(), weight.float(),
                        bias.float(), False, 0.0, eps)


def max_pool_3x3s2(x):
    """The ResNet stem's max pool: 3x3 window, stride 2, padding 1, the
    padding never chosen (the reference pads with -inf, `nn_ops.py:148`)."""
    return F.max_pool2d(x, 3, 2, 1)


def global_avg_pool(x):
    """``[B, C, H, W]`` -> ``[B, C]``: the mean over the spatial axes
    (`reduce_mean(h, dim=[1, 2])` on the reference's NHWC trunk)."""
    return x.mean(dim=(2, 3))
