"""The plain operators of the training and ResNet paths, with the
reference's conventions where they differ from PyTorch's defaults.

Counterparts of `paddle_tpu/fluid/ops/nn_ops.py` (`layer_norm` :413,
`dropout` :401, `softmax_with_cross_entropy` :652, `batch_norm` :259
in both branches, `pool2d` :116) and of the `fluid.layers` `gelu` /
`take_along_axis` / `reduce_mean` ops.  No Pallas kernel lies here:
each is a PyTorch composition or an `autograd.Function` over plain
tensor ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["BN_EPS", "BN_MOMENTUM", "LN_EPS", "batch_norm_eval",
           "batch_norm_train", "dropout", "gelu", "global_avg_pool",
           "layer_norm", "max_pool_3x3s2", "running_update",
           "softmax_with_cross_entropy", "take_along_axis"]

# `fluid/dygraph/nn.py:259` LayerNorm's default epsilon
LN_EPS = 1e-5
# `fluid/dygraph/nn.py:145` BatchNorm's default epsilon and momentum
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


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


def _bcast(v):
    return v.view(1, -1, 1, 1)


def _affine(weight, bias, m, rstd, dtype):
    """BatchNorm's normalize as one affine ``x · k + c``, ``k = γ · rstd``
    and ``c = β − m · γ · rstd`` formed in f32 and rounded to x's dtype
    (`nn_ops.py:222-225`)."""
    s32 = weight.float()
    k = (s32 * rstd).to(dtype)
    c = (bias.float() - m * s32 * rstd).to(dtype)
    return k, c


def _shifted_stats(x, eps):
    """Batch mean and rsqrt(biased var + eps) over every axis but 1, in
    f32, reduced about one sample per channel (``x[0, :, 0, 0]``), as
    `_bn_train_fwd_impl` does (`nn_ops.py:203-220`), so that
    ``E[(x−s)²] − E[x−s]²`` does not cancel when |mean| ≫ std."""
    shift = x[0, :, 0, 0].float()
    xs = x.float() - _bcast(shift)
    d = xs.mean(dim=(0, 2, 3))
    d2 = xs.square_().mean(dim=(0, 2, 3))
    del xs
    var = torch.clamp_min(d2 - d * d, 0.0)
    return shift + d, torch.rsqrt(var + eps)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm over dim 1 of ``[B, C, H, W]``.  ``mean`` and
    ``var`` None: the statistics come from x (`_shifted_stats`) and the
    backward is the reference's `_bn_train_b` (`nn_ops.py:234-252`), in
    x's dtype with f32 sums.  Given (f32, from the 1x1 conv kernel): they
    are inputs with gradients, ``dmean = −γ rstd Σdy`` and ``dvar = −½ γ
    rstd² dγ``, and dx is ``dy · k``; the producer of the statistics
    adds their part (`conv_bn._ConvBnStats`).  Returns ``(y, m, rstd)``,
    the last two not differentiable."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps):
        if mean is None:
            m, rstd = _shifted_stats(x, eps)
        else:
            m, rstd = mean.float(), torch.rsqrt(var.float() + eps)
        k, c = _affine(weight, bias, m, rstd, x.dtype)
        y = x * _bcast(k) + _bcast(c)
        ctx.stats_given = mean is not None
        ctx.save_for_backward(x, weight, m, rstd)
        ctx.mark_non_differentiable(m, rstd)
        return y, m, rstd

    @staticmethod
    def backward(ctx, dy, _dm, _drstd):
        x, weight, m, rstd = ctx.saved_tensors
        dt = x.dtype
        axes = (0, 2, 3)
        s_dy = torch.sum(dy, axes, dtype=torch.float32)
        s_dyx = torch.sum(dy * x, axes, dtype=torch.float32)
        dgamma = (s_dyx - m * s_dy) * rstd
        s32 = weight.float()
        k = (s32 * rstd).to(dt)
        if ctx.stats_given:
            dx = dy * _bcast(k)
            dmean = -s32 * rstd * s_dy
            dvar = -0.5 * s32 * rstd * rstd * dgamma
        else:
            n = x.numel() // x.shape[1]
            g1 = (s_dy / n).to(dt)
            g2 = (dgamma * rstd / n).to(dt)
            dx = (_bcast(k) * (dy - _bcast(g1))
                  - _bcast(k * g2) * (x - _bcast(m.to(dt))))
            dmean = dvar = None
        return (dx, dgamma.to(weight.dtype), s_dy.to(weight.dtype), dmean,
                dvar, None)


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     momentum=BN_MOMENTUM, eps=BN_EPS, batch_stats=None):
    """Train-mode BatchNorm over dim 1 of an ``[B, C, H, W]`` tensor (any
    memory format), the reference's ``batch_norm`` op outside ``is_test``
    (`nn_ops.py:292-311`).  Returns ``(y, mean_out, var_out)``:

    * y = ``x · k + c`` in x's dtype, k and c formed in f32 from the
      batch statistics and rounded to x's dtype;
    * the running statistics' update, in f32 and not differentiable:
      ``running_mean · momentum + batch_mean · (1 − momentum)`` and the
      same of ``running_var`` and the *biased* batch variance, recovered
      as ``max(1/rstd² − eps, 0)``.  (`F.batch_norm` weighs the other way
      and stores the unbiased variance.)

    ``batch_stats``: None to take the statistics from x (about a
    one-sample shift), or ``(mean, var)``, the f32 batch mean and biased
    variance of the unrounded x (`ops.conv1x1_bn_stats`'s), which then
    carry gradients back to their producer."""
    mean, var = (None, None) if batch_stats is None else batch_stats
    y, m, rstd = _BatchNormTrain.apply(x, weight, bias, mean, var, eps)
    return (y,) + running_update(running_mean, running_var, m, rstd,
                                 momentum, eps)


def running_update(running_mean, running_var, m, rstd, momentum=BN_MOMENTUM,
                   eps=BN_EPS):
    """``(mean_out, var_out)``: the running statistics moved toward the
    batch's mean ``m`` and biased variance ``max(1/rstd² − eps, 0)`` with
    Paddle's ``momentum`` (0.9 keeps 90%), in f32 and not
    differentiable, cast to the running statistics' dtypes."""
    with torch.no_grad():
        batch_var = torch.clamp_min(1.0 / rstd.square() - eps, 0.0)
        mean_out = running_mean * momentum + m * (1 - momentum)
        var_out = running_var * momentum + batch_var * (1 - momentum)
    return mean_out.to(running_mean.dtype), var_out.to(running_var.dtype)


def max_pool_3x3s2(x):
    """The ResNet stem's max pool: 3x3 window, stride 2, padding 1, the
    padding never chosen (the reference pads with -inf, `nn_ops.py:148`)."""
    return F.max_pool2d(x, 3, 2, 1)


def global_avg_pool(x):
    """``[B, C, H, W]`` -> ``[B, C]``: the mean over the spatial axes
    (`reduce_mean(h, dim=[1, 2])` on the reference's NHWC trunk)."""
    return x.mean(dim=(2, 3))
