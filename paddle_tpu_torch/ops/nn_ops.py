"""The plain operators of the training and ResNet paths, with the
reference's conventions where they differ from PyTorch's defaults.

Counterparts of `paddle_tpu/fluid/ops/nn_ops.py` (`layer_norm` :413,
`dropout` :401, `softmax_with_cross_entropy` :652, `batch_norm` :259
in both branches, `pool2d` :116) and of the `fluid.layers` `gelu` /
`take_along_axis` / `reduce_mean` ops, and `take`, the row take of the
index ops (`jnp.take`'s default mode).  No Pallas kernel lies here:
each is a PyTorch composition or an `autograd.Function` over plain
tensor ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["BN_EPS", "BN_MOMENTUM", "DROPOUT_MODES", "LN_EPS",
           "batch_norm_eval", "batch_norm_train", "dropout", "gelu",
           "global_avg_pool",
           "layer_norm", "max_pool_3x3s2", "running_update",
           "softmax_with_cross_entropy", "take", "take_along_axis"]

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


DROPOUT_MODES = ("downgrade_in_infer", "upscale_in_train")


def dropout(x, p, generator=None, training=True, mode="upscale_in_train"):
    """Dropout in the reference's two ``dropout_implementation``s
    (`nn_ops.py:401-421`): ``upscale_in_train`` scales the kept values by
    1 / (1 - p) in training and is the identity in eval;
    ``downgrade_in_infer`` keeps them as they are in training and scales
    everything by 1 - p in eval.  The keep mask comes from ``generator``
    (a `torch.Generator` on x's device), so a step's noise is a function
    of its seed alone."""
    if mode not in DROPOUT_MODES:
        raise ValueError("dropout_implementation must be one of %s, got %r"
                         % (DROPOUT_MODES, mode))
    upscale = mode == "upscale_in_train"
    if not training:
        return x if upscale or p == 0.0 else (x * (1.0 - p)).to(x.dtype)
    if p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) >= p
    return torch.where(keep, x / (1.0 - p) if upscale else x,
                       0.0).to(x.dtype)


def gelu(x):
    """Exact-erf gelu (`gelu` op with ``approximate=False``)."""
    return F.gelu(x)


def _fill_value(dtype):
    """`jnp.take`'s fill for an index out of range: NaN for floating
    types, the least value for signed integers, the largest for unsigned
    ones, True for booleans."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype.is_signed else \
        torch.iinfo(dtype).max


def take(x, idx, axis=0):
    """`jnp.take(x, idx, axis)` in its default ("fill") mode: the rows
    ``idx`` of ``x`` along ``axis``, the index's shape in the axis'
    place.  An id in [-n, 0) counts from the end (``id + n``); an id
    outside [-n, n) gives a row of `_fill_value` (NaN for floats) and,
    in the backward, no contribution to any row, as the gradient of
    JAX's ``take`` drops it.  The mask is formed on the device: no host
    sync, and the gathered index is always in range, so no bad id
    reaches a device-side assert.  A ``[V, D]`` table on axis 0 (an
    embedding) gathers through `F.embedding`, whose CUDA backward sums
    each row's repeats in f32 in a fixed order (``index_select``'s adds
    them atomically in x's dtype: bf16 under AMP, in no fixed order)."""
    axis = axis if axis >= 0 else axis + x.dim()
    n = x.shape[axis]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    shape = x.shape[:axis] + idx.shape + x.shape[axis + 1:]
    fill = _fill_value(x.dtype)
    if n == 0:
        return torch.full(shape, fill, dtype=x.dtype, device=x.device)
    safe = torch.where(valid, idx, 0)
    if x.dim() == 2 and axis == 0:
        out = F.embedding(safe, x)
    else:
        out = x.index_select(axis, safe.reshape(-1)).reshape(shape)
    keep = valid.reshape((1,) * axis + tuple(idx.shape)
                         + (1,) * (x.dim() - axis - 1))
    return torch.where(keep, out, torch.full((), fill, dtype=x.dtype,
                                              device=x.device))


def take_along_axis(x, idx, axis):
    """`jnp.take_along_axis`: ``idx`` has x's rank, broadcast along the
    other axes as `torch.gather` needs it."""
    shape = list(x.shape)
    shape[axis] = idx.shape[axis]
    return torch.gather(x, axis, idx.long().expand(shape))


def softmax_with_cross_entropy(logits, label, ignore_index=-100,
                               soft_label=False):
    """Per-row loss ``[..., 1]`` from log-softmax of the f32-upcast logits,
    cast back to the logits' dtype, as `nn_ops.py:665-680`: of hard
    labels (``label`` ``[..., 1]`` or ``[...]``; rows whose label is
    ``ignore_index`` get 0), or with ``soft_label`` of a distribution
    ``label`` shaped like the logits (``-Σ label · log p``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if soft_label:
        loss = -(label.float() * logp).sum(dim=-1, keepdim=True)
        return loss.to(logits.dtype)
    if label.dim() == logits.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    label = label.long()
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
