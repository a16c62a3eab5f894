"""ResNet family: the image classifier the port serves and trains.

Counterpart of `paddle_tpu.models.resnet` with its module names, so the
two ``state_dict``s share their keys (``stem._conv.weight``,
``blocks.{i}.conv0._bn._mean``, ...; `convert.py` transposes
``fc.weight``): conv7x7/2 + BN + relu, a 3x3/2 max pool, four stages of
bottleneck (ResNet-50/101/152) or basic (ResNet-18/34) blocks, a global
mean pool and the fc.  BatchNorm's ``weight`` and ``bias`` (γ, β) are
parameters and ``_mean`` and ``_variance`` buffers, as the reference's
(`fluid/dygraph/nn.py:154-166`): ResNet-50 has 161 parameters among its
267 ``state_dict`` entries.

* The input is NCHW ``[B, C, H, W]`` whatever ``data_format`` says; it
  is cast to the weights' dtype and turned channels-last once at entry
  (the reference's trunk transposes once to NHWC), and the whole trunk
  runs in `torch.channels_last` memory.  ``data_format="NCHW"`` computes
  the same function in the same trunk (the reference then runs NCHW
  end to end).
* **Eval** (``.eval()``): each bottleneck block's ``conv0`` (1x1, stride
  1, relu) runs through the hand-written 1x1-conv + BN + relu kernel
  (`ops.conv1x1_bn_relu`, 16 launches a ResNet-50 forward): its
  channels-last input viewed as ``[B·H·W, Cin]`` and its weight as
  ``[Cout, Cin]``, neither copied, the BN folded into an f32 scale and
  shift (`ops.fold_bn`).  The other convs are `F.conv2d` followed by
  `nn_ops.batch_norm_eval`.  The forward is differentiable, so it needs
  no `torch.no_grad()`.
* **Train** (``.train()``): BatchNorm takes batch statistics
  (`nn_ops.batch_norm_train`) and writes its running statistics back in
  place, as the reference's dygraph `BatchNorm.forward` does
  (`fluid/dygraph/nn.py:193-195`).  Every 1x1, stride-1 conv (each
  bottleneck's ``conv0`` and ``conv2``, and the first block's stride-1
  ``short``: 33 launches a ResNet-50 forward) runs through the
  hand-written 1x1-conv + BN-statistics kernel (`ops.conv1x1_bn_stats`)
  on the same views, and the BN normalizes with its statistics.  The
  other convs (the stem, the 3x3s, the strided ``short``s; all of
  ResNet-18/34's) are `F.conv2d` and the BN takes its statistics from
  the conv's output.  The reference runs these convs in XLA, outside
  any Pallas kernel.
* ``dtype=torch.bfloat16`` makes the conv and fc weights, and so the
  activations, bf16; BatchNorm's four vectors stay f32 and its
  statistics and affine are formed in f32.  Under
  `ShardedTrainStep(amp="bf16")` the step casts the f32 masters, γ and
  β among them, to bf16 and keeps the running statistics f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..device import resolve_device
from ..ops import nn_ops

__all__ = ["BasicBlock", "BottleneckBlock", "ConvBNLayer", "ResNet",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152"]

class _Conv2D(nn.Module):
    """A bias-free Conv2D's weight ``[Cout, Cin, k, k]`` (OIHW), kept in
    channels-last memory as the trunk's activations are."""

    def __init__(self, in_ch, out_ch, k, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch, k, k, device=device, dtype=dtype).contiguous(
                memory_format=torch.channels_last))


class _BatchNorm(nn.Module):
    """BatchNorm's state in f32 whatever the trunk's dtype: the
    parameters ``weight`` (γ) and ``bias`` (β), the running-statistic
    buffers ``_mean`` and ``_variance``."""

    def __init__(self, ch, device):
        super().__init__()

        def full(val):
            return torch.full((ch,), val, dtype=torch.float32, device=device)

        self.weight = nn.Parameter(full(1.0))
        self.bias = nn.Parameter(full(0.0))
        self.register_buffer("_mean", full(0.0))
        self.register_buffer("_variance", full(1.0))


class ConvBNLayer(nn.Module):
    """Conv2D (no bias, padding (k - 1) // 2) + BatchNorm + an optional
    relu.  A 1x1, stride-1 layer is one launch of the conv + BN-statistics
    kernel in train mode, and with ``act="relu"`` one launch of the conv +
    BN + relu kernel in eval mode."""

    def __init__(self, in_ch, out_ch, filter_size, stride=1, act=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if act not in (None, "relu"):
            raise ValueError("ConvBNLayer act must be None or 'relu', got %r"
                             % (act,))
        device = resolve_device(device)
        self._stride = stride
        self._padding = (filter_size - 1) // 2
        self._act = act
        self._pointwise = filter_size == 1 and stride == 1
        self._fused = self._pointwise and act == "relu"
        self._conv = _Conv2D(in_ch, out_ch, filter_size, device, dtype)
        self._bn = _BatchNorm(out_ch, device)

    def _rows(self, x):
        """The channels-last x and the 1x1 weight as the kernels' 2-D
        views: ``[B·H·W, Cin]`` and ``[Cout, Cin]``."""
        c = x.shape[1]
        weight = self._conv.weight
        return (x.permute(0, 2, 3, 1).view(-1, c),
                weight.view(weight.shape[0], c))

    @staticmethod
    def _image(y2d, like):
        b, _, h, w = like.shape
        return y2d.view(b, h, w, -1).permute(0, 3, 1, 2)

    def _conv2d(self, x):
        return F.conv2d(x, self._conv.weight, None, self._stride,
                        self._padding)

    def forward(self, x):
        bn = self._bn
        if self.training:
            stats = None
            if self._pointwise:
                y2d, mean, var = ops.conv1x1_bn_stats(*self._rows(x))
                y, stats = self._image(y2d, x), (mean, var)
            else:
                y = self._conv2d(x)
            y, mean_out, var_out = nn_ops.batch_norm_train(
                y, bn.weight, bn.bias, bn._mean, bn._variance,
                batch_stats=stats)
            with torch.no_grad():
                bn._mean.copy_(mean_out)
                bn._variance.copy_(var_out)
        elif self._fused:
            scale, shift = ops.fold_bn(bn.weight, bn.bias, bn._mean,
                                       bn._variance, nn_ops.BN_EPS)
            return self._image(ops.conv1x1_bn_relu(*self._rows(x), scale,
                                                   shift), x)
        else:
            y = nn_ops.batch_norm_eval(self._conv2d(x), bn.weight, bn.bias,
                                       bn._mean, bn._variance)
        return y.relu_() if self._act == "relu" else y


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch, ch, stride=1, shortcut=True, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv0 = ConvBNLayer(in_ch, ch, 1, act="relu", **kw)
        self.conv1 = ConvBNLayer(ch, ch, 3, stride=stride, act="relu", **kw)
        self.conv2 = ConvBNLayer(ch, ch * 4, 1, **kw)
        if not shortcut:
            self.short = ConvBNLayer(in_ch, ch * 4, 1, stride=stride, **kw)
        self._shortcut = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(self.conv0(x)))
        short = x if self._shortcut else self.short(x)
        return y.add_(short).relu_()


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch, ch, stride=1, shortcut=True, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv0 = ConvBNLayer(in_ch, ch, 3, stride=stride, act="relu",
                                 **kw)
        self.conv1 = ConvBNLayer(ch, ch, 3, **kw)
        if not shortcut:
            self.short = ConvBNLayer(in_ch, ch, 1, stride=stride, **kw)
        self._shortcut = shortcut

    def forward(self, x):
        y = self.conv1(self.conv0(x))
        short = x if self._shortcut else self.short(x)
        return y.add_(short).relu_()


_DEPTH_CFG = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (BottleneckBlock, [3, 4, 6, 3]),
    101: (BottleneckBlock, [3, 4, 23, 3]),
    152: (BottleneckBlock, [3, 8, 36, 3]),
}


class ResNet(nn.Module):
    """ResNet-``depth`` classifier: NCHW f32 (or any float) images
    ``[B, in_channels, H, W]`` -> logits ``[B, num_classes]`` in the
    weights' dtype.  Weights are uninitialized until a ``state_dict``
    is loaded (`convert.from_jax_state_dict` of the JAX model's, or of
    `convert.init_resnet_params`); BatchNorm's start at γ 1, β 0, mean
    0, var 1."""

    def __init__(self, depth=50, num_classes=1000, in_channels=3,
                 data_format="NHWC", device=None, dtype=torch.float32):
        super().__init__()
        if data_format not in ("NHWC", "NCHW"):
            raise ValueError("data_format must be 'NHWC' or 'NCHW', got %r"
                             % (data_format,))
        if depth not in _DEPTH_CFG:
            raise ValueError("ResNet depth must be one of %s, got %r"
                             % (sorted(_DEPTH_CFG), depth))
        device = resolve_device(device)
        block, counts = _DEPTH_CFG[depth]
        kw = dict(device=device, dtype=dtype)
        self.stem = ConvBNLayer(in_channels, 64, 7, stride=2, act="relu",
                                **kw)
        self.blocks = nn.ModuleList()
        in_ch = 64
        for stage, (ch, n) in enumerate(zip((64, 128, 256, 512), counts)):
            for i in range(n):
                stride = 2 if i == 0 and stage > 0 else 1
                shortcut = in_ch == ch * block.expansion and stride == 1
                self.blocks.append(block(in_ch, ch, stride=stride,
                                         shortcut=shortcut, **kw))
                in_ch = ch * block.expansion
        self.out_dim = in_ch
        self.fc = nn.Linear(in_ch, num_classes, **kw)

    def forward(self, images):
        w = self.stem._conv.weight
        x = images.to(device=w.device, dtype=w.dtype,
                      memory_format=torch.channels_last)
        h = nn_ops.max_pool_3x3s2(self.stem(x))
        for blk in self.blocks:
            h = blk(h)
        return self.fc(nn_ops.global_avg_pool(h))


def resnet18(**kw):
    return ResNet(18, **kw)


def resnet34(**kw):
    return ResNet(34, **kw)


def resnet50(**kw):
    return ResNet(50, **kw)


def resnet101(**kw):
    return ResNet(101, **kw)


def resnet152(**kw):
    return ResNet(152, **kw)
