"""MobileNetV1, eager: the counterpart of `paddle_tpu.models.mobilenet`
(hapi's depthwise-separable stacks), with its ``scale`` rule (widths
``max(int(n · scale), 8)``) and its keys (``stem.conv.weight``,
``blocks.{i}.dw.bn._mean``, ``blocks.{i}.pw.conv.weight``, ...,
``head.weight``; `convert.py` transposes the head).

Each layer is a `resnet.ConvBNLayer` (conv without bias, padding (k -
1) // 2, BatchNorm, relu) under the reference's ``conv`` / ``bn``
names, so the kernels' dispatch is ResNet's:

* the depthwise 3x3 is a grouped conv (``groups`` = channels), cuDNN's;
* each of the 13 pointwise 1x1 stride-1 layers runs in eval through
  the hand-written 1x1 conv + BN + relu kernel (`ops.conv1x1_bn_relu`,
  kernel 10) and in train through the 1x1 conv + BN-statistics kernel
  (`ops.conv1x1_bn_stats`, kernel 11), on channels-last views;
* the stem (3x3, stride 2) is cuDNN's.

As in the port's ResNet, the input is NCHW ``[B, C, H, W]``, cast to the
weights' dtype and turned channels-last once at entry; the trunk runs in
`torch.channels_last` memory.  Under ``ShardedTrainStep(amp="bf16")``
the convs and the head run bf16 and BatchNorm's statistics f32.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_ops
from .resnet import ConvBNLayer

__all__ = ["MobileNetV1", "mobilenet_v1"]

_NAMES = ("conv", "bn")


class _DepthwiseSeparable(nn.Module):
    def __init__(self, in_ch, out_ch, stride, **kw):
        super().__init__()
        self.dw = ConvBNLayer(in_ch, in_ch, 3, stride=stride, act="relu",
                              groups=in_ch, names=_NAMES, **kw)
        self.pw = ConvBNLayer(in_ch, out_ch, 1, act="relu", names=_NAMES,
                              **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Module):
    """NCHW images ``[B, in_channels, H, W]`` -> logits ``[B,
    num_classes]`` in the weights' dtype.  ``device=None`` is the card;
    the weights are uninitialized until a ``state_dict`` is loaded
    (`convert.from_jax_state_dict` of the JAX model's, or of
    `convert.init_mobilenet_params`)."""

    def __init__(self, num_classes=1000, scale=1.0, in_channels=3,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)

        def c(n):
            return max(int(n * scale), 8)

        self.stem = ConvBNLayer(in_channels, c(32), 3, stride=2, act="relu",
                                names=_NAMES, **kw)
        cfg = [
            (c(32), c(64), 1), (c(64), c(128), 2), (c(128), c(128), 1),
            (c(128), c(256), 2), (c(256), c(256), 1), (c(256), c(512), 2),
            (c(512), c(512), 1), (c(512), c(512), 1), (c(512), c(512), 1),
            (c(512), c(512), 1), (c(512), c(512), 1), (c(512), c(1024), 2),
            (c(1024), c(1024), 1),
        ]
        self.blocks = nn.ModuleList(
            [_DepthwiseSeparable(i, o, s, **kw) for i, o, s in cfg])
        self.head = nn.Linear(c(1024), num_classes, **kw)
        self._feat = c(1024)

    def forward(self, images):
        w = self.stem.conv_layer.weight
        x = images.to(device=w.device, dtype=w.dtype,
                      memory_format=torch.channels_last)
        x = self.stem(x)
        for block in self.blocks:
            x = block(x)
        return self.head(nn_ops.global_avg_pool(x))


def mobilenet_v1(**kw):
    return MobileNetV1(**kw)
