"""The VGG family, eager: the counterpart of `paddle_tpu.models.vgg`
(the book's vgg16_bn_drop and hapi's VGG), with its ``_CFGS``, its keys
(``conv{i}.weight``, ``conv{i}.bias`` without batch norm, ``bn{i}.weight``
/ ``.bias`` / ``._mean`` / ``._variance`` with it, ``fc1``, ``fc2``,
``head``; `convert.py` transposes the Linear weights) and its dropout:
``Dropout(p)`` left at the reference class's default,
``downgrade_in_infer`` (train keeps the kept values as they are, eval
scales by 1 - p).  3x3 convs (padding 1; a bias only without batch
norm), BatchNorm + relu or relu, 2x2 max pools of stride 2, a global
mean pool, fc 512 -> 512 relu twice (each followed by the dropout) and
the head.  No hand-written kernel lies on its path, as none does on
the reference's (its convs are XLA's; here cuDNN's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .bert import Dropout
from .layers import BatchNorm, Conv2D

__all__ = ["VGG", "vgg16", "vgg19"]

_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
         "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
         512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Module):
    """NCHW images ``[B, in_channels, H, W]`` -> logits ``[B,
    num_classes]``.  ``device=None`` is the card; the weights are
    uninitialized until a ``state_dict`` is loaded (BatchNorm starts at
    γ 1, β 0, mean 0, var 1)."""

    def __init__(self, depth=16, num_classes=1000, in_channels=3,
                 batch_norm=True, dropout=0.5, device=None,
                 dtype=torch.float32):
        super().__init__()
        if depth not in _CFGS:
            raise ValueError("VGG depth must be one of %s" % list(_CFGS))
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self._blocks = []
        ch = in_channels
        for i, v in enumerate(_CFGS[depth]):
            if v == "M":
                self._blocks.append(None)
                continue
            conv = Conv2D(ch, v, 3, padding=1, bias=not batch_norm,
                          act=None if batch_norm else "relu", **kw)
            setattr(self, "conv%d" % i, conv)
            bn = None
            if batch_norm:
                bn = BatchNorm(v, act="relu", device=device)
                setattr(self, "bn%d" % i, bn)
            self._blocks.append((conv, bn))
            ch = v
        self.dropout = Dropout(dropout)
        self.fc1 = nn.Linear(512, 512, **kw)
        self.fc2 = nn.Linear(512, 512, **kw)
        self.head = nn.Linear(512, num_classes, **kw)

    def forward(self, x):
        w = self.head.weight
        x = x.to(device=w.device, dtype=w.dtype)
        for block in self._blocks:
            if block is None:
                x = F.max_pool2d(x, 2, 2)
                continue
            conv, bn = block
            x = conv(x)
            if bn is not None:
                x = bn(x)
        x = x.mean(dim=(2, 3))
        x = self.dropout(self.fc1(x).relu_())
        x = self.dropout(self.fc2(x).relu_())
        return self.head(x)


def vgg16(**kw):
    return VGG(depth=16, **kw)


def vgg19(**kw):
    return VGG(depth=19, **kw)
