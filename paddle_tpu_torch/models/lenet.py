"""LeNet-5 for MNIST, eager: the counterpart of `paddle_tpu.models.lenet`
(the book's recognize_digits conv-pool x2 + fc head), with its keys
(``conv1.weight``, ``conv1.bias``, ..., ``fc.weight``, ``out.weight``;
`convert.py` transposes the two Linear weights).  Conv2D with a bias and
a relu, 2x2 max pools of stride 2, fc 800 -> 500 relu, out 500 ->
classes.  No hand-written kernel lies on its path, as none does on the
reference's (its convs and pools are XLA's; here cuDNN's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import Conv2D

__all__ = ["LeNet5"]


class _MaxPool2(nn.Module):
    """The reference's ``Pool2D(2, "max", 2)``: no parameters."""

    def forward(self, x):
        return F.max_pool2d(x, 2, 2)


class LeNet5(nn.Module):
    """NCHW ``[B, 1, 28, 28]`` images -> logits ``[B, num_classes]``.
    ``device=None`` is the card; the weights are uninitialized until a
    ``state_dict`` is loaded."""

    def __init__(self, num_classes=10, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv2D(1, 20, 5, act="relu", **kw)
        self.pool1 = _MaxPool2()
        self.conv2 = Conv2D(20, 50, 5, act="relu", **kw)
        self.pool2 = _MaxPool2()
        self.fc = nn.Linear(50 * 4 * 4, 500, **kw)
        self.out = nn.Linear(500, num_classes, **kw)

    def forward(self, x):
        w = self.fc.weight
        x = x.to(device=w.device, dtype=w.dtype)
        h = self.pool1(self.conv1(x))
        h = self.pool2(self.conv2(h))
        return self.out(self.fc(h.reshape(-1, 50 * 4 * 4)).relu_())
