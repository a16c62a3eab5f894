"""The parameter-holding layers the eager vision models and the
Transformer share, with the reference's parameter names and layouts
(`paddle_tpu/fluid/dygraph/nn.py`: Conv2D :60, BatchNorm :145,
Embedding :228).

* `Conv2D`: ``weight`` ``[Cout, Cin / groups, k, k]`` (OIHW, as the
  reference's) and ``bias`` unless ``bias=False``, then the act.  With
  ``channels_last=True`` the weight and the output are kept in
  `torch.channels_last` memory, as a channels-last trunk's activations
  are (otherwise NCHW).
* `BatchNorm`: the parameters ``weight`` (γ) and ``bias`` (β) and the
  running-statistic buffers ``_mean`` and ``_variance``, all f32
  whatever the input's dtype.  Train mode normalizes with the batch's
  statistics (`ops.nn_ops.batch_norm_train`, or statistics a conv kernel
  handed over) and writes the running statistics back in place, as the
  reference's dygraph ``BatchNorm.forward`` does (:193-195); eval mode
  uses the running ones (`ops.nn_ops.batch_norm_eval`).
* `Embedding`: ``weight`` ``[V, D]``, looked up through
  `ops.nn_ops.take` (the reference's ``lookup_table``, ``jnp.take``): an
  id in [-V, 0) counts from the end, one outside [-V, V) gives a NaN row
  and no gradient, with no host sync and no device-side assert.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import nn_ops

__all__ = ["BatchNorm", "Conv2D", "Embedding"]

_ACTS = (None, "relu")


def _check_act(act):
    if act not in _ACTS:
        raise ValueError("act must be None or 'relu', got %r" % (act,))


class Conv2D(nn.Module):
    """A 2-D convolution: ``weight`` ``[Cout, Cin / groups, k, k]`` and an
    optional ``bias`` ``[Cout]``, padding ``padding`` on every side, then
    ``act``.  Uninitialized until a ``state_dict`` is loaded."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, groups=1, bias=True, act=None, device=None,
                 dtype=torch.float32, channels_last=False):
        super().__init__()
        _check_act(act)
        if num_channels % groups or num_filters % groups:
            raise ValueError(
                "Conv2D: groups=%d must divide the %d input and %d output "
                "channels" % (groups, num_channels, num_filters))
        device = resolve_device(device)
        self._stride, self._padding, self._groups = stride, padding, groups
        self._act = act
        w = torch.empty(num_filters, num_channels // groups, filter_size,
                        filter_size, device=device, dtype=dtype)
        self._memory_format = (torch.channels_last if channels_last
                               else torch.contiguous_format)
        w = w.contiguous(memory_format=self._memory_format)
        self.weight = nn.Parameter(w)
        self.bias = (nn.Parameter(torch.zeros(num_filters, device=device,
                                              dtype=dtype))
                     if bias else None)

    def forward(self, x):
        # a grouped conv may answer a channels-last input in NCHW
        y = F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                     1, self._groups).contiguous(
                         memory_format=self._memory_format)
        return y.relu_() if self._act == "relu" else y


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of ``[B, C, H, W]`` (any memory format), then
    ``act``; its four vectors stay f32 whatever the input's dtype."""

    def __init__(self, num_channels, act=None, device=None):
        super().__init__()
        _check_act(act)
        device = resolve_device(device)
        self._act = act

        def full(val):
            return torch.full((num_channels,), val, dtype=torch.float32,
                              device=device)

        self.weight = nn.Parameter(full(1.0))
        self.bias = nn.Parameter(full(0.0))
        self.register_buffer("_mean", full(0.0))
        self.register_buffer("_variance", full(1.0))

    def forward(self, x, batch_stats=None):
        """``batch_stats``: in train mode, None to take the statistics from
        x, or the f32 ``(mean, biased var)`` of x a conv kernel computed
        (`ops.conv1x1_bn_stats`); ignored in eval mode."""
        if self.training:
            y, mean_out, var_out = nn_ops.batch_norm_train(
                x, self.weight, self.bias, self._mean, self._variance,
                batch_stats=batch_stats)
            with torch.no_grad():
                self._mean.copy_(mean_out)
                self._variance.copy_(var_out)
        else:
            y = nn_ops.batch_norm_eval(x, self.weight, self.bias, self._mean,
                                       self._variance)
        return y.relu_() if self._act == "relu" else y


class Embedding(nn.Module):
    """A ``[V, D]`` table looked up by `ops.nn_ops.take`.  Uninitialized
    until a ``state_dict`` is loaded."""

    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids):
        return nn_ops.take(self.weight, ids, 0)
