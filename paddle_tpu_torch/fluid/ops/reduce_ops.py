"""Reduction ops: reduce_sum, reduce_mean, mean.

Counterpart of the matching part of `paddle_tpu/fluid/ops/reduce_ops.py`
(reduce_sum and reduce_mean :23-24, mean :42): ``dim`` (default [0],
negatives from the end), ``keep_dim``, ``reduce_all``.
"""

import torch

from ..core.registry import register_op


def _dims(attrs, ndim):
    if attrs.get("reduce_all", False):
        return tuple(range(ndim))
    dim = attrs.get("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    return tuple(d if d >= 0 else d + ndim for d in dim)


def _register_reduce(name, fn):
    @register_op("reduce_" + name, inputs=["X"], outputs=["Out"])
    def _lower(ctx, ins, attrs, fn=fn):
        x = ins["X"][0]
        return {"Out": [fn(x, dim=_dims(attrs, x.dim()),
                           keepdim=bool(attrs.get("keep_dim", False)))]}


_register_reduce("sum", torch.sum)
_register_reduce("mean", torch.mean)


@register_op("mean", inputs=["X"], outputs=["Out"])
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(ins["X"][0])]}
