"""Reduction ops: reduce_sum, reduce_mean, mean, top_k, top_k_v2.

Counterpart of the matching part of `paddle_tpu/fluid/ops/reduce_ops.py`
(reduce_sum and reduce_mean :23-24, mean :42, top_k and top_k_v2
:68-75): ``dim`` (default [0], negatives from the end), ``keep_dim``,
``reduce_all``.
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


@register_op("top_k", inputs=["X"], outputs=["Out", "Indices"], grad=None)
def _top_k(ctx, ins, attrs):
    """The k largest along the last axis, largest first, and their int64
    indices (recorded int32 in a program, as the reference's are)."""
    vals, idx = torch.topk(ins["X"][0], attrs.get("k", 1), dim=-1)
    return {"Out": [vals], "Indices": [idx]}


register_op("top_k_v2", inputs=["X"], outputs=["Out", "Indices"],
            grad=None)(_top_k)
