"""Reduction ops: reduce_sum, reduce_mean, reduce_max, reduce_min,
reduce_prod, mean, arg_max, arg_min, top_k, top_k_v2, argsort.

Counterpart of the matching part of `paddle_tpu/fluid/ops/reduce_ops.py`
(``_register_reduce`` :20 and the reductions :27-31, mean :46, arg_max
:51, arg_min :61, top_k and top_k_v2 :68-75, argsort :77; cf. Paddle's
reduce_ops/, arg_min_max_op_base.h, argsort_op.cc): ``dim``
(default [0], negatives from the end), ``keep_dim``, ``reduce_all``.
reduce_max / reduce_min split a tie's gradient evenly among the tied
elements (``torch.amax`` / ``amin``, as JAX's ``jnp.max``); an int32
input's sum and product stay int32, as the reference's.  The index ops
return int64 (recorded int32 in a program, as the reference's 32-bit
JAX computes them); arg_max / arg_min take the first of tied elements
and argsort is stable, as JAX's.
"""

import torch

from ..core.registry import register_op
from .tensor_ops import int_accumulator


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


def _prod(x, dim, keepdim):
    """torch.prod over several dims, the last first (torch takes one)."""
    dt = int_accumulator(x)
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, d, keepdim=keepdim, dtype=dt)
    return x


_register_reduce("sum", lambda x, dim, keepdim: torch.sum(
    x, dim, keepdim=keepdim, dtype=int_accumulator(x)))
_register_reduce("mean", torch.mean)
_register_reduce("max", torch.amax)
_register_reduce("min", torch.amin)
_register_reduce("prod", _prod)


@register_op("mean", inputs=["X"], outputs=["Out"])
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(ins["X"][0])]}


@register_op("arg_max", inputs=["X"], outputs=["Out"], grad=None)
def _arg_max(ctx, ins, attrs):
    return {"Out": [torch.argmax(ins["X"][0], dim=attrs.get("axis", -1),
                                 keepdim=bool(attrs.get("keepdims",
                                                        False)))]}


@register_op("arg_min", inputs=["X"], outputs=["Out"], grad=None)
def _arg_min(ctx, ins, attrs):
    return {"Out": [torch.argmin(ins["X"][0], dim=attrs.get("axis", -1))]}


@register_op("top_k", inputs=["X"], outputs=["Out", "Indices"], grad=None)
def _top_k(ctx, ins, attrs):
    """The k largest along the last axis, largest first, and their int64
    indices (recorded int32 in a program, as the reference's are)."""
    vals, idx = torch.topk(ins["X"][0], attrs.get("k", 1), dim=-1)
    return {"Out": [vals], "Indices": [idx]}


register_op("top_k_v2", inputs=["X"], outputs=["Out", "Indices"],
            grad=None)(_top_k)


@register_op("argsort", inputs=["X"], outputs=["Out", "Indices"], grad=None)
def _argsort(ctx, ins, attrs):
    """A stable sort along ``axis``, of -X when ``descending`` (so ties
    keep their order either way, as the reference's ``jnp.argsort``)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    idx = torch.sort(-x if attrs.get("descending", False) else x, dim=axis,
                     stable=True).indices
    return {"Out": [torch.gather(x, axis, idx)], "Indices": [idx]}
