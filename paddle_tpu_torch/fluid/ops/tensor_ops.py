"""Tensor manipulation ops: reshape2, concat, slice, cast, assign,
fill_constant, fill_zeros_like, cumsum.

Counterpart of `paddle_tpu/fluid/ops/tensor_ops.py` (reshape2 :16,
concat :86, slice :123, cast :147, assign :152, fill_constant :157,
fill_zeros_like :183, cumsum :335; cf. Paddle's concat_op.cc,
cum_op.cc).
"""

import torch

from ..core.dtypes import to_torch
from ..core.registry import register_op


@register_op("reshape2", inputs=["X"], outputs=["Out"])
def _reshape(ctx, ins, attrs):
    x = ins["X"][0]
    shape = list(attrs["shape"])
    # paddle semantics: 0 means "copy input dim", -1 inferred
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": [x.reshape(shape)]}


@register_op("concat", inputs=["X"], outputs=["Out"])
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("slice", inputs=["Input"], outputs=["Out"])
def _slice(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    for a in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out.squeeze(a)
    return {"Out": [out]}


@register_op("cast", inputs=["X"], outputs=["Out"])
def _cast(ctx, ins, attrs):
    return {"Out": [ins["X"][0].to(to_torch(attrs["out_dtype"]))]}


@register_op("assign", inputs=["X"], outputs=["Out"])
def _assign(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register_op("fill_constant", inputs=[], outputs=["Out"])
def _fill_constant(ctx, ins, attrs):
    shape = tuple(attrs.get("shape", []))
    dtype = to_torch(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(shape, attrs["value"], dtype=dtype,
                               device=ctx.device)]}


@register_op("fill_zeros_like", inputs=["X"], outputs=["Out"])
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


def int_accumulator(x):
    """The dtype a sum or product of ``x`` accumulates in: an int32
    input stays int32, as the reference's 32-bit JAX keeps it (torch
    widens every integer to int64, which a program records as int32
    anyway); None (torch's rule) otherwise."""
    return torch.int32 if x.dtype == torch.int32 else None


@register_op("cumsum", inputs=["X"], outputs=["Out"])
def _cumsum(ctx, ins, attrs):
    """The running sum along ``axis``; ``reverse`` from the end, then
    ``exclusive`` drops each element's own term (the sum less it, as
    the reference computes it)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    dt = int_accumulator(x)
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), axis,
                                      dtype=dt), (axis,))
    else:
        out = torch.cumsum(x, axis, dtype=dt)
    if attrs.get("exclusive", False):
        out = out - x
    return {"Out": [out]}
