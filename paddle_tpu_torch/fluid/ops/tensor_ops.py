"""Tensor manipulation ops: reshape2, transpose2, flatten2, squeeze2,
unsqueeze2, concat, split, stack, unstack, slice, cast, assign,
fill_constant, assign_value, fill_constant_batch_size_like,
fill_zeros_like, fill_any_like, gather, gather_nd, scatter, one_hot,
expand, tile, pad, arange, linspace, the comparison and logical ops,
where, shape, cumsum, increment, print, crop_tensor, unbind, size,
gather_tree, masked_fill, partial_sum, partial_concat.

Counterpart of `paddle_tpu/fluid/ops/tensor_ops.py` (reshape2 :16,
transpose2 :28, flatten2 :35, squeeze2 :62, unsqueeze2 :75, concat :86,
split :91, stack :109, unstack :114, slice :123, cast :147, assign
:152, fill_constant :157, assign_value :163, fill_constant_batch_size_like
:173, fill_zeros_like :183, fill_any_like :188, gather :195, gather_nd
:200, scatter :206, one_hot :220, expand :233, tile :246, pad :251,
arange :259, linspace :271, the comparisons :286-304, where :317, shape
:322, cumsum :335, increment :347, print :354, crop_tensor :443, unbind
:455, size :464, gather_tree :472, masked_fill :492, partial_sum /
partial_concat :500-523; cf. Paddle's concat_op.cc, cum_op.cc,
compare_op.cc, gather_tree_op.cc).

Integer outputs run int64 where torch indexes in int64 (``shape``,
``size``, the ids of ``gather_tree``) and a program records them int32,
as the reference's 32-bit JAX computes them (`core.dtypes.recorded`).
Every lowering also runs on meta tensors (build-time shape inference);
``print`` prints nothing there.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ...ops import nn_ops
from ..core.dtypes import to_torch
from ..core.registry import register_op


@register_op("reshape2", inputs=["X"], outputs=["Out"])
def _reshape(ctx, ins, attrs):
    x = ins["X"][0]
    shape = list(attrs["shape"])
    # paddle semantics: 0 means "copy input dim", -1 inferred
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": [x.reshape(shape)]}


@register_op("transpose2", inputs=["X"], outputs=["Out"])
def _transpose(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(*attrs["axis"])]}


@register_op("flatten2", inputs=["X"], outputs=["Out"])
def _flatten(ctx, ins, attrs):
    """[prod(dims before axis), prod(the rest)]."""
    x = ins["X"][0]
    lead = 1
    for s in x.shape[:attrs.get("axis", 1)]:
        lead *= int(s)
    return {"Out": [x.reshape(lead, -1)]}


@register_op("squeeze2", inputs=["X"], outputs=["Out"])
def _squeeze(ctx, ins, attrs):
    """The unit dims of ``axes`` (every unit dim when it is empty)."""
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    if not axes:
        return {"Out": [x.squeeze()]}
    return {"Out": [x.squeeze(tuple(a if a >= 0 else a + x.dim()
                                    for a in axes))]}


@register_op("unsqueeze2", inputs=["X"], outputs=["Out"])
def _unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a)
    return {"Out": [x]}


@register_op("concat", inputs=["X"], outputs=["Out"])
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("split", inputs=["X"], outputs=["Out"])
def _split(ctx, ins, attrs):
    """``sections`` (the last takes what remains, as the reference cuts
    at the running sums of the others) or ``num`` equal parts."""
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        cuts = np.cumsum(sections[:-1]).tolist()
        return {"Out": list(torch.tensor_split(x, cuts, dim=axis))}
    num = attrs.get("num", 0)
    if x.shape[axis] % num:
        raise ValueError("split: dim %d of size %d does not divide into %d"
                         % (axis, x.shape[axis], num))
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@register_op("stack", inputs=["X"], outputs=["Y"])
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("unstack", inputs=["X"], outputs=["Y"])
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))}


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


@register_op("assign_value", inputs=[], outputs=["Out"], grad=None)
def _assign_value(ctx, ins, attrs):
    arr = np.array(attrs["values"], dtype=np.dtype(
        attrs.get("dtype", "float32"))).reshape(attrs["shape"])
    return {"Out": [torch.from_numpy(arr).to(ctx.device)]}


@register_op("fill_constant_batch_size_like", inputs=["Input"],
             outputs=["Out"], grad=None)
def _fill_cbsl(ctx, ins, attrs):
    """``shape`` with dim ``output_dim_idx`` taken from the input's dim
    ``input_dim_idx`` (the batch)."""
    x = ins["Input"][0]
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = x.shape[
        attrs.get("input_dim_idx", 0)]
    return {"Out": [torch.full(tuple(shape), attrs["value"],
                               dtype=to_torch(attrs.get("dtype", "float32")),
                               device=x.device)]}


@register_op("fill_zeros_like", inputs=["X"], outputs=["Out"])
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register_op("fill_any_like", inputs=["X"], outputs=["Out"])
def _fill_any_like(ctx, ins, attrs):
    dtype = attrs.get("dtype")
    return {"Out": [torch.full_like(ins["X"][0], attrs["value"],
                                    dtype=to_torch(dtype) if dtype
                                    else None)]}


@register_op("gather", inputs=["X", "Index"], outputs=["Out"],
             no_grad_slots=("Index",))
def _gather(ctx, ins, attrs):
    """Rows ``Index`` of ``X`` along ``axis`` (``jnp.take``: the index's
    shape takes the axis' place; an id in [-n, 0) counts from the end,
    one outside [-n, n) gives a NaN row and no gradient,
    `ops.nn_ops.take`)."""
    return {"Out": [nn_ops.take(ins["X"][0], ins["Index"][0],
                                attrs.get("axis", 0))]}


@register_op("gather_nd", inputs=["X", "Index"], outputs=["Out"],
             no_grad_slots=("Index",))
def _gather_nd(ctx, ins, attrs):
    """``X[Index[..., 0], Index[..., 1], ...]`` with JAX's indexing rule:
    an id in [-n, 0) counts from the end, then every id is clamped into
    [0, n).  The gradient reaches only the elements of in-range ids: an
    element read through a clamp gets none, as JAX's gather VJP drops
    it."""
    x, index = ins["X"][0], ins["Index"][0].long()
    parts, valid = [], None
    for i in range(index.shape[-1]):
        n = x.shape[i]
        part = index[..., i]
        part = torch.where(part < 0, part + n, part)
        ok = (part >= 0) & (part < n)
        valid = ok if valid is None else valid & ok
        parts.append(part.clamp(0, n - 1))
    out = x[tuple(parts)]
    if valid is not None and out.requires_grad:
        keep = valid.reshape(valid.shape + (1,) * (out.dim() - valid.dim()))
        out = torch.where(keep, out, out.detach())
    return {"Out": [out]}


@register_op("scatter", inputs=["X", "Ids", "Updates"], outputs=["Out"],
             no_grad_slots=("Ids",))
def _scatter(ctx, ins, attrs):
    """Rows ``Ids`` of ``X`` set to ``Updates`` (``overwrite``; with
    repeated ids the card names no winner, so hold it to unique ids),
    or ``Updates`` added onto them, repeated ids summing (the
    reference's ``.at[ids].add``).  An id in [-n, 0) counts from the
    end; the update of an id outside [-n, n) is dropped, as JAX drops
    it: it lands in a scratch row past the end that is sliced off, so
    no bad id reaches the device and nothing is read on the host."""
    x, ids, upd = ins["X"][0], ins["Ids"][0].long(), ins["Updates"][0]
    n = x.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    padded = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    out = padded.index_put((ids,), upd.to(x.dtype),
                           accumulate=not attrs.get("overwrite", True))
    return {"Out": [out[:n]]}


@register_op("one_hot", inputs=["X"], outputs=["Out"], grad=None)
def _one_hot(ctx, ins, attrs):
    """f32 rows of ``depth`` over the ids (a trailing unit dim dropped);
    an id outside [0, depth) gives a zero row, as ``jax.nn.one_hot``."""
    x = ins["X"][0]
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    cols = torch.arange(attrs["depth"], device=x.device)
    return {"Out": [(x.unsqueeze(-1) == cols).to(torch.float32)]}


@register_op("expand", inputs=["X"], outputs=["Out"])
def _expand(ctx, ins, attrs):
    """Each dim repeated ``expand_times`` times (the reference's
    ``jnp.tile``)."""
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["expand_times"]))]}


@register_op("tile", inputs=["X"], outputs=["Out"])
def _tile(ctx, ins, attrs):
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["repeat_times"]))]}


@register_op("pad", inputs=["X"], outputs=["Out"])
def _pad(ctx, ins, attrs):
    """``paddings`` = [before_0, after_0, before_1, ...], constant
    ``pad_value``; a negative padding raises, as in ``jnp.pad``."""
    x = ins["X"][0]
    p = attrs["paddings"]
    if any(int(v) < 0 for v in p[:2 * x.dim()]):
        # `jnp.pad` refuses them; `F.pad` would crop
        raise ValueError("pad: paddings must not be negative, got %s"
                         % (list(p),))
    flat = []
    for i in reversed(range(x.dim())):
        flat += [int(p[2 * i]), int(p[2 * i + 1])]
    return {"Out": [F.pad(x, flat, value=attrs.get("pad_value", 0.0))]}


@register_op("arange", inputs=[], outputs=["Out"], grad=None)
def _arange(ctx, ins, attrs):
    return {"Out": [torch.arange(
        attrs["start"], attrs["end"], attrs.get("step", 1),
        dtype=to_torch(attrs.get("dtype", "int64")), device=ctx.device)]}


@register_op("linspace", inputs=[], outputs=["Out"], grad=None)
def _linspace(ctx, ins, attrs):
    return {"Out": [torch.linspace(
        attrs["start"], attrs["stop"], attrs["num"],
        dtype=to_torch(attrs.get("dtype", "float32")), device=ctx.device)]}


def _register_compare(name, fn):
    @register_op(name, inputs=["X", "Y"], outputs=["Out"], grad=None)
    def _lower(ctx, ins, attrs, fn=fn):
        return {"Out": [fn(ins["X"][0], ins["Y"][0])]}


_register_compare("equal", torch.eq)
_register_compare("not_equal", torch.ne)
_register_compare("less_than", torch.lt)
_register_compare("greater_than", torch.gt)
_register_compare("logical_and", torch.logical_and)
_register_compare("logical_or", torch.logical_or)


@register_op("logical_not", inputs=["X"], outputs=["Out"], grad=None)
def _logical_not(ctx, ins, attrs):
    return {"Out": [torch.logical_not(ins["X"][0])]}


@register_op("where", inputs=["Condition", "X", "Y"], outputs=["Out"],
             no_grad_slots=("Condition",))
def _where(ctx, ins, attrs):
    """X where the condition holds, else Y; each branch's gradient only
    where it was chosen."""
    return {"Out": [torch.where(ins["Condition"][0].bool(), ins["X"][0],
                                ins["Y"][0])]}


@register_op("shape", inputs=["Input"], outputs=["Out"], grad=None)
def _shape(ctx, ins, attrs):
    x = ins["Input"][0]
    return {"Out": [torch.tensor(tuple(x.shape), dtype=torch.int64,
                                 device=x.device)]}


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


@register_op("increment", inputs=["X"], outputs=["Out"], grad=None)
def _increment(ctx, ins, attrs):
    """X + step in X's own dtype (an integer counter stays integral)."""
    x, step = ins["X"][0], attrs.get("step", 1.0)
    return {"Out": [x + (step if x.is_floating_point() else int(step))]}


@register_op("print", inputs=["In"], outputs=["Out"])
def _print(ctx, ins, attrs):
    """Passes In through and prints ``message``, the shape and the first
    ``summarize`` values (all when it is not positive) on the host, as
    the reference's host callback prints them; nothing while shapes are
    inferred."""
    x = ins["In"][0]
    if not ctx.is_meta:
        summarize = int(attrs.get("summarize", 20))
        flat = x.detach().reshape(-1)
        head = (flat[:summarize] if summarize > 0 else flat).cpu().numpy()
        message = str(attrs.get("message", ""))
        if attrs.get("print_tensor_shape", True):
            print("%s shape=%s values=%s" % (message, tuple(x.shape), head),
                  flush=True)
        else:
            print("%s %s" % (message, head), flush=True)
    return {"Out": [x]}


@register_op("crop_tensor", inputs=["X"], outputs=["Out"])
def _crop_tensor(ctx, ins, attrs):
    """A ``shape`` window from ``offsets`` (-1 or 0 in ``shape``: to the
    end).  Each offset is clamped so that the window fits, as the
    reference's ``lax.dynamic_slice`` clamps it."""
    x = ins["X"][0]
    offsets = attrs.get("offsets") or [0] * x.dim()
    shape = [x.shape[i] - offsets[i] if s in (-1, 0) else s
             for i, s in enumerate(attrs["shape"])]
    idx = tuple(slice(o, o + n) for o, n in (
        (min(max(int(o), 0), x.shape[i] - n), n)
        for i, (o, n) in enumerate(zip(offsets, shape))))
    return {"Out": [x[idx]]}


@register_op("unbind", inputs=["X"], outputs=["Out"], grad=None)
def _unbind(ctx, ins, attrs):
    return {"Out": list(torch.unbind(ins["X"][0],
                                     dim=int(attrs.get("axis", 0))))}


@register_op("size", inputs=["Input"], outputs=["Out"], grad=None)
def _size(ctx, ins, attrs):
    x = ins["Input"][0]
    return {"Out": [torch.tensor(x.numel(), dtype=torch.int64,
                                 device=x.device)]}


@register_op("gather_tree", inputs=["Ids", "Parents"], outputs=["Out"],
             grad=None)
def _gather_tree(ctx, ins, attrs):
    """The beam-search backtrace over [T, B, W] ids and parents: from
    the last step back, each beam's id at step t, then its parent's
    beam at t - 1 (the reference's scan)."""
    ids, parents = ins["Ids"][0], ins["Parents"][0].long()
    t_len, b, w = ids.shape
    beam = torch.arange(w, device=ids.device).expand(b, w)
    outs = []
    for t in range(t_len - 1, -1, -1):
        outs.append(torch.gather(ids[t], 1, beam))
        beam = torch.gather(parents[t], 1, beam)
    return {"Out": [torch.stack(outs[::-1])]}


@register_op("masked_fill", inputs=["X", "Mask"], outputs=["Out"],
             no_grad_slots=("Mask",))
def _masked_fill(ctx, ins, attrs):
    x, m = ins["X"][0], ins["Mask"][0]
    value = attrs.get("value", 0.0)
    return {"Out": [torch.where(m.bool(), value if x.is_floating_point()
                                else int(value), x)]}


def _partial_cols(ins, attrs):
    """Column windows of partial_sum / partial_concat: ``length`` < 0
    means to the end, and so does a negative ``start_index`` whose
    window reaches the end (as the reference reads them)."""
    start = int(attrs.get("start_index", 0))
    length = int(attrs.get("length", -1))
    parts = []
    for x in ins["X"]:
        if length < 0 or (start < 0 and start + length >= 0):
            end = x.shape[1]
        else:
            end = start + length
        parts.append(x[:, start:end])
    return parts


@register_op("partial_sum", inputs=["X"], outputs=["Out"])
def _partial_sum(ctx, ins, attrs):
    return {"Out": [sum(_partial_cols(ins, attrs))]}


@register_op("partial_concat", inputs=["X"], outputs=["Out"])
def _partial_concat(ctx, ins, attrs):
    return {"Out": [torch.cat(_partial_cols(ins, attrs), dim=1)]}
