"""Shared op-sequence interpreter: the ONE place that runs lowerings.

Counterpart of `paddle_tpu/fluid/core/block_eval.py`.  The reference
traces this loop into one XLA computation; the port runs it eagerly,
op by op, each lowering launching its own kernels.  Used by the
Executor, the inference Predictor and eager initializer evaluation.

Training runs add a tape (`TapePlan`): the forward ops that the block's
``vjp_grad`` ops differentiate run once under autograd, on inputs
detached from the rest of the block, and each ``vjp_grad`` reads its
forward's graph from the tape instead of recomputing it (the reference
recomputes and leaves the duplicate to XLA's CSE).  An entry is dropped
when its last reader has run, so the graphs are gone before the
optimizer ops update the parameters in place.
"""

from __future__ import annotations

import torch

from .registry import get_op_def


def op_fields(op):
    """(type, inputs, outputs, attrs) of an Operator or its dict form."""
    if isinstance(op, dict):
        return op["type"], op["inputs"], op["outputs"], op["attrs"]
    return op.type, op.inputs, op.outputs, op.attrs


def _strip_role(attrs):
    return {k: v for k, v in attrs.items() if k != "op_role"}


def _forward_of(ops, j):
    """Index of the op the ``vjp_grad`` op ``ops[j]`` differentiates: the
    last op before it of its ``fwd_type`` reading the same inputs with
    the same attrs (None when the block has none)."""
    _, ins, _, attrs = op_fields(ops[j])
    want_ins = {slot: list(ins.get("X$" + slot, []))
                for slot in attrs["fwd_in_slots"]}
    want_attrs = _strip_role(attrs["fwd_attrs"])
    for i in range(j - 1, -1, -1):
        t, i_ins, _, i_attrs = op_fields(ops[i])
        if (t == attrs["fwd_type"]
                and {k: list(v) for k, v in i_ins.items()} == want_ins
                and _strip_role(i_attrs) == want_attrs):
            return i
    return None


class TapePlan:
    """Which ops of a block run under autograd, and which ``vjp_grad``
    ops read them.

    * ``readers``: ``{vjp_grad index: forward index}`` for each
      ``vjp_grad`` that reads its forward's graph from the tape.
    * ``leaf_slots``: ``{forward index: input slots}``: the taped ops and
      the input slots held as autograd leaves (the readers'
      ``grad_in_slots``).
    * ``uses``: ``{forward index: number of readers}``.

    A ``vjp_grad`` that a later ``vjp_grad`` differentiates (double
    grad) is itself taped and reads nothing: it recomputes its forward
    on its own leaves and builds its graph with ``create_graph``."""

    def __init__(self, ops):
        fwd_of = {}
        for j, op in enumerate(ops):
            if op_fields(op)[0] == "vjp_grad":
                i = _forward_of(ops, j)
                if i is not None:
                    fwd_of[j] = i
        differentiated = set(fwd_of.values())
        self.readers = {j: i for j, i in fwd_of.items()
                        if j not in differentiated}
        self.leaf_slots, self.uses = {}, {}
        for j, i in self.readers.items():
            slots = op_fields(ops[j])[3]["grad_in_slots"]
            self.leaf_slots.setdefault(i, set()).update(slots)
            self.uses[i] = self.uses.get(i, 0) + 1

    @staticmethod
    def needed(ops):
        return any(op_fields(op)[0] == "vjp_grad" for op in ops)


def _run_taped(opdef, ctx, ins, attrs, slots):
    """The op under autograd, the inputs of ``slots`` as fresh leaves:
    ``((leaves, outputs), detached outputs)``."""
    leaves = {
        slot: [t.detach().requires_grad_()
               if slot in slots and t.is_floating_point() else t
               for t in ts]
        for slot, ts in ins.items()}
    with torch.enable_grad():
        outs = opdef.lower(ctx, leaves, attrs)
    return (leaves, outs), {slot: [o.detach() for o in os]
                            for slot, os in outs.items()}


def _read(env, op_type, op_ins):
    try:
        return {slot: [env[n] for n in names]
                for slot, names in op_ins.items()}
    except KeyError as e:
        raise RuntimeError(
            "op '%s' reads var %s which is not materialized in this "
            "execution environment" % (op_type, e)
        ) from None


def _write(env, op_outs, outs):
    for slot, names in op_outs.items():
        for n, val in zip(names, outs[slot]):
            env[n] = val


def _group_end(ops, start):
    """End of the stretch of ops from ``start`` that one
    ``lower_group`` call may run: the same type and attrs, and no op
    reading a var an earlier op of the stretch wrote."""
    op_type, _, op_outs, op_attrs = op_fields(ops[start])
    written = {n for ns in op_outs.values() for n in ns}
    end = start + 1
    while end < len(ops):
        t, ins, outs, attrs = op_fields(ops[end])
        if t != op_type or attrs != op_attrs or any(
                n in written for ns in ins.values() for n in ns):
            break
        written.update(n for ns in outs.values() for n in ns)
        end += 1
    return end


def run_ops(ops, env, ctx, tape=None):
    """Run a sequence of ops over a name -> tensor env (mutated in place).

    ops: framework.Operator objects OR serialized dicts
    (framework.Operator.to_dict form: {"type", "inputs", "outputs", "attrs"}).
    tape: a `TapePlan` of ``ops`` for a run with ``vjp_grad`` ops.
    A stretch of ops with a ``lower_group`` (the optimizer updates) runs
    as one call.
    """
    entries, uses = {}, dict(tape.uses) if tape is not None else {}
    idx = 0
    while idx < len(ops):
        op_type, op_ins, op_outs, op_attrs = op_fields(ops[idx])
        opdef = get_op_def(op_type)
        if opdef.lower_group is not None:
            end = _group_end(ops, idx)
            group = [op_fields(op) for op in ops[idx:end]]
            outs = opdef.lower_group(
                ctx, [_read(env, op_type, f[1]) for f in group], op_attrs)
            for f, o in zip(group, outs):
                _write(env, f[2], o)
            idx = end
            continue
        ins = _read(env, op_type, op_ins)
        fwd = tape.readers.get(idx) if tape is not None else None
        ctx.tape_entry = None if fwd is None else entries[fwd]
        ctx.retain_graph = fwd is not None and uses[fwd] > 1
        if tape is not None and idx in tape.leaf_slots:
            entries[idx], outs = _run_taped(opdef, ctx, ins, op_attrs,
                                            tape.leaf_slots[idx])
        else:
            outs = opdef.lower(ctx, ins, op_attrs)
        if fwd is not None:
            uses[fwd] -= 1
            if not uses[fwd]:
                del entries[fwd]
        ctx.tape_entry = None
        _write(env, op_outs, outs)
        idx += 1
    return env
