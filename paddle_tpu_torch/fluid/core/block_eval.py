"""Shared op-sequence interpreter: the ONE place that runs lowerings.

Counterpart of `paddle_tpu/fluid/core/block_eval.py`.  The reference
traces this loop into one XLA computation; the port runs it eagerly,
op by op, each lowering launching its own kernels.  Used by the
Executor, the inference Predictor and eager initializer evaluation.
"""

from __future__ import annotations

from .registry import get_op_def


def op_fields(op):
    """(type, inputs, outputs, attrs) of an Operator or its dict form."""
    if isinstance(op, dict):
        return op["type"], op["inputs"], op["outputs"], op["attrs"]
    return op.type, op.inputs, op.outputs, op.attrs


def run_ops(ops, env, ctx):
    """Run a sequence of ops over a name -> tensor env (mutated in place).

    ops: framework.Operator objects OR serialized dicts
    (framework.Operator.to_dict form: {"type", "inputs", "outputs", "attrs"}).
    """
    for op in ops:
        op_type, op_ins, op_outs, op_attrs = op_fields(op)
        opdef = get_op_def(op_type)
        try:
            ins = {
                slot: [env[n] for n in names] for slot, names in op_ins.items()
            }
        except KeyError as e:
            raise RuntimeError(
                "op '%s' reads var %s which is not materialized in this "
                "execution environment" % (op_type, e)
            ) from None
        outs = opdef.lower(ctx, ins, op_attrs)
        for slot, names in op_outs.items():
            for n, val in zip(names, outs[slot]):
                env[n] = val
    return env
