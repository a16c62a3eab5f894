"""NN ops of the reference's op tail: fused_batch_norm_act.

Counterpart of the matching part of `paddle_tpu/fluid/ops/tail_nn_ops.py`
(fused_batch_norm_act :736), the op `fluid.ir.BatchNormActFusePass`
rewrites ``batch_norm`` + activation into.
"""

from ..core.registry import get_op_def, register_op


@register_op(
    "fused_batch_norm_act",
    inputs=["X", "Scale", "Bias", "Mean", "Variance"],
    outputs=["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
    no_grad_slots=("Mean", "Variance"),
    stateful_out_slots=("MeanOut", "VarianceOut"),
)
def _fused_batch_norm_act(ctx, ins, attrs):
    """cf. fused/fused_bn_activation_op.cc: batch_norm + activation in one
    op: ``batch_norm``'s lowering, then the registered ``act_type``'s
    (default relu) on Y."""
    res = get_op_def("batch_norm").lower(ctx, ins, attrs)
    act = attrs.get("act_type", "relu")
    res["Y"] = [get_op_def(act).lower(ctx, {"X": res["Y"]}, {})["Out"][0]]
    return res
