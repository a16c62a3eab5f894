"""Metric ops: accuracy.

Counterpart of the matching part of `paddle_tpu/fluid/ops/metric_ops.py`
(accuracy :9-29).  The reference's auc, precision_recall and
detection_map wait for a later slice (ROADMAP Queue A 3).
"""

import torch

from ..core.registry import register_op


@register_op(
    "accuracy",
    inputs=["Out", "Indices", "Label"],
    outputs=["Accuracy", "Correct", "Total"],
    grad=None,
)
def _accuracy(ctx, ins, attrs):
    """cf. accuracy_op.cc: fraction of rows whose top-k indices contain
    label.  Correct and Total are int32 scalars, Accuracy f32, all on
    the device (no host read)."""
    indices = ins["Indices"][0]
    label = ins["Label"][0]
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label[:, 0]
    hit = (indices == label[:, None]).any(dim=1)
    correct = hit.sum(dtype=torch.int32)
    total = torch.full((), indices.shape[0], dtype=torch.int32,
                       device=indices.device)
    acc = correct.float() / total.float()
    return {"Accuracy": [acc], "Correct": [correct], "Total": [total]}
