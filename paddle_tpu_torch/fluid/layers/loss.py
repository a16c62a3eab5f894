"""Loss layers: softmax_with_cross_entropy, cross_entropy and
square_error_cost (counterpart of the matching part of
`paddle_tpu/fluid/layers/loss.py`)."""

from .common import append_simple_op


def softmax_with_cross_entropy(
    logits,
    label,
    soft_label=False,
    ignore_index=-100,
    numeric_stable_mode=True,
    return_softmax=False,
    axis=-1,
):
    softmax, loss = append_simple_op(
        "softmax_with_cross_entropy",
        {"Logits": logits, "Label": label},
        {"soft_label": soft_label, "ignore_index": ignore_index, "axis": axis},
        out_slots=("Softmax", "Loss"),
    )
    if return_softmax:
        return loss, softmax
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    return append_simple_op(
        "cross_entropy",
        {"X": input, "Label": label},
        {"soft_label": soft_label, "ignore_index": ignore_index},
        out_slots=("Y",),
    )


def square_error_cost(input, label):
    return append_simple_op("square_error_cost", {"X": input, "Y": label})
