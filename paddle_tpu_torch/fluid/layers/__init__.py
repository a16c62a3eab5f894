"""Layer functions that build the port's ops into the default programs
(counterpart of `paddle_tpu/fluid/layers/`, the parts that build the
ops the port has)."""

from . import common, loss, math_op_patch, nn, ops, tensor  # noqa: F401
from .loss import (  # noqa: F401
    cross_entropy,
    softmax_with_cross_entropy,
    square_error_cost,
)
from .nn import (  # noqa: F401
    accuracy,
    batch_norm,
    conv2d,
    dropout,
    embedding,
    fc,
    layer_norm,
    pool2d,
)
from .ops import *  # noqa: F401,F403
from .tensor import (  # noqa: F401
    assign,
    cast,
    concat,
    data,
    fill_constant,
    reshape,
    slice,
    take_along_axis,
)
