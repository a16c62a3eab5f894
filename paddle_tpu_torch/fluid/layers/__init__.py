"""Layer functions that build the port's ops into the default programs
(counterpart of `paddle_tpu/fluid/layers/`, the parts that build the
ops the port has)."""

from . import common, math_op_patch, nn, ops, tensor  # noqa: F401
from .nn import dropout, embedding, fc, layer_norm  # noqa: F401
from .ops import (  # noqa: F401
    elementwise_add,
    gelu,
    mul,
    relu,
    scale,
    tanh,
)
from .tensor import (  # noqa: F401
    cast,
    data,
    fill_constant,
    reshape,
    slice,
)
