"""Layer functions that build the port's ops into the default programs
(counterpart of `paddle_tpu/fluid/layers/`, the parts that build the
ops the port has: every public function of its `tensor`, `ops` and
`learning_rate_scheduler` modules, and of `nn` and `loss` those
listed here)."""

from . import (  # noqa: F401
    common,
    learning_rate_scheduler,
    loss,
    math_op_patch,
    nn,
    ops,
    tensor,
)
from .learning_rate_scheduler import (  # noqa: F401
    cosine_decay,
    exponential_decay,
    inverse_time_decay,
    linear_lr_warmup,
    natural_exp_decay,
    noam_decay,
    piecewise_decay,
    polynomial_decay,
)
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
from .tensor import *  # noqa: F401,F403
