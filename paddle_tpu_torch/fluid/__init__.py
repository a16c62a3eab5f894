"""The static-graph Fluid core of the port: Program IR, op registry,
Executor, backward, the static optimizers, io and IR passes.

Counterpart of `paddle_tpu/fluid/` (the static half), with the same
module names and the same JSON IR.  Tensors are torch tensors on an
explicit `torch.device` (``CPUPlace`` / ``CUDAPlace``; the card unless
the caller asks for the CPU), random ops draw from explicit
`torch.Generator`s, and a block runs op by op.  The op library holds
the ops a static BERT pretraining program and the Fluid book's
fit_a_line, recognize_digits (LeNet-5, the MLP) and
image_classification (VGG with batch norm) programs train and serve
with and are initialized by, and the 13 dense update ops;
``append_backward`` / ``gradients`` and ``optimizer``'s ``minimize``
build training programs, which the `Executor` runs.
"""

from . import ops  # registers every operator of the port  # noqa: F401
from . import (  # noqa: F401
    backward,
    initializer,
    io,
    ir,
    layers,
    optimizer,
    unique_name,
)
from .backward import append_backward, gradients  # noqa: F401
from .core.place import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
    default_place,
    is_compiled_with_cuda,
)
from .core.scope import Scope, global_scope  # noqa: F401
from .executor import Executor, scope_guard  # noqa: F401
from .framework import (  # noqa: F401
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .layer_helper import ParamAttr  # noqa: F401


def data(name, shape, dtype="float32", lod_level=0):
    """fluid.data — no implicit batch dim (cf. reference fluid/data.py)."""
    return layers.tensor.data(
        name, shape, dtype=dtype, append_batch_size=False
    )
