"""Dtype names <-> `torch.dtype`.

Counterpart of `paddle_tpu/fluid/core/dtypes.py`: the program IR names
dtypes by string ("float32", "int64", ...); the port's scope and ops
hold `torch.dtype`s.
"""

import numpy as np
import torch

_STR2TORCH = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}

_CANON = {v: k for k, v in _STR2TORCH.items()}


def to_torch(dtype):
    """Any dtype spec (str, np.dtype, `torch.dtype`) -> `torch.dtype`."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _STR2TORCH[to_str(dtype)]


def to_str(dtype):
    """Canonical string name for a dtype."""
    if isinstance(dtype, torch.dtype):
        return _CANON[dtype]
    if isinstance(dtype, str) and dtype in _STR2TORCH:
        return dtype
    return str(np.dtype(dtype))


def is_floating(dtype):
    return to_torch(dtype).is_floating_point


def recorded(dtype):
    """The dtype name the IR records for an op's inferred output.  The
    reference infers under JAX's default 32-bit mode, where an int64
    result comes out int32, so a program records ``int32`` there (the
    port's tensors keep their own dtype at run time)."""
    name = to_str(dtype)
    return "int32" if name == "int64" else name
