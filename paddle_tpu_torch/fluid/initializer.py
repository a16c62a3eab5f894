"""Parameter initializers emitted as startup-program ops.

Counterpart of `paddle_tpu/fluid/initializer.py`: Constant, Uniform,
Normal and Xavier (the layers' default weight initializer), each
appending its init op to the startup block (``fill_constant``,
``uniform_random``, ``gaussian_random``).
"""

import math


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, var, block):
        block.append_op(
            "fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "value": self.value, "dtype": var.dtype},
            infer=False,
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "min": self.low,
                "max": self.high,
                "seed": self.seed,
                "dtype": var.dtype,
            },
            infer=False,
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "mean": self.loc,
                "std": self.scale,
                "seed": self.seed,
                "dtype": var.dtype,
            },
            infer=False,
        )


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    fan_in = shape[1] * receptive if len(shape) > 1 else shape[0]
    fan_out = shape[0] * receptive
    if len(shape) == 2:  # matmul weight [in, out]
        fan_in, fan_out = shape[0], shape[1]
    return fan_in, fan_out


class XavierInitializer(Initializer):
    """Glorot init (cf. reference XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.fan_out = fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)
