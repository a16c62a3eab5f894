"""Functional layers over the port's kernels
(`paddle_tpu.nn.functional` counterpart)."""

from __future__ import annotations

from ..ops.matmul import matmul_bias_act

__all__ = ["fused_linear"]


def fused_linear(x, weight, bias=None, activation="none",
                 approximate=False):
    """Linear + bias + activation as one fused-epilogue GEMM
    (`ops.matmul_bias_act`): on the card the bias add and activation run
    on the f32 accumulator before the writeback, and the backward forms
    dact·dY inside its dX / dW kernels.  ``activation`` in {"none",
    "relu", "tanh", "gelu"} (``approximate`` picks the tanh gelu).

    ``weight`` is ``[N, K]`` (`nn.Linear.weight`); x ``[..., K]`` is
    flattened to ``[M, K]`` over its leading dims (the reference op's
    ``x_num_col_dims = ndim - 1``) and the result reshaped to
    ``[..., N]``."""
    k = x.shape[-1]
    out = matmul_bias_act(x.reshape(-1, k), weight, bias,
                          activation=activation, approximate=approximate)
    return out.reshape(*x.shape[:-1], weight.shape[0])
