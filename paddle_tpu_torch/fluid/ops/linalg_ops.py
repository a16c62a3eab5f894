"""Linear-algebra ops: kron, einsum, cholesky, inverse, matrix_power,
triangular_solve, cross and multi_dot.

Counterpart of the matching part of `paddle_tpu/fluid/ops/linalg_ops.py`
(kron :17, einsum :22, cholesky :27, inverse :35, matrix_power :40,
triangular_solve :45, cross :58, multi_dot :106; cf. Paddle's
kron_op.cc, cholesky_op.cc, inverse_op.cc, matrix_power_op.cc,
triangular_solve, cross_op.cc and the einsum / multi_dot python APIs).
One `torch.linalg` (or torch) call per op, as the reference's is one
jnp / lax call: the factorizations and solves are the library's on
either side.
"""

import torch

from ..core.registry import register_op


@register_op("kron", inputs=["X", "Y"], outputs=["Out"])
def _kron(ctx, ins, attrs):
    return {"Out": [torch.kron(ins["X"][0], ins["Y"][0])]}


@register_op("einsum", inputs=["Operands"], outputs=["Out"])
def _einsum(ctx, ins, attrs):
    return {"Out": [torch.einsum(attrs["equation"], *ins["Operands"])]}


@register_op("cholesky", inputs=["X"], outputs=["Out"])
def _cholesky(ctx, ins, attrs):
    """The lower factor (its transpose when ``upper``) of X's symmetric
    part, as ``jnp.linalg.cholesky`` symmetrizes its input: the gradient
    is symmetric."""
    x = ins["X"][0]
    low = torch.linalg.cholesky((x + x.mT) / 2)
    return {"Out": [low.mT if attrs.get("upper", False) else low]}


@register_op("inverse", inputs=["Input"], outputs=["Output"])
def _inverse(ctx, ins, attrs):
    return {"Output": [torch.linalg.inv(ins["Input"][0])]}


@register_op("matrix_power", inputs=["X"], outputs=["Out"])
def _matrix_power(ctx, ins, attrs):
    return {"Out": [torch.linalg.matrix_power(ins["X"][0], int(attrs["n"]))]}


@register_op("triangular_solve", inputs=["X", "Y"], outputs=["Out"])
def _triangular_solve(ctx, ins, attrs):
    """Out with X · Out = Y (X^T · Out = Y under ``transpose``), X read
    in its upper (``upper``, the default) or lower triangle, its
    diagonal taken as ones under ``unitriangular``."""
    x, y = ins["X"][0], ins["Y"][0]
    upper = bool(attrs.get("upper", True))
    if attrs.get("transpose", False):
        x, upper = x.mT, not upper
    vec = y.dim() == 1
    out = torch.linalg.solve_triangular(
        x, y[:, None] if vec else y, upper=upper,
        unitriangular=bool(attrs.get("unitriangular", False)))
    return {"Out": [out[:, 0] if vec else out]}


@register_op("cross", inputs=["X", "Y"], outputs=["Out"])
def _cross(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("dim")
    if axis is None:  # first axis of size 3 (reference default)
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return {"Out": [torch.linalg.cross(x, ins["Y"][0], dim=int(axis))]}


@register_op("multi_dot", inputs=["X"], outputs=["Out"])
def _multi_dot(ctx, ins, attrs):
    return {"Out": [torch.linalg.multi_dot(list(ins["X"]))]}
