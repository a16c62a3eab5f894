"""Weight-decay regularizers added to the gradients by the eager
``minimize``.

Counterpart of `paddle_tpu/fluid/regularizer.py`: ``L2Decay`` adds
``coeff * param`` to the gradient, ``L1Decay`` ``coeff * sign(param)``,
and a parameter's own ``regularizer`` attribute wins over the
optimizer's (`append_regularization_ops`, :64-74).  The reference
appends a ``scale`` and a ``sum`` op per parameter; here each
regularizer adds its term to a list of gradients with multi-tensor ops,
returning new gradients (the parameters' ``.grad`` is left as it is).
"""

from __future__ import annotations

import torch

__all__ = ["L1Decay", "L1DecayRegularizer", "L2Decay", "L2DecayRegularizer",
           "WeightDecayRegularizer", "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, params, grads):
        """New gradients: ``grads`` plus this regularizer's term of
        ``params`` (lists of one length)."""
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = float(regularization_coeff)

    def __call__(self, params, grads):
        return torch._foreach_add(grads, torch._foreach_mul(
            [p.to(g.dtype) for p, g in zip(params, grads)], self._coeff))


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = float(regularization_coeff)

    def __call__(self, params, grads):
        sign = torch._foreach_sign([p.to(g.dtype)
                                    for p, g in zip(params, grads)])
        return torch._foreach_add(grads, torch._foreach_mul(sign,
                                                            self._coeff))


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, global_regularizer=None):
    """``[(param, grad)]`` with each gradient regularized by the
    parameter's own ``regularizer`` or else by ``global_regularizer``;
    the pairs keep their order, and one multi-tensor pass runs a
    regularizer."""
    out = list(params_grads)
    groups = {}
    for i, (p, _) in enumerate(out):
        reg = getattr(p, "regularizer", None) or global_regularizer
        if reg is not None:
            groups.setdefault(id(reg), (reg, []))[1].append(i)
    for reg, idx in groups.values():
        new = reg([out[i][0] for i in idx], [out[i][1] for i in idx])
        for i, g in zip(idx, new):
            out[i] = (out[i][0], g)
    return out
