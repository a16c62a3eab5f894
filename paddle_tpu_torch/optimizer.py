"""Adam and AdamW with the reference's conventions.

Counterparts of `paddle_tpu/fluid/optimizer.py` `AdamOptimizer` /
`AdamWOptimizer` (:362, :423), which hold the hyperparameters, and of
the ``adam`` / ``adamw`` op lowerings that update one parameter
(`fluid/ops/optimizer_ops.py:69-113`).  They differ from
`torch.optim.AdamW`, so they are written out here:

* the beta-power accumulators start at beta1 and beta2 (not at 1) and
  are multiplied by beta after each update;
* ``lr_t = lr * sqrt(1 - beta2_pow) / (1 - beta1_pow)``;
* ``p -= lr_t * m1 / (sqrt(m2) + eps)``: eps is added to sqrt(m2)
  unscaled (torch scales it by the bias correction);
* AdamW's decay ``- lr * coeff * p_old`` is decoupled, applied to every
  parameter, from the parameter before this step's Adam update.

`distributed.FunctionalOptimizer` carries the state and applies the ops
to all parameters at once.  Plain tensor ops in f32, no kernel: each
step of the formula is one multi-tensor (`torch._foreach_*`) call over
the parameter list, in the reference's order of operations, so a
step costs a few launches per formula step instead of ~23 per
parameter.  Only ``lr_t * m1`` runs per parameter: each parameter has
its own ``[1]`` beta powers, which the multi-tensor ops cannot
broadcast.
"""

from __future__ import annotations

import torch

__all__ = ["AdamOptimizer", "AdamWOptimizer", "adam", "adamw"]


def _one_minus(xs):
    """``1 - x`` for each tensor of ``xs`` (the same rounding: -x + 1)."""
    return torch._foreach_add(torch._foreach_neg(xs), 1.0)


def adam(p, g, lr, m1, m2, b1p, b2p, beta1=0.9, beta2=0.999,
         epsilon=1e-8):
    """The ``adam`` op over lists of parameters and their state:
    ``(p_out, m1_out, m2_out, b1p_out, b2p_out)``, each a list, from

        m1 = beta1 m1 + (1 - beta1) g,   m2 = beta2 m2 + (1 - beta2) g g,
        lr_t = lr sqrt(1 - b2p) / (1 - b1p),
        p = p - lr_t m1 / (sqrt(m2) + eps),   b1p *= beta1,  b2p *= beta2.
    """
    g = [x.float() for x in g]
    m1o = torch._foreach_mul(m1, beta1)
    torch._foreach_add_(m1o, torch._foreach_mul(g, 1 - beta1))
    m2o = torch._foreach_mul(m2, beta2)
    g2 = torch._foreach_mul(g, 1 - beta2)
    torch._foreach_mul_(g2, g)
    torch._foreach_add_(m2o, g2)
    del g2
    lr_t = torch._foreach_mul(torch._foreach_sqrt(_one_minus(b2p)), lr)
    torch._foreach_div_(lr_t, _one_minus(b1p))
    upd = [a * b for a, b in zip(lr_t, m1o)]
    denom = torch._foreach_sqrt(m2o)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_div_(upd, denom)
    del denom
    p_out = torch._foreach_sub([x.float() for x in p], upd)
    p_out = [a.to(x.dtype) for a, x in zip(p_out, p)]
    return (p_out, m1o, m2o, torch._foreach_mul(b1p, beta1),
            torch._foreach_mul(b2p, beta2))


def adamw(p, g, lr, m1, m2, b1p, b2p, beta1=0.9, beta2=0.999,
          epsilon=1e-8, coeff=0.01):
    """The ``adamw`` op: `adam`, then the decoupled decay
    ``- lr coeff p`` of each parameter as it was before the update."""
    out = adam(p, g, lr, m1, m2, b1p, b2p, beta1, beta2, epsilon)
    decay = torch._foreach_mul([x.float() for x in p], lr * coeff)
    p_out = torch._foreach_sub([x.float() for x in out[0]], decay)
    return ([a.to(x.dtype) for a, x in zip(p_out, p)],) + out[1:]


class AdamOptimizer:
    op = staticmethod(adam)

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        self.learning_rate = learning_rate
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.epsilon = float(epsilon)

    def attrs(self):
        """The op's hyperparameters, as keyword arguments."""
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon}


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay ``coeff = weight_decay`` on every
    parameter (the ``adamw`` op)."""

    op = staticmethod(adamw)

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self.weight_decay = float(weight_decay)

    def attrs(self):
        return dict(super().attrs(), coeff=self.weight_decay)
