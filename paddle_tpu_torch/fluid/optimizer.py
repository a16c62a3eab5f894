"""``fluid.optimizer``: the 13 optimizers, as the reference's
`paddle_tpu/fluid/optimizer.py` names them.  The classes live in
`paddle_tpu_torch.optimizer`, where the eager and the static paths
share their update ops; this module re-exports them."""

from ..optimizer import (  # noqa: F401
    SGD, Adadelta, AdadeltaOptimizer, Adagrad, AdagradOptimizer, Adam,
    Adamax, AdamaxOptimizer, AdamOptimizer, AdamW, AdamWOptimizer,
    DecayedAdagrad, DecayedAdagradOptimizer, Dpsgd, DpsgdOptimizer, Ftrl,
    FtrlOptimizer, Lamb, LambOptimizer, LarsMomentum, LarsMomentumOptimizer,
    Momentum, MomentumOptimizer, Optimizer, RMSProp, RMSPropOptimizer,
    SGDOptimizer,
)
