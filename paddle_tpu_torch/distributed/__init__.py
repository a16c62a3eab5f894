"""Training steps of the port: `ShardedTrainStep` on one device
(``zero_stage=0``) over a `FunctionalOptimizer`."""

from .train_step import FunctionalOptimizer, ShardedTrainStep  # noqa: F401
