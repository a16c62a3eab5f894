"""Cost attribution: counted model FLOPs per step -> MFU.

Counterpart of `paddle_tpu/observability/xla_cost.py`.  The reference
reads an XLA executable's ``cost_analysis()``; PyTorch compiles nothing,
so the port counts: `FlopCounter` (`ops._flops`) runs a step under a
dispatch mode that prices the matmul-class aten ops with torch's
formulas and takes the hand kernels' work from their wrappers, the same
count on the card and on the CPU.  Elementwise work is not counted (XLA
counts it), so the port's figure is the model-FLOPs numerator.

* `feed_signature(feed)`: the (name, shape, dtype) key of one batch,
  shared by the step that records a count and the reader;
* `peak_flops(explicit=None, device_name=None)`: the MFU denominator,
  the card's bf16 dense peak known by the name torch reports;
* `record_mfu(name, flops, seconds)`: the ``mfu{executable=}`` gauge of
  the port's `observability.metrics` registry.
"""

from __future__ import annotations

import os

from ..ops._flops import FlopCounter
from .metrics import default_registry

__all__ = ["FlopCounter", "feed_signature", "peak_flops", "record_mfu"]

PEAK_FLOPS_ENV = "PADDLE_TPU_PEAK_FLOPS"

# bf16 dense peak (FLOP/s) by the name `torch.cuda.get_device_name`
# reports: NVIDIA's data sheet for the H100 SXM part, at 700 W
_DEVICE_PEAK = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def feed_signature(feed):
    """Canonical (name, shape, dtype) key of one feed/batch dict: the
    writer (`ShardedTrainStep.__call__`) and the reader
    (``cost_analysis``) share it."""
    return tuple(sorted(
        (k, tuple(v.shape), str(v.dtype)) for k, v in feed.items()))


def peak_flops(explicit=None, device_name=None):
    """The MFU denominator: ``explicit`` > ``$PADDLE_TPU_PEAK_FLOPS`` >
    the table by ``device_name`` (default: the current CUDA device's
    name).  None for a card the table does not know, or no card."""
    if explicit:
        return float(explicit)
    env = os.getenv(PEAK_FLOPS_ENV)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if device_name is None:
        import torch

        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name()
    return _DEVICE_PEAK.get(device_name)


def record_mfu(name, flops, seconds, peak=None, registry=None,
               device_name=None):
    """Set ``mfu{executable=name}`` = flops / seconds / peak; returns the
    MFU (None when the peak is unknown or the inputs are degenerate)."""
    if not flops or not seconds or seconds <= 0:
        return None
    peak = peak_flops(explicit=peak, device_name=device_name)
    if not peak:
        return None
    mfu = float(flops) / float(seconds) / peak
    reg = registry or default_registry()
    reg.gauge(
        "mfu",
        "Measured model FLOP utilization: counted flops / step time / "
        "peak", labelnames=("executable",),
    ).labels(name).set(mfu)
    return mfu
