"""paddle_tpu_torch.incubate — the part of `paddle_tpu.incubate` the
port's serving tier uses: `fault.FaultPlan`."""

from . import fault  # noqa: F401
