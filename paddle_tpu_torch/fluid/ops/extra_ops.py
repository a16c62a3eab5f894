"""take_along_axis (counterpart of `paddle_tpu/fluid/ops/extra_ops.py`
:153): ``Input`` gathered along ``Axis`` at ``Index``, the index's
size-1 dims broadcast against the input's."""

import torch

from ..core.registry import register_op


@register_op("take_along_axis", inputs=["Input", "Index"],
             outputs=["Result"], no_grad_slots=("Index",))
def _take_along_axis(ctx, ins, attrs):
    return {"Result": [torch.take_along_dim(
        ins["Input"][0], ins["Index"][0].long(), dim=int(attrs["Axis"]))]}
