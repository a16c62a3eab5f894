"""Device resolution for every entry point of the port.

``device=None`` means the card.  A box without one raises instead of
quietly running on the CPU; callers that want the CPU (the tests) say
so with ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """Return the `torch.device` an entry point runs on.

    ``None`` -> ``cuda`` (raises `RuntimeError` when no CUDA device is
    present); anything else is passed to `torch.device` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default, and "
                "none is available here; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
