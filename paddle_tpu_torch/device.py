"""Device resolution for every entry point of the port.

``device=None`` means the card.  A box without one raises instead of
quietly running on the CPU; callers that want the CPU (the tests) say
so with ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "seeded_generator"]


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


_MASK64 = (1 << 64) - 1


def _splitmix64(z):
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def seeded_generator(device, *parts):
    """A `torch.Generator` on ``device`` seeded from the integers
    ``parts`` (a seed, a step, a micro-batch index, ...), chained through
    splitmix64.  A CPU generator (mt19937) keeps only the low 32 bits of
    its seed, so every part must reach those bits: after the mix they
    differ whenever any part differs (bar a 2^-32 collision)."""
    h = 0
    for p in parts:
        h = _splitmix64(h ^ (int(p) & _MASK64))
    return torch.Generator(device=device).manual_seed(h)
