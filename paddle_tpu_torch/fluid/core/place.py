"""Place: typed device identity over `torch.device`.

Counterpart of `paddle_tpu/fluid/core/place.py`.  ``CPUPlace`` is the
host and ``CUDAPlace(i)`` the i-th card; each resolves to a
`torch.device` through `get_device`.  The default place is the card,
through `device.resolve_device` (which raises on a box without one).
"""

import torch


class Place:
    """Base class for device identities."""

    _kind = "undefined"

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def get_device(self) -> torch.device:
        raise NotImplementedError

    def __eq__(self, other):
        return (
            isinstance(other, Place)
            and self._kind == other._kind
            and self.device_id == other.device_id
        )

    def __hash__(self):
        return hash((self._kind, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)


class CPUPlace(Place):
    _kind = "cpu"

    def get_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    _kind = "cuda"

    def get_device(self):
        return torch.device("cuda", self.device_id)


def place_of(device):
    """The Place of a `torch.device` (or a device string)."""
    device = torch.device(device)
    if device.type == "cuda":
        return CUDAPlace(device.index or 0)
    if device.type == "cpu":
        return CPUPlace(0)
    raise ValueError("no Place for device %s" % device)


def default_place():
    """The card (`device.resolve_device(None)`; raises without one)."""
    from ...device import resolve_device

    return place_of(resolve_device(None))


def is_compiled_with_cuda():
    return torch.cuda.is_available()
