"""Functional layers of the port (`paddle_tpu.nn` counterpart)."""

from . import functional  # noqa: F401
