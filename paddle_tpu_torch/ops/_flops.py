"""Model-FLOP counting that sees through the hand kernels.

`torch.utils.flop_counter` counts the matmul-class aten ops
(``mm``, ``addmm``, ``bmm``, convolutions, SDPA).  The hand kernels are
ctypes launches inside `torch.autograd.Function`s (`_build`), so no
aten op carries their work.  So each kernel wrapper reports its own
work through `counts_flops`, by a formula of its operands' shapes:
attention with the formulas torch's counter uses for SDPA (forward
``4 B H Sq Sk D``, backward ``8 B H Sq Sk D``), the GEMM and conv
kernels ``2 M N K`` a product.  The aten ops a wrapper runs itself (its
plain version on the CPU) are not counted again, so the count is the
same whichever implementation runs.  Elementwise work is not counted:
the total is the model-FLOPs numerator.
"""

from __future__ import annotations

import functools
import inspect

from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["FlopCounter", "counts_flops"]


class FlopCounter(TorchDispatchMode):
    """``with FlopCounter() as c: ...`` leaves in ``c.flops`` the FLOPs of
    the aten ops run in the block, forward and backward (torch's
    formulas), plus the hand kernels' own counts; the ops inside a
    counting wrapper are not counted."""

    _active = []        # the counters in force, innermost last

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0
        self._inside = 0    # depth of counting wrappers now running

    def __enter__(self):
        FlopCounter._active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        FlopCounter._active.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._inside:
            formula = self._formulas.get(func.overloadpacket)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
        return out


def counts_flops(formula):
    """Decorate a kernel wrapper: under a `FlopCounter`, a call adds
    ``formula(**arguments)`` (the wrapper's arguments by name, defaults
    filled in) and hides the aten ops the wrapper runs.  A counting
    wrapper called by another adds nothing."""

    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not FlopCounter._active:
                return fn(*args, **kwargs)
            counter = FlopCounter._active[-1]
            if not counter._inside:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                counter.flops += int(formula(**bound.arguments))
            counter._inside += 1
            try:
                return fn(*args, **kwargs)
            finally:
                counter._inside -= 1

        return wrapper

    return deco
