"""Operator registry: each op type names one PyTorch lowering.

Counterpart of `paddle_tpu/fluid/core/registry.py`.  The port keeps a
registry of its own (it never reads or writes the JAX package's).  A
lowering runs eagerly on torch tensors::

    def lower(ctx, ins, attrs):  # -> {out_slot: [torch.Tensor, ...]}
        ...

where ``ins`` is ``{in_slot: [torch.Tensor, ...]}`` and ``ctx`` a
`LowerContext`.  The same lowering infers shapes at build time, run on
``device="meta"`` tensors (`framework.Block._eval_op_structs`): a meta
tensor holds no data, so every wrapper it reaches takes its plain path.
"""

from __future__ import annotations

import torch


class LowerContext:
    """Per-run context handed to op lowerings.

    - ``rng()`` returns the run's `torch.Generator` (random ops draw
      from it in op order, so a run is reproducible from its seed); the
      reference's context carries a PRNG key instead.
    - ``is_test`` mirrors the reference's global train/eval switch.
    - ``device``: where ops with no tensor input (``fill_constant``,
      the random initializers) put their outputs; ``meta`` during
      shape inference.
    - ``tape_entry`` / ``retain_graph``: set by `block_eval.run_ops`
      before a ``vjp_grad`` op that reads a taped forward: the forward's
      ``(input leaves, outputs)``, and whether a later ``vjp_grad``
      reads them again.
    """

    def __init__(self, generator=None, is_test=False, device="cpu"):
        self.generator = generator
        self.is_test = is_test
        self.device = torch.device(device)
        self.tape_entry = None
        self.retain_graph = False

    @property
    def is_meta(self):
        return self.device.type == "meta"

    def rng(self):
        if self.generator is None:
            raise RuntimeError(
                "This op needs randomness but no torch.Generator was "
                "provided to the lowering context.")
        return self.generator


class OpDef:
    """A registered operator (see the reference's `OpDef` for the slot
    conventions).

    - ``grad_maker``: None for an op with no gradient, ``"auto"`` for the
      generic ``vjp_grad`` op (`fluid.backward`), or the name of a custom
      maker in `fluid.backward.CUSTOM_GRAD_MAKERS`.
    - ``no_grad_slots``: input slots that never receive a gradient
      (integer indices, labels).
    - ``stateful_out_slots``: output slots that update persistable state
      and take no part in autodiff.
    - ``needs_rng``: the lowering draws from ``ctx.rng()``.
    - ``lower_group`` (the port's own; None for most ops):
      ``lower_group(ctx, [ins, ...], attrs) -> [outs, ...]`` runs a
      stretch of consecutive ops of this type with equal attrs as one
      call (`block_eval.run_ops`); the optimizer update ops set it.
    """

    def __init__(self, type, lower, input_slots, output_slots,
                 grad_maker="auto", no_grad_slots=(), stateful_out_slots=(),
                 needs_rng=False):
        self.type = type
        self.lower = lower
        self.input_slots = tuple(input_slots)
        self.output_slots = tuple(output_slots)
        self.grad_maker = grad_maker
        self.no_grad_slots = frozenset(no_grad_slots)
        self.stateful_out_slots = frozenset(stateful_out_slots)
        self.needs_rng = needs_rng
        self.lower_group = None


_OP_REGISTRY: dict[str, OpDef] = {}


def register_op(type, inputs, outputs, grad="auto", no_grad_slots=(),
                stateful_out_slots=(), needs_rng=False):
    """Decorator registering a lowering as op ``type`` (the reference's
    keywords: ``grad``, ``no_grad_slots``, ``stateful_out_slots``,
    ``needs_rng``; see `OpDef`).

    Example::

        @register_op("relu", inputs=["X"], outputs=["Out"])
        def _relu(ctx, ins, attrs):
            return {"Out": [torch.relu(ins["X"][0])]}
    """

    def deco(fn):
        if type in _OP_REGISTRY:
            raise ValueError("op '%s' registered twice" % type)
        _OP_REGISTRY[type] = OpDef(
            type, fn, inputs, outputs, grad_maker=grad,
            no_grad_slots=no_grad_slots,
            stateful_out_slots=stateful_out_slots, needs_rng=needs_rng)
        return fn

    return deco


def get_op_def(type) -> OpDef:
    try:
        return _OP_REGISTRY[type]
    except KeyError:
        raise KeyError(
            "operator '%s' is not registered in the port (registered: "
            "%s)" % (type, ", ".join(sorted(_OP_REGISTRY)))
        ) from None


def has_op(type):
    return type in _OP_REGISTRY


def registered_ops():
    return sorted(_OP_REGISTRY)
