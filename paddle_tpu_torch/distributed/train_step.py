"""ShardedTrainStep on one device: forward, backward and the optimizer
update of a model held as plain tensors.

Counterpart of `paddle_tpu/distributed/train_step.py`
(`FunctionalOptimizer` :60, `ShardedTrainStep` :182) at one device and
``zero_stage=0``; meshes, ZeRO stages 1-3, gradient accumulation and
remat come with the multi-GPU slice and raise here.  The contract is the
reference's: ``init()`` returns ``{"params", "buffers", "opt", "step"}``
and ``step(state, batch)`` returns ``(new_state, loss)``; the model's own
parameters are not modified, the state carries the trained ones.

* The model's buffers (BatchNorm's running statistics) ride in the
  state and come back updated: each step runs the model on copies of
  the state's buffers, which its train-mode forward updates in place,
  and returns the copies.  Neither the model nor the input state
  changes.  (The reference carries them in ``params`` with zero
  gradients and throws the op's update away, `train_step.py:394-410`.)

* The user's ``loss_fn(model, batch)`` runs with the model's parameters
  rebound to the state's (`torch.func.functional_call` over a module
  that wraps the model and the loss), so it is written as ordinary
  module code.
* ``amp="bf16"`` (`train_step.py:424-438`): f32 master parameters are
  cast to bf16 for the step; the cast is differentiable, so the
  gradients reach the masters as f32 for the update.  The buffers stay
  f32 (the reference casts them too, but only to read them for an
  update it discards).  Batch entries keep their dtypes (integer ids,
  f32 loss weights).  This is not `torch.autocast`, which casts per op
  by its own lists.
* Dropout draws from one `torch.Generator` per step seeded from
  ``(seed, step)`` (as `generation.sampling.stream_generator` seeds its
  noise), so a step's noise depends on nothing else.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.bert import Dropout

__all__ = ["FunctionalOptimizer", "ShardedTrainStep"]


class FunctionalOptimizer:
    """The reference's adapter from an optimizer to a pure update over
    ``{name: tensor}`` dicts: per-parameter state slots (Adam's
    ``Moment1``, ``Moment2``, ``Beta1Pow``, ``Beta2Pow``; Momentum's
    ``Velocity``) and the optimizer's op applied to the list of all
    parameters."""

    def __init__(self, optimizer):
        if not hasattr(optimizer, "op"):
            raise NotImplementedError(
                "FunctionalOptimizer: the port has Adam, AdamW and "
                "Momentum; got %s" % type(optimizer).__name__)
        self._opt = optimizer
        self.slots = tuple(slot for slot, _ in optimizer.slots)
        self.attrs = optimizer.attrs()

    @property
    def learning_rate(self):
        return self._opt.learning_rate

    def init_state(self, params):
        """Per parameter, each slot in f32: zeros shaped (and laid out)
        like the parameter, or a ``[1]`` scalar at its attribute's value
        (Adam's beta powers start at beta1 and beta2)."""
        state = {}
        for name, p in params.items():
            state[name] = {
                slot: torch.zeros_like(p, dtype=torch.float32)
                if init is None else torch.full(
                    (1,), self.attrs[init], dtype=torch.float32,
                    device=p.device)
                for slot, init in self._opt.slots}
        return state

    @torch.no_grad()
    def apply(self, params, grads, state, lr):
        """``(params, grads, state, lr) -> (new_params, new_state)``; new
        tensors, the inputs are left as they are.  The optimizer's op
        runs once over the lists of all parameters."""
        names = list(params)
        slots = self.slots
        p_out, *new = self._opt.op(
            [params[n] for n in names], [grads[n] for n in names], lr,
            *([state[n][s] for n in names] for s in slots), **self.attrs)
        new_params = dict(zip(names, p_out))
        new_state = {n: dict(zip(slots, vals))
                     for n, vals in zip(names, zip(*new))}
        return new_params, new_state


class _LossModule(nn.Module):
    """``loss_fn(model, batch)`` as a module, so `functional_call` can
    rebind the model's parameters for the length of one call."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


def _step_generator(seed, step, device):
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    return g


class ShardedTrainStep:
    """One training step of ``model`` under ``optimizer`` on the device
    the model lies on.  ``mesh`` must be None and ``zero_stage`` 0 (one
    device); ``amp`` is None or ``"bf16"``.

    Usage::

        step = ShardedTrainStep(model, AdamWOptimizer(1e-4), loss_fn,
                                zero_stage=0, amp="bf16")
        state = step.init()
        state, loss = step(state, batch)
    """

    def __init__(self, model, optimizer, loss_fn, mesh=None, zero_stage=0,
                 amp=None, seed=0):
        if mesh is not None:
            raise NotImplementedError(
                "ShardedTrainStep: meshes (several devices) come with the "
                "multi-GPU slice of the port; pass mesh=None")
        if zero_stage != 0:
            raise NotImplementedError(
                "ShardedTrainStep: zero_stage=%r needs several devices; "
                "the port runs zero_stage=0 on one" % (zero_stage,))
        if amp not in (None, "bf16"):
            raise ValueError("amp must be None or 'bf16', got %r" % (amp,))
        self.model = model
        self.fopt = FunctionalOptimizer(optimizer)
        self.amp = amp
        self.seed = int(seed)
        self._loss_module = _LossModule(model, loss_fn)
        self._dropouts = [m for m in model.modules()
                          if isinstance(m, Dropout)]
        self.device = next(model.parameters()).device

    def init(self):
        """Copies of the model's parameters (the f32 masters) and buffers,
        the optimizer state and the step counter."""
        params = {name: p.detach().clone()
                  for name, p in self.model.named_parameters()}
        buffers = {name: b.detach().clone()
                   for name, b in self.model.named_buffers()}
        return {"params": params, "buffers": buffers,
                "opt": self.fopt.init_state(params), "step": 0}

    def place_batch(self, batch):
        """Move a host batch (numpy arrays or tensors) to the step's
        device, dtypes unchanged; already-placed tensors pass through."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v) if isinstance(v, np.ndarray) else \
                torch.as_tensor(v)
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def _compute_params(self, masters):
        if self.amp == "bf16":
            return {k: v.to(torch.bfloat16) if v.dtype == torch.float32
                    else v for k, v in masters.items()}
        return masters

    def __call__(self, state, batch):
        batch = self.place_batch(batch)
        step = int(state["step"])
        masters = {k: v.detach().requires_grad_()
                   for k, v in state["params"].items()}
        # the forward updates these copies in place (running statistics)
        buffers = {k: v.detach().clone() for k, v in state["buffers"].items()}
        gen = _step_generator(self.seed, step, self.device)
        for m in self._dropouts:
            m.generator = gen
        self.model.train()
        try:
            with torch.enable_grad():
                run = {"model." + k: v for k, v in (
                    *self._compute_params(masters).items(),
                    *buffers.items())}
                loss = torch.func.functional_call(
                    self._loss_module, run, (batch,)).float()
                names = list(masters)
                grads = torch.autograd.grad(
                    loss, [masters[n] for n in names], allow_unused=True)
        finally:
            for m in self._dropouts:
                m.generator = None
        grads = {n: torch.zeros_like(masters[n]) if g is None else g
                 for n, g in zip(names, grads)}
        lr = self.fopt.learning_rate
        lr = float(lr(step)) if callable(lr) else float(lr)
        new_params, new_opt = self.fopt.apply(
            {k: v.detach() for k, v in masters.items()}, grads,
            state["opt"], lr)
        return ({"params": new_params, "buffers": buffers, "opt": new_opt,
                 "step": step + 1}, loss.detach())
