"""ShardedTrainStep on one device: forward, backward and the optimizer
update of a model held as plain tensors.

Counterpart of `paddle_tpu/distributed/train_step.py`
(`FunctionalOptimizer` :60, `ShardedTrainStep` :182) at one device and
``zero_stage=0``, with the reference's whole constructor signature;
meshes, ZeRO stages 1-3, ``param_rule``, ``batch_specs`` and
``gather_chunk_bytes`` come with the multi-GPU slice and raise here.
The contract is the reference's: ``init()`` returns ``{"params",
"buffers", "opt", "step"}`` and ``step(state, batch)`` returns
``(new_state, loss)``; the model's own parameters are not modified, the
state carries the trained ones.

* ``donate=True`` (the reference's default, ``donate_argnums=(0,)``):
  the update is written into the input state's tensors in place and
  those same tensors come back, so a step holds one copy of the
  parameters and slots; the input state must not be used again.
  ``donate=False`` leaves the input state untouched and returns new
  tensors (the forward and backward still read the input's; the copies
  are made just before the update, so they do not outlive the
  activations' peak).  Both give bitwise the same state.
* The model's buffers (BatchNorm's running statistics) ride in the
  state and come back updated: the train-mode forward updates the
  state's buffers in place (copies of them under ``donate=False``).
  (The reference carries them in ``params`` with zero gradients and
  throws the op's update away, `train_step.py:394-410`.)
* The user's ``loss_fn(model, batch)`` runs with the model's parameters
  rebound to the state's (`torch.func.functional_call` over a module
  that wraps the model and the loss), so it is written as ordinary
  module code.
* ``amp="bf16"`` (`train_step.py:424-438`): f32 master parameters are
  cast to bf16 for the step; the cast is differentiable, so the
  gradients reach the masters as f32 for the update.  The buffers stay
  f32.  Batch entries keep their dtypes.  This is not `torch.autocast`,
  which casts per op by its own lists.
* ``remat=True`` checkpoints the whole loss call, as
  ``jax.checkpoint(loss_of)`` does (:415-416): non-reentrant
  `torch.utils.checkpoint` around the `functional_call` itself, so the
  backward's recompute runs on the state's parameters, and rebuilds
  every activation.  The recompute restores each dropout generator's
  state first (the checkpoint restores only the default generators), so
  it draws the same keep masks, and runs on throwaway copies of the
  buffers, so running statistics are updated once.
* ``accumulate_steps=k`` (:441-481) splits every batch entry's leading
  dimension into k micro-batches, each one forward and backward;
  gradients are summed in f32, and the loss and gradients are the
  k-mean (a ratio loss becomes a mean of per-micro-batch ratios, the
  reference's convention, :212-221).  Each micro-batch draws its own
  dropout stream; the buffers pass through the micro-batches in order
  (the reference discards them).
* Dropout draws from one `torch.Generator` a micro-batch seeded from
  ``(seed, step)`` (and the micro-batch's index when k > 1), so a
  step's noise depends on nothing else.  ``prng_impl`` is accepted for
  signature parity: the port has one generator family.
* `cost_analysis(state, batch)`: the FLOPs of one step's forward and
  backward (recompute and micro-batches included), counted on first
  request by one more forward and backward under `FlopCounter`, which
  leaves the state as it is; None until a step of that batch signature
  has run.  The step itself runs uncounted.
* The optimizer's ``regularization`` and ``grad_clip`` are not applied
  here, as the reference's `FunctionalOptimizer` ignores them; the
  eager ``minimize`` applies both.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import optimizer as optim
from ..device import seeded_generator
from ..models.bert import Dropout
from ..observability.cost import FlopCounter, feed_signature

__all__ = ["FunctionalOptimizer", "ShardedTrainStep"]

# the optimizers the reference's FunctionalOptimizer adapts
# (`train_step.py:39-99`): AdamW and LAMB are Adam subclasses
_ADAPTED = (optim.SGDOptimizer, optim.MomentumOptimizer, optim.AdamOptimizer)


class FunctionalOptimizer:
    """The reference's adapter from an optimizer to an update over
    ``{name: tensor}`` dicts: per-parameter state slots (Adam's and
    LAMB's ``Moment1``, ``Moment2``, ``Beta1Pow``, ``Beta2Pow``;
    Momentum's ``Velocity``; none for SGD) and the optimizer's op
    applied to the list of all parameters.  The other eight optimizers
    raise, as in the reference: they run through ``minimize``."""

    def __init__(self, optimizer):
        if not isinstance(optimizer, _ADAPTED):
            raise NotImplementedError(
                "FunctionalOptimizer: the train step adapts SGD, Momentum, "
                "Adam, AdamW and Lamb, as the reference's does; %s runs "
                "through minimize()" % type(optimizer).__name__)
        self._opt = optimizer
        self.slots = tuple(slot for slot, _, _ in optimizer.slots)
        self.attrs = optimizer.attrs()

    @property
    def learning_rate(self):
        return self._opt.learning_rate

    def init_state(self, params):
        """Per parameter, each slot in f32: shaped (and laid out) like the
        parameter, or a ``[1]`` scalar (Adam's beta powers start at beta1
        and beta2)."""
        return {name: self._opt.init_slots(p) for name, p in params.items()}

    @torch.no_grad()
    def apply_(self, params, grads, state, lr):
        """The update in place: the optimizer's op once over the lists of
        all parameters and their slots."""
        names = list(params)
        self._opt.op([params[n] for n in names], [grads[n] for n in names],
                     lr, *([state[n][s] for n in names] for s in self.slots),
                     **self.attrs)

    def apply(self, params, grads, state, lr):
        """``(params, grads, state, lr) -> (new_params, new_state)``; new
        tensors, the inputs are left as they are."""
        params = {k: v.clone() for k, v in params.items()}
        state = {k: {s: v.clone() for s, v in st.items()}
                 for k, st in state.items()}
        self.apply_(params, grads, state, lr)
        return params, state


class _LossModule(nn.Module):
    """``loss_fn(model, batch)`` as a module, so `functional_call` can
    rebind the model's parameters for the length of one call."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


def _copy(tensors):
    """Copies of a ``{name: tensor}`` dict (layouts kept) in one
    multi-tensor launch, not one a tensor."""
    out = {k: torch.empty_like(v) for k, v in tensors.items()}
    if out:
        torch._foreach_copy_(list(out.values()), list(tensors.values()))
    return out


def _step_generator(seed, step, device, micro=None):
    """The dropout generator of one step (``micro`` None) or of one of
    its micro-batches: the seed, the step and the micro-batch's index
    mixed into the generator's seed, each reaching the low 32 bits a
    CPU generator keeps (`device.seeded_generator`)."""
    parts = (seed, step) if micro is None else (seed, step, int(micro) + 1)
    return seeded_generator(device, *parts)


class ShardedTrainStep:
    """One training step of ``model`` under ``optimizer`` on the device
    the model lies on.  ``mesh`` must be None and ``zero_stage`` 0 (one
    device); ``amp`` is None or ``"bf16"``.

    Usage::

        step = ShardedTrainStep(model, LambOptimizer(1e-4), loss_fn,
                                amp="bf16", remat=True,
                                accumulate_steps=2)
        state = step.init()
        state, loss = step(state, batch)   # the old state is donated
        step.cost_analysis(state, batch)   # {"flops": ...}
    """

    def __init__(self, model, optimizer, loss_fn, mesh=None,
                 param_rule=None, batch_specs=None, zero_stage=0,
                 donate=True, remat=False, amp=None, prng_impl="rbg",
                 accumulate_steps=1, gather_chunk_bytes=None, seed=0):
        if mesh is not None:
            raise NotImplementedError(
                "ShardedTrainStep: meshes (several devices) come with the "
                "multi-GPU slice of the port; pass mesh=None")
        if zero_stage != 0:
            raise NotImplementedError(
                "ShardedTrainStep: zero_stage=%r needs several devices; "
                "the port runs zero_stage=0 on one" % (zero_stage,))
        for name, value in (("param_rule", param_rule),
                            ("batch_specs", batch_specs),
                            ("gather_chunk_bytes", gather_chunk_bytes)):
            if value is not None:
                raise NotImplementedError(
                    "ShardedTrainStep: %s places tensors across devices, "
                    "which comes with the multi-GPU slice of the port; "
                    "leave it None" % name)
        if amp not in (None, "bf16"):
            raise ValueError("amp must be None or 'bf16', got %r" % (amp,))
        self.accumulate_steps = int(accumulate_steps)
        if self.accumulate_steps < 1:
            raise ValueError("accumulate_steps must be >= 1")
        self.model = model
        self.fopt = FunctionalOptimizer(optimizer)
        self.amp = amp
        self.donate = bool(donate)
        self.remat = bool(remat)
        self.prng_impl = prng_impl
        self.seed = int(seed)
        self._loss_module = _LossModule(model, loss_fn)
        self._dropouts = [m for m in model.modules()
                          if isinstance(m, Dropout)]
        self.device = next(model.parameters()).device
        self._seen = set()  # batch signatures stepped
        self._flops = {}    # batch signature -> counted FLOPs of a step

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

    @staticmethod
    def _batch_sig(batch):
        """The signature key of a batch of numpy arrays or tensors, with
        torch's dtype names either way (no copy, no device move)."""
        return feed_signature({
            k: torch.from_numpy(v) if isinstance(v, np.ndarray)
            else torch.as_tensor(v) for k, v in batch.items()})

    def cost_analysis(self, train_state, batch):
        """``{"flops": n}``: the FLOPs of one step of this batch signature,
        forward and backward, the recompute under ``remat`` and every
        micro-batch included (matmul-class work: aten formulas and the
        hand kernels' own counts, `ops._flops`).  None until a step of
        the signature has run.  The first request counts one forward and
        backward on ``train_state``'s parameters and copies of its
        buffers; the state is not changed."""
        sig = self._batch_sig(batch)
        if sig not in self._seen:
            return None
        if sig not in self._flops:
            self._flops[sig] = self._count_flops(train_state, batch)
        return {"flops": float(self._flops[sig])}

    def _count_flops(self, state, batch):
        masters = {k: v.detach().requires_grad_()
                   for k, v in state["params"].items()}
        buffers = {k: v.clone() for k, v in state["buffers"].items()}
        counter = FlopCounter()
        self.model.train()
        try:
            with counter:
                self._losses_and_grads(masters, buffers,
                                       self.place_batch(batch),
                                       int(state["step"]))
        finally:
            for m in self._dropouts:
                m.generator = None
        return counter.flops

    def _compute_params(self, masters):
        if self.amp == "bf16":
            return {k: v.to(torch.bfloat16) if v.dtype == torch.float32
                    else v for k, v in masters.items()}
        return masters

    def _split_micro(self, batch):
        """The k micro-batches: every entry's rows cut into k equal runs
        (`train_step.py:441-455`'s check and error)."""
        acc = self.accumulate_steps
        for k, v in batch.items():
            if v.dim() < 1 or v.shape[0] % acc:
                raise ValueError(
                    "accumulate_steps=%d does not divide batch dim %s of "
                    "feed %r (every batch entry needs a leading batch dim "
                    "divisible by accumulate_steps)"
                    % (acc, tuple(v.shape[:1]), k))
        return [{k: v.chunk(acc)[i] for k, v in batch.items()}
                for i in range(acc)]

    def _loss_and_grads(self, masters, buffers, batch, gen):
        """One forward and backward of ``batch`` with dropout drawing from
        ``gen``: (f32 loss, {name: grad}).  The forward updates
        ``buffers`` in place."""
        for m in self._dropouts:
            m.generator = gen
        names = list(masters)
        with torch.enable_grad():
            compute = self._compute_params(masters)
            run = {"model." + k: v for k, v in compute.items()}
            if not self.remat:
                loss = torch.func.functional_call(
                    self._loss_module, {**run, **{
                        "model." + k: v for k, v in buffers.items()}},
                    (batch,))
            else:
                loss = self._remat_loss(run, buffers, batch, gen)
            loss = loss.float()
            grads = torch.autograd.grad(
                loss, [masters[n] for n in names], allow_unused=True)
        return loss.detach(), {
            n: torch.zeros_like(masters[n]) if g is None else g
            for n, g in zip(names, grads)}

    def _remat_loss(self, run, buffers, batch, gen):
        """The loss call under non-reentrant `checkpoint`.  Its first run
        updates ``buffers``; the backward's recompute restores the
        dropout generator to its state before the first run and updates
        copies of the buffers instead."""
        gen_state = gen.get_state()
        calls = []

        def loss_of(run, batch):
            gen.set_state(gen_state)
            bufs = buffers if not calls else {
                k: v.clone() for k, v in buffers.items()}
            calls.append(1)
            return torch.func.functional_call(
                self._loss_module,
                {**run, **{"model." + k: v for k, v in bufs.items()}},
                (batch,))

        return checkpoint(loss_of, run, batch, use_reentrant=False)

    def _losses_and_grads(self, masters, buffers, batch, step):
        """Loss and f32 gradients of the whole batch: one pass, or the
        k-mean over the micro-batches (f32 sums, buffers carried through
        them in order)."""
        acc = self.accumulate_steps
        if acc == 1:
            return self._loss_and_grads(
                masters, buffers, batch,
                _step_generator(self.seed, step, self.device))
        lsum = gsum = None
        for i, mb in enumerate(self._split_micro(batch)):
            loss, grads = self._loss_and_grads(
                masters, buffers, mb,
                _step_generator(self.seed, step, self.device, micro=i))
            g = [grads[n].float() for n in masters]
            if gsum is None:
                lsum, gsum = loss, g
            else:
                lsum = lsum + loss
                torch._foreach_add_(gsum, g)
        torch._foreach_div_(gsum, acc)
        return lsum / acc, dict(zip(masters, gsum))

    def __call__(self, state, batch):
        batch = self.place_batch(batch)
        step = int(state["step"])
        params, opt, buffers = state["params"], state["opt"], \
            state["buffers"]
        if not self.donate:
            buffers = _copy(buffers)
        masters = {k: v.detach().requires_grad_()
                   for k, v in params.items()}
        self._seen.add(feed_signature(batch))
        self.model.train()
        try:
            loss, grads = self._losses_and_grads(masters, buffers, batch,
                                                 step)
        finally:
            for m in self._dropouts:
                m.generator = None
        del masters
        if not self.donate:
            params = _copy(params)
            flat = _copy({(k, s): v for k, st in opt.items()
                          for s, v in st.items()})
            opt = {k: {s: flat[k, s] for s in st} for k, st in opt.items()}
        lr = self.fopt.learning_rate
        lr = float(lr(step)) if callable(lr) else float(lr)
        self.fopt.apply_(params, grads, opt, lr)
        return ({"params": params, "buffers": buffers, "opt": opt,
                 "step": step + 1}, loss)
