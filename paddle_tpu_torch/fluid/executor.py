"""Executor: run a Program's global block op by op on one device.

Counterpart of `paddle_tpu/fluid/executor.py`: startup, inference and
training runs.  The reference traces the whole block into one XLA
computation; the port interprets it eagerly (`core.block_eval.run_ops`),
each op's lowering launching its own kernels on the Executor's device.
Persistable state lives in a `Scope` of torch tensors: a run reads the
persistable vars it needs from the scope and writes the persistable
vars it produces (a startup program's parameters, a training program's
updated parameters, accumulators and learning rate) back to it;
``batch_norm``'s running statistics go into the scope's own tensors,
in place.

A block runs without autograd, except in a training run (a block with
``vjp_grad`` ops, `backward.append_backward`): there the forward ops
the ``vjp_grad`` ops differentiate run under autograd on a tape
(`core.block_eval.TapePlan`), freed op by op as their gradients are
taken.  The optimizer update ops then update the scope's parameter and
state tensors in place.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import seeded_generator
from . import framework
from .core import dtypes as dtypes_mod
from .core import scope as scope_mod
from .core.block_eval import TapePlan, run_ops
from .core.place import Place, default_place
from .core.registry import LowerContext, get_op_def
from .core.scope import Scope, global_scope


class _Plan:
    """What one (program version, feeds, fetches) run reads and writes:
    the persistable inputs it takes from the scope and the persistable
    outputs it writes back."""

    def __init__(self, block, feed_names, fetch_names, scope):
        state_in, produced = [], set()
        for op in block.ops:
            for name in op.all_input_names():
                if name in produced or name in feed_names or name in state_in:
                    continue
                v = block._find_var_recursive(name)
                if scope.has(name):
                    state_in.append(name)
                elif v is not None and v.persistable:
                    raise RuntimeError(
                        "persistable var '%s' read before initialization — "
                        "run the startup program first" % name)
                else:
                    raise RuntimeError(
                        "op %r reads var '%s' which is neither fed, produced, "
                        "nor found in scope" % (op, name))
            produced.update(op.all_output_names())
        for name in fetch_names:
            if name not in produced and name not in feed_names \
                    and name not in state_in:
                raise RuntimeError(
                    "fetch var '%s' is not produced by this program" % name)
        state_out = []
        for op in block.ops:
            for name in op.all_output_names():
                v = block._find_var_recursive(name)
                if ((v is not None and v.persistable) or scope.has(name)) \
                        and name not in state_out:
                    state_out.append(name)
        self.state_in = state_in
        self.state_out = state_out
        # the running statistics an op updates (``batch_norm``'s MeanOut
        # and VarianceOut): written into the scope's tensors in place
        self.in_place = {
            n for op in block.ops
            for slot in get_op_def(op.type).stateful_out_slots
            for n in op.output(slot)}
        self.tape = TapePlan(block.ops) if TapePlan.needed(block.ops) \
            else None


def to_tensor(value, dtype, device):
    """A feed as a tensor of ``dtype`` (a dtype name or None = keep) on
    ``device``: numpy arrays and scalars are copied over, tensors moved
    and cast only where they differ."""
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    if dtype is not None:
        t = t.to(dtypes_mod.to_torch(dtype))
    return t.to(device)


def _write_state(scope, name, value, in_place):
    """A run's persistable output into ``scope``: ``in_place``, copied
    into the tensor the scope holds when shape, dtype and device agree
    (as the update ops write theirs), else set as the scope's value."""
    old = scope.find_var(name)
    if (in_place and isinstance(old, torch.Tensor) and old is not value
            and old.shape == value.shape and old.dtype == value.dtype
            and old.device == value.device):
        old.copy_(value)
    else:
        scope.set(name, value)


def to_numpy(t):
    return t.detach().cpu().numpy()


class Executor:
    """cf. reference fluid.Executor — run(program, feed, fetch_list).

    ``place``: a `CPUPlace` / `CUDAPlace`, or None for the card
    (`core.place.default_place`, which raises on a box without one)."""

    def __init__(self, place: Place = None):
        self.place = place if place is not None else default_place()
        self.device = self.place.get_device()
        self._plans = {}
        self._rng_counter = 0

    def close(self):
        self._plans.clear()

    def _generator(self, program):
        """The run's generator: seeded from the program's ``random_seed``
        plus a per-Executor run counter (the reference's rule), so two
        runs of one program draw different values."""
        self._rng_counter += 1
        seed = program.random_seed
        seed_val = (self._rng_counter if seed is None
                    else seed + self._rng_counter - 1)
        return seeded_generator(self.device, seed_val)

    def run(
        self,
        program: framework.Program = None,
        feed: dict = None,
        fetch_list=None,
        scope: Scope = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,
    ):
        program = program or framework.default_main_program()
        scope = scope or global_scope()
        block = program.global_block
        fetch_names = [f.name if isinstance(f, framework.Variable) else str(f)
                       for f in (fetch_list or [])]
        feed_vals = {}
        for name, value in (feed or {}).items():
            v = block._find_var_recursive(name)
            feed_vals[name] = to_tensor(value, v.dtype if v is not None
                                        else None, self.device)
        key = (id(program), program._version, tuple(sorted(feed_vals)),
               tuple(fetch_names), id(scope))
        plan = self._plans.get(key) if use_program_cache else None
        if plan is None:
            plan = _Plan(block, set(feed_vals), fetch_names, scope)
            if use_program_cache:
                self._plans[key] = plan
        env = {n: scope.find_var(n) for n in plan.state_in}
        env.update(feed_vals)
        ctx = LowerContext(generator=self._generator(program),
                           is_test=program._is_test, device=self.device)
        with torch.no_grad():
            run_ops(block.ops, env, ctx, plan.tape)
        for n in plan.state_out:
            _write_state(scope, n, env[n], n in plan.in_place)
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches

    def run_startup(self, startup_program=None, scope=None):
        startup_program = startup_program or framework.default_startup_program()
        return self.run(startup_program, feed={}, fetch_list=[], scope=scope)


@contextlib.contextmanager
def scope_guard(scope):
    """cf. fluid.scope_guard: ``global_scope()`` is ``scope`` inside."""
    old = scope_mod._global_scope
    scope_mod._global_scope = scope
    try:
        yield
    finally:
        scope_mod._global_scope = old

