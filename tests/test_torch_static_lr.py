"""The static learning-rate schedules (`fluid.layers.learning_rate_
scheduler`) held against `paddle_tpu.fluid` on the CPU.

* Each schedule, and ``linear_lr_warmup`` over a float and over another
  schedule, builds the JAX program dict for dict (the startup's counter
  ``fill_constant``, the main program's ``increment`` and its
  ``lr_schedule`` op) and gives JAX's rate over 12 Executor runs
  (1e-6); the counter in the scope counts the runs.
* A schedule as an optimizer's learning rate: Adam on a small fc net
  with ``noam_decay``, and SGD with ``piecewise_decay``, build JAX's
  training program and train to JAX's parameters, each run's rate
  computed anew before the update ops.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import layers, unique_name

from torch_static_common import jax_state_unchanged

RUNS = 12
COUNTER = "@LR_DECAY_COUNTER@"


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


SCHEDULES = {
    "noam_decay": lambda L: L.noam_decay(64, 4, learning_rate=2.0),
    "exponential_decay": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_decay-staircase": lambda L: L.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 3, 0.5, True),
    "inverse_time_decay": lambda L: L.inverse_time_decay(0.1, 2, 0.5),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 8, 0.001, 2.0),
    "polynomial_decay-cycle": lambda L: L.polynomial_decay(
        0.1, 5, 0.001, 1.0, cycle=True),
    "cosine_decay": lambda L: L.cosine_decay(0.1, 2, 6),
    "piecewise_decay": lambda L: L.piecewise_decay([3, 7, 9],
                                                   [0.1, 0.05, 0.01, 0.001]),
    "linear_lr_warmup-float": lambda L: L.linear_lr_warmup(0.5, 6, 0.0,
                                                           0.1),
    "linear_lr_warmup-noam": lambda L: L.linear_lr_warmup(
        L.noam_decay(64, 4), 5, 0.001, 0.01),
}


def _build(pkg, L, guard, fn):
    main, startup = pkg.Program(), pkg.Program()
    with guard(), pkg.program_guard(main, startup):
        out = fn(L)
    return main, startup, out


def _both(fn):
    return (_build(jfluid, jlayers, jun.guard, fn),
            _build(fluid, layers, unique_name.guard, fn))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_builds_and_runs_as_jax(name):
    (jmain, jstart, jlr), (main, start, lr) = _both(SCHEDULES[name])
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()
    assert lr.name == jlr.name and not lr.persistable and lr.shape == (1,)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    got, want = [], []
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        exe.run(start, scope=scope)
        for _ in range(RUNS):
            want.append(jexe.run(jmain, fetch_list=[jlr])[0])
            got.append(exe.run(main, fetch_list=[lr], scope=scope)[0])
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert len(set(got.tolist())) > 1, got      # the rate moves
    assert scope.find_var(COUNTER).tolist() == [float(RUNS)]
    assert np.asarray(jscope.find_var(COUNTER)).tolist() == [float(RUNS)]


def test_noam_follows_its_float64_formula():
    """noam's f32 rate against d^-0.5 min(s^-0.5, s w^-1.5) in float64
    at steps 1..12 (relative 1e-6)."""
    _, (main, start, lr) = _both(SCHEDULES["noam_decay"])
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(start, scope=scope)
    got = [exe.run(main, fetch_list=[lr], scope=scope)[0][0]
           for _ in range(RUNS)]
    s = np.arange(1, RUNS + 1, dtype=np.float64)
    want = 2.0 * 64 ** -0.5 * np.minimum(s ** -0.5, s * 4 ** -1.5)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _net(pkg, L, opt_fn):
    x = L.data("x", shape=[8, 4], append_batch_size=False)
    label = L.data("y", shape=[8, 1], dtype="int64", append_batch_size=False)
    h = L.fc(x, size=6, act="tanh")
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=3), label))
    lr = opt_fn(pkg, L)
    return loss, lr


OPTIMIZED = {
    "adam-noam": lambda pkg, L: pkg.optimizer.AdamOptimizer(
        L.noam_decay(16, 3, 0.5)),
    "sgd-piecewise": lambda pkg, L: pkg.optimizer.SGDOptimizer(
        L.piecewise_decay([2, 4], [0.5, 0.2, 0.05])),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZED))
def test_a_schedule_drives_the_optimizer_as_in_jax(name):
    def fn(pkg, L):
        opt = OPTIMIZED[name](pkg, L)
        loss, _ = _net(pkg, L, lambda *_: None)
        opt.minimize(loss)
        return loss, opt._global_learning_rate()

    def build(pkg, L, guard):
        main, startup = pkg.Program(), pkg.Program()
        with guard(), pkg.program_guard(main, startup):
            loss, lr = fn(pkg, L)
        return main, startup, loss, lr

    jmain, jstart, jloss, jlr = build(jfluid, jlayers, jun.guard)
    main, start, loss, lr = build(fluid, layers, unique_name.guard)
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()
    types = [o.type for o in main.global_block.ops]
    # the rate is computed before every update op that reads it
    first_update = min(i for i, o in enumerate(main.global_block.ops)
                       if o.attrs.get("op_role") == "optimize")
    assert types.index("lr_schedule") < first_update
    rs = np.random.RandomState(3)
    feed = {"x": rs.randn(8, 4).astype(np.float32),
            "y": rs.randint(0, 3, (8, 1)).astype(np.int64)}
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    rates = []
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        for v in jmain.list_vars():
            if v.persistable and jscope.has(v.name):
                scope.set(v.name, torch.from_numpy(
                    np.array(jscope.find_var(v.name))))
        for _ in range(6):
            jl, jr = jexe.run(jmain, feed=feed, fetch_list=[jloss, jlr])
            tl, tr = exe.run(main, feed=feed, fetch_list=[loss, lr],
                             scope=scope)
            np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(tr, jr, rtol=1e-6)
            rates.append(float(tr[0]))
    assert len(set(rates)) > 1, rates
    assert scope.find_var(COUNTER).tolist() == [6.0]
    for v in jmain.list_vars():
        if v.persistable and jscope.has(v.name):
            np.testing.assert_allclose(scope.find_var(v.name).numpy(),
                                       np.asarray(jscope.find_var(v.name)),
                                       rtol=1e-4, atol=1e-5, err_msg=v.name)
