"""`paddle_tpu_torch.fluid.backward` and the training Executor held
against `paddle_tpu.fluid` on the CPU.

* The reference's own backward cases (`tests/test_framework.py:81-160`,
  `tests/test_compiler_and_gradients.py:69-125`), each built by both
  packages: the programs equal dict for dict, and the port's Executor
  fetches what the JAX Executor fetches (forward 1e-5, gradients 1e-4),
  double grad included.
* Every op of the port whose gradient is the generic ``vjp_grad``: the
  port's ``vjp_grad`` (recomputing its forward, and reading it from the
  tape as the Executor does) against the JAX ``vjp_grad`` on the same
  seeded inputs and cotangents (1e-5).
* The new forward ops against the JAX lowerings are in
  `tests/test_torch_static_ops.py`; the update ops, the static
  optimizers and the BERT pretraining program in
  `tests/test_torch_static_train.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu.fluid.core import registry as jregistry
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import layers, unique_name
from paddle_tpu_torch.fluid.core import block_eval
from paddle_tpu_torch.fluid.core import registry as tregistry

from test_torch_static_ops import CASES
from test_torch_static_surface import SURFACE
from test_torch_static_tensor import TENSOR
from torch_static_common import jax_state_unchanged

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


# ---------------------------------------------------------------------------
# the reference's backward cases, on both packages
# ---------------------------------------------------------------------------


def _build(pkg, layers_mod, fn, guard):
    main, startup = pkg.Program(), pkg.Program()
    with guard(), pkg.program_guard(main, startup):
        out = fn(pkg, layers_mod)
    return main, startup, out


def build_both(fn):
    """``fn(fluid, layers)`` built by each package in a fresh name space:
    ``((jax main, startup, out), (port main, startup, out))``."""
    return (_build(jfluid, jlayers, fn, jun.guard),
            _build(fluid, layers, fn, unique_name.guard))


def _names(out):
    return [v.name for v in (out if isinstance(out, (list, tuple))
                             else [out])]


def run_both(jax_built, port_built, feed, steps=1, fetch=None):
    """Run each startup program, copy the JAX values into the port's
    scope, then ``steps`` runs of each main program: ``(jax fetches,
    port fetches)`` a step, and both scopes."""
    (jmain, jstart, jout), (main, _, out) = jax_built, port_built
    fetch = fetch or _names(jout)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jres, res = [], []
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        for v in jmain.list_vars():
            if v.persistable and jscope.has(v.name):
                scope.set(v.name, torch.from_numpy(
                    np.array(jscope.find_var(v.name))))
        for _ in range(steps):
            jres.append(jexe.run(jmain, feed=feed, fetch_list=fetch))
            res.append(exe.run(main, feed=feed, fetch_list=fetch,
                               scope=scope))
    return jres, res, jscope, scope


def assert_same_program(jax_built, port_built):
    assert port_built[0].to_dict() == jax_built[0].to_dict()
    assert port_built[1].to_dict() == jax_built[1].to_dict()


def _append_backward_simple(pkg, L):
    x = L.data("x", shape=[4, 3], append_batch_size=False)
    x.stop_gradient = False
    y = L.fc(x, size=1, bias_attr=False)
    loss = L.mean(y)
    (p, g), = pkg.append_backward(loss)
    return [loss, g]


def test_append_backward_simple():
    jb, tb = build_both(_append_backward_simple)
    assert_same_program(jb, tb)
    main = tb[0]
    assert tb[2][1].name == main.all_parameters()[0].name + "@GRAD"
    backward = [o for o in main.global_block.ops[2:]]
    assert [o.type for o in backward] == ["fill_constant", "vjp_grad",
                                          "vjp_grad"]
    assert all(o.attrs["op_role"] == "backward" for o in backward)
    xv = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    (jl, jg), = run_both(jb, tb, {"x": xv})[0]
    (tl, tg), = run_both(jb, tb, {"x": xv})[1]
    np.testing.assert_allclose(tl, jl, **FWD)
    np.testing.assert_allclose(tg, jg, **GRAD)
    np.testing.assert_allclose(tg[:, 0], xv.mean(axis=0), **GRAD)


def _multi_consumer(pkg, L):
    x = L.data("x", shape=[3], append_batch_size=False)
    x.stop_gradient = False
    a = x * x
    b = x + a
    loss = L.reduce_sum(b)
    pkg.append_backward(loss, parameter_list=[])
    return [loss]


def test_grad_accumulation_multi_consumer():
    jb, tb = build_both(_multi_consumer)
    assert_same_program(jb, tb)
    types = [o.type for o in tb[0].global_block.ops]
    assert types.count("sum") == 1 and types[-1] == "assign"
    xv = np.array([1.0, 2.0, 3.0], np.float32)
    jres, res, _, _ = run_both(jb, tb, {"x": xv}, fetch=["x@GRAD"])
    np.testing.assert_allclose(res[0][0], jres[0][0], **GRAD)
    np.testing.assert_allclose(res[0][0], 1.0 + 2 * xv, rtol=1e-5)


def test_parameter_list_empty_returns_no_pairs():
    def fn(pkg, L):
        x = L.data("x", shape=[2, 3], append_batch_size=False)
        return pkg.append_backward(L.mean(L.fc(x, 2)), parameter_list=[])

    jb, tb = build_both(fn)
    assert tb[2] == [] and jb[2] == []
    assert_same_program(jb, tb)


def _sgd(pkg, L):
    x = L.data("x", shape=[8, 4], append_batch_size=False)
    label = L.data("y", shape=[8, 1], append_batch_size=False)
    pred = L.fc(x, size=1)
    loss = L.mean(L.square_error_cost(pred, label))
    pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return [loss]


def test_sgd_training_decreases_loss():
    jb, tb = build_both(_sgd)
    assert_same_program(jb, tb)
    rs = np.random.RandomState(7)
    xv = rs.randn(8, 4).astype(np.float32)
    yv = xv @ rs.randn(4, 1).astype(np.float32)
    jres, res, jscope, scope = run_both(jb, tb, {"x": xv, "y": yv},
                                        steps=30)
    losses = [float(r[0]) for r in res]
    np.testing.assert_allclose(losses, [float(r[0]) for r in jres],
                               rtol=1e-4, atol=1e-5)
    assert losses[-1] < losses[0] * 0.2, losses
    for p in tb[0].all_parameters():
        np.testing.assert_allclose(scope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   **GRAD)


def _dropout_sgd(pkg, L):
    x = L.data("x", shape=[4, 4], append_batch_size=False)
    h = L.fc(x, size=4)
    h = L.dropout(h, dropout_prob=0.5)
    loss = L.mean(h)
    pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return [loss, h]


def test_clone_for_test_strips_the_backward_and_the_optimizer():
    jb, tb = build_both(_dropout_sgd)
    assert_same_program(jb, tb)
    main = tb[0]
    test_prog = main.clone(for_test=True)
    assert test_prog.to_dict() == jb[0].clone(for_test=True).to_dict()
    types = [op.type for op in test_prog.global_block.ops]
    assert "sgd" not in types and "vjp_grad" not in types \
        and "dropout_grad" not in types
    assert all(op.attrs["is_test"] for op in test_prog.global_block.ops
               if op.type == "dropout")
    # the clone serves the forward at is_test: downgrade_in_infer
    # scales by 1 - p, with the trained weights
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(tb[1], scope=scope)
    xv = np.random.RandomState(2).randn(4, 4).astype(np.float32)
    exe.run(main, feed={"x": xv}, fetch_list=[], scope=scope)
    w, b = (scope.find_var(p.name).numpy() for p in main.all_parameters())
    h, = exe.run(test_prog, feed={"x": xv}, fetch_list=[tb[2][1]],
                 scope=scope)
    np.testing.assert_allclose(h, (xv @ w + b) * 0.5, **FWD)


def test_dropout_grad_reuses_the_forward_mask():
    """At p = 0.5 each unit's gradient is the forward's own keep mask
    (x 1 / (1 - p) upscaled): nothing is redrawn by the backward."""
    def fn(pkg, L):
        x = L.data("x", shape=[64, 32], append_batch_size=False)
        x.stop_gradient = False
        y = L.dropout(x, 0.5, dropout_implementation="upscale_in_train")
        loss = L.reduce_sum(y)
        (gx,) = pkg.gradients(loss, [x])
        return [y, gx]

    _, (main, _, (y, gx)) = build_both(fn)
    assert "dropout_grad" in [o.type for o in main.global_block.ops]
    xv = np.ones((64, 32), np.float32)
    yv, gv = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": xv}, fetch_list=[y, gx], scope=fluid.Scope())
    np.testing.assert_array_equal(gv, yv)
    assert 0.4 < (gv > 0).mean() < 0.6 and set(np.unique(gv)) == {0.0, 2.0}


def _target_gradients(pkg, L):
    x = L.data("x", shape=[3], append_batch_size=False)
    x.stop_gradient = False
    y1 = L.scale(x, scale=2.0)
    y2 = L.square(x)
    g1 = L.fill_constant([3], "float32", 3.0)
    g1.stop_gradient = True
    (gx,) = pkg.gradients([y1, y2], [x], target_gradients=[g1, None])
    return [gx]


def _double_grad(pkg, L):
    x = L.data("x", shape=[4], append_batch_size=False)
    x.stop_gradient = False
    y = L.elementwise_mul(L.square(x), x)
    (gx,) = pkg.gradients(y, [x])
    (ggx,) = pkg.gradients(gx, [x])
    return [gx, ggx]


def _double_grad_chain(pkg, L):
    x = L.data("x", shape=[5], append_batch_size=False)
    x.stop_gradient = False
    t = L.tanh(x)
    z = L.reduce_sum(L.square(t))
    (gx,) = pkg.gradients(z, [x])
    (ggx,) = pkg.gradients(gx, [x])
    return [gx, ggx]


@pytest.mark.parametrize("case,xv,want", [
    ("target_gradients", np.array([1.0, -2.0, 0.5], np.float32),
     lambda x: [6.0 + 2.0 * x]),
    ("x_cubed", np.array([1.0, -1.0, 2.0, 0.5], np.float32),
     lambda x: [3.0 * x ** 2, 6.0 * x]),
    ("through_tanh", np.linspace(-1.5, 1.5, 5).astype(np.float32),
     lambda x: [2 * np.tanh(x) / np.cosh(x) ** 2,
                2 / np.cosh(x) ** 4 - 4 * np.tanh(x) ** 2 / np.cosh(x) ** 2]),
])
def test_gradients_and_double_grad(case, xv, want):
    fn = {"target_gradients": _target_gradients, "x_cubed": _double_grad,
          "through_tanh": _double_grad_chain}[case]
    jb, tb = build_both(fn)
    assert_same_program(jb, tb)
    jres, res, _, _ = run_both(jb, tb, {"x": xv})
    for got, jgot, w in zip(res[0], jres[0], want(xv.astype(np.float64))):
        np.testing.assert_allclose(got, jgot, **GRAD)
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-5)


def test_double_grad_tapes_the_first_sweep():
    """The second sweep differentiates the first sweep's vjp_grad ops:
    those run under autograd with ``create_graph`` (recomputing their
    forward), and the rest read the tape."""
    _, (main, _, _) = build_both(_double_grad)
    ops = main.global_block.ops
    plan = block_eval.TapePlan(ops)
    taped_types = sorted(ops[i].type for i in plan.leaf_slots)
    assert taped_types.count("vjp_grad") == 2
    assert {ops[j].type for j in plan.readers} == {"vjp_grad"}
    assert all(j not in plan.leaf_slots for j in plan.readers)


def test_sparse_embedding_refuses_and_clip_refuses():
    from paddle_tpu_torch import clip

    main, start = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, start):
        ids = layers.data("ids", shape=[4, 1], dtype="int64",
                          append_batch_size=False)
        emb = layers.embedding(ids, [10, 3])
        main.global_block.ops[-1].attrs["is_sparse"] = True
        with pytest.raises(NotImplementedError, match=r"3 \(b\) 3"):
            fluid.append_backward(layers.mean(emb))
    main, start = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, start):
        x = layers.data("x", shape=[4, 3], append_batch_size=False)
        loss = layers.mean(layers.fc(x, 2))
        opt = fluid.optimizer.SGDOptimizer(
            0.1, grad_clip=clip.GradientClipByGlobalNorm(1.0))
        with pytest.raises(NotImplementedError, match=r"3 \(b\) 3"):
            opt.minimize(loss)


# ---------------------------------------------------------------------------
# vjp_grad, op by op, against the JAX vjp_grad
# ---------------------------------------------------------------------------


def grad_cases(cases):
    """The names of ``cases`` whose op differentiates a floating input."""
    out = []
    for name, (op_type, ins, attrs) in sorted(cases.items()):
        opdef = tregistry.get_op_def(op_type)
        if opdef.grad_maker is None or op_type == "dropout":
            continue
        slots = [s for s, arrs in ins.items()
                 if s not in opdef.no_grad_slots
                 and all(np.issubdtype(a.dtype, np.floating) for a in arrs)]
        if slots:
            out.append(name)
    return out


# the `fluid.layers.ops` surface's cases run in
# test_torch_static_surface_grad.py (this file's time)
GRAD_CASES = grad_cases({k: v for k, v in CASES.items() if k not in SURFACE})


def _vjp_attrs(op_type, ins, attrs, outs, slots):
    opdef = tregistry.get_op_def(op_type)
    out_slots = [s for s in opdef.output_slots if s in outs]
    present = [[np.issubdtype(o.dtype, np.floating) for o in outs[s]]
               for s in out_slots]
    return {"fwd_type": op_type, "fwd_attrs": dict(attrs),
            "fwd_in_slots": list(ins), "fwd_out_slots": out_slots,
            "fwd_out_counts": [len(outs[s]) for s in out_slots],
            "out_grad_present": present, "grad_in_slots": slots}


def test_every_auto_grad_op_has_a_grad_case():
    covered = ({CASES[c][0] for c in GRAD_CASES}
               | {SURFACE[c][0] for c in grad_cases(SURFACE)}
               | {TENSOR[c][0] for c in grad_cases(TENSOR)})
    auto = {t for t in tregistry.registered_ops()
            if tregistry.get_op_def(t).grad_maker is not None}
    # no floating input to differentiate: fill_constant; vjp_grad is the
    # op itself (double grad, above); dropout's maker is dropout_grad
    # (above)
    assert auto - covered == {"fill_constant", "vjp_grad", "dropout"}


def vjp_pair(op_type, ins, attrs, taped):
    """The port's and the JAX ``vjp_grad`` of ``op_type`` on the numpy
    inputs ``ins``, seeded cotangents for every floating output: (got,
    want), each {"DX$<slot>": [gradient, ...]}.  ``taped``: the port's
    reads its forward from a tape, as the Executor's does."""
    opdef = tregistry.get_op_def(op_type)
    slots = [s for s, arrs in ins.items()
             if s not in opdef.no_grad_slots
             and all(np.issubdtype(a.dtype, np.floating) for a in arrs)]
    jctx = jregistry.LowerContext(base_key=jax.random.PRNGKey(0))
    jins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
    outs = {k: [np.asarray(o) for o in v] for k, v in jregistry.get_op_def(
        op_type).lower(jctx, jins, attrs).items()}
    vattrs = _vjp_attrs(op_type, ins, attrs, outs, slots)
    rng = np.random.RandomState(5)
    vins = {"X$" + k: v for k, v in ins.items()}
    for s, present in zip(vattrs["fwd_out_slots"],
                          vattrs["out_grad_present"]):
        cots = [rng.standard_normal(o.shape).astype(o.dtype)
                for o, p in zip(outs[s], present) if p]
        if cots:
            vins["DO$" + s] = cots
    want = jregistry.get_op_def("vjp_grad").lower(
        jctx, {k: [jnp.asarray(a) for a in v] for k, v in vins.items()},
        vattrs)
    ctx = tregistry.LowerContext()
    tins = {k: [torch.from_numpy(a) for a in v] for k, v in vins.items()}
    with torch.no_grad():
        if taped:
            fwd_ins = {k[2:]: v for k, v in tins.items()
                       if k.startswith("X$")}
            ctx.tape_entry, _ = block_eval._run_taped(
                opdef, ctx, fwd_ins, attrs, set(slots))
        got = tregistry.get_op_def("vjp_grad").lower(ctx, tins, vattrs)
    assert sorted(got) == sorted(want) == ["DX$" + s for s in sorted(slots)]
    return got, want


def assert_vjp_grad_matches(case, op_type, ins, attrs, taped):
    got, want = vjp_pair(op_type, ins, attrs, taped)
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD,
                                       err_msg="%s %s" % (case, k))


@pytest.mark.parametrize("case", GRAD_CASES)
@pytest.mark.parametrize("taped", [False, True])
def test_vjp_grad_matches_the_jax_vjp_grad(case, taped):
    assert_vjp_grad_matches(case, *CASES[case], taped)
