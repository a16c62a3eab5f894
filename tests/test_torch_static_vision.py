"""The vision slice of `paddle_tpu_torch.fluid` held against
`paddle_tpu.fluid` on the CPU, beyond the per-op cases of
`tests/test_torch_static_ops.py` (which hold each new op's forward at
1e-5 of JAX's lowering, and `tests/test_torch_static_backward.py` its
``vjp_grad``, the max pools on tie-free inputs):

* ``batch_norm`` in training over an NHWC input whose first sample
  lies far from the batch mean: within 1e-5 of the output's scale of
  JAX's, and no further than JAX's from a float64 batch norm;
* its ``vjp_grad`` in NHWC training (recomputed and taped): each input
  gradient within 1e-4 of its scale of JAX's;
* the running statistics a training step leaves (NCHW, NHWC, 2-D) in
  the scope, in place, and the ``clone(for_test=True)`` program that
  reads them;
* ``batch_norm_act_fuse``'s output (``fused_batch_norm_act``) runs, in
  training and in test, as the unfused program and as JAX's;
* ``fc`` over several inputs, and the vision layers, dict for dict the
  JAX programs, their fetches within 1e-5;
* the readers and datasets bitwise JAX's for the same seeds.
"""

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import ir as jir
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu.fluid.core import registry as jregistry
import paddle_tpu_torch as ptt
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import ir, layers, unique_name
from paddle_tpu_torch.fluid.core import registry as tregistry

from torch_static_common import jax_state_unchanged

FWD = dict(rtol=1e-5, atol=1e-5)
SCALE_REL = 1e-5
GRAD_SCALE_REL = 1e-4


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


def _r(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def build_both(fn):
    out = []
    for pkg, L, guard in ((jfluid, jlayers, jun.guard),
                          (fluid, layers, unique_name.guard)):
        main, startup = pkg.Program(), pkg.Program()
        with guard(), pkg.program_guard(main, startup):
            res = fn(pkg, L)
        out.append((main, startup, res))
    return out


def init_both(jmain, jstart, main, seed=0):
    """JAX's startup run, every parameter perturbed (running variances
    by |noise|), the values copied into a port scope."""
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    rng = np.random.RandomState(seed)
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    for v in jmain.list_vars():
        if v.persistable and not v.is_data and jscope.has(v.name):
            a = np.asarray(jscope.find_var(v.name))
            if isinstance(v, jfluid.Parameter):
                noise = 0.1 * rng.standard_normal(a.shape)
                if not v.trainable and a.mean() == 1:
                    noise = np.abs(noise)
                a = (a + noise).astype(a.dtype)
            jscope.set(v.name, a)
            scope.set(v.name, torch.from_numpy(a.copy()))
    return jexe, jscope, exe, scope


def run_both(built, feed, fetch, steps=1):
    (jmain, jstart, _), (main, _, _) = built
    jexe, jscope, exe, scope = init_both(jmain, jstart, main)
    for _ in range(steps):
        with jfluid.scope_guard(jscope):
            want = jexe.run(jmain, feed=feed, fetch_list=fetch)
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    return want, got, jscope, scope


# ---------------------------------------------------------------------------
# batch_norm
# ---------------------------------------------------------------------------

def test_batch_norm_train_nhwc_far_shift_within_scale_and_float64():
    """The one-pass statistics reduce about the first sample; here it
    lies ~2 std from some channels' means, and JAX's f32 reduction over
    the non-minor axes drifts 1.6e-6 from float64 in 1/std where the
    port's stays at 2.6e-7, so the outputs are held at 1e-5 of their
    scale (elementwise near zero they differ by ~5e-6)."""
    ins = {"X": [_r(3, 4, 5, 6)], "Scale": [_r(6, seed=1)],
           "Bias": [_r(6, seed=2)], "Mean": [_r(6, seed=3)],
           "Variance": [np.abs(_r(6, seed=4)) + 0.5]}
    attrs = {"momentum": 0.8, "epsilon": 1e-3, "data_layout": "NHWC"}
    import jax
    import jax.numpy as jnp

    jctx = jregistry.LowerContext(base_key=jax.random.PRNGKey(0))
    want = jregistry.get_op_def("batch_norm").lower(
        jctx, {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        attrs)
    with torch.no_grad():
        got = tregistry.get_op_def("batch_norm").lower(
            tregistry.LowerContext(),
            {k: [torch.from_numpy(a) for a in v] for k, v in ins.items()},
            attrs)
    for slot in want:
        w, g = np.asarray(want[slot][0]), got[slot][0].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rel(g, w) <= SCALE_REL, (slot, _rel(g, w))
    x = ins["X"][0].astype(np.float64)
    m, v = x.mean(axis=(0, 1, 2)), x.var(axis=(0, 1, 2))
    for slot, exact in (("SavedMean", m),
                        ("SavedVariance", 1 / np.sqrt(v + 1e-3))):
        assert np.abs(got[slot][0].numpy() - exact).max() <= \
            np.abs(np.asarray(want[slot][0]) - exact).max()


BN_NHWC_TRAIN = {
    "far-shift": ({"X": [_r(3, 4, 5, 6)], "Scale": [_r(6, seed=1)],
                   "Bias": [_r(6, seed=2)], "Mean": [_r(6, seed=3)],
                   "Variance": [np.abs(_r(6, seed=4)) + 0.5]},
                  {"momentum": 0.8, "epsilon": 1e-3, "data_layout": "NHWC"}),
    "shifted": ({"X": [2 * _r(4, 5, 5, 3) + 3], "Scale": [_r(3, seed=1)],
                 "Bias": [_r(3, seed=2)], "Mean": [_r(3, seed=3)],
                 "Variance": [np.abs(_r(3, seed=4)) + 0.5]},
                {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
                 "data_layout": "NHWC"}),
}


@pytest.mark.parametrize("taped", [False, True])
@pytest.mark.parametrize("case", sorted(BN_NHWC_TRAIN))
def test_batch_norm_train_nhwc_vjp_grad_within_scale(case, taped):
    """The NHWC training ``batch_norm``'s ``vjp_grad`` (recomputing its
    forward, and reading it from the tape) against JAX's on the same
    seeded cotangents: each input gradient within 1e-4 of its scale,
    as JAX's statistics drift in f32 (above)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu_torch.fluid.core import block_eval
    from test_torch_static_backward import _vjp_attrs

    ins, attrs = BN_NHWC_TRAIN[case]
    slots = ["X", "Scale", "Bias"]
    jctx = jregistry.LowerContext(base_key=jax.random.PRNGKey(0))
    outs = {k: [np.asarray(o) for o in v]
            for k, v in jregistry.get_op_def("batch_norm").lower(
                jctx, {k: [jnp.asarray(a) for a in v]
                       for k, v in ins.items()}, attrs).items()}
    vattrs = _vjp_attrs("batch_norm", ins, attrs, outs, slots)
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
    opdef = tregistry.get_op_def("batch_norm")
    ctx = tregistry.LowerContext()
    tins = {k: [torch.from_numpy(a) for a in v] for k, v in vins.items()}
    with torch.no_grad():
        if taped:
            ctx.tape_entry, _ = block_eval._run_taped(
                opdef, ctx, {k: [torch.from_numpy(a) for a in v]
                             for k, v in ins.items()}, attrs, set(slots))
        got = tregistry.get_op_def("vjp_grad").lower(ctx, tins, vattrs)
    assert sorted(got) == sorted(want) == ["DX$" + s for s in sorted(slots)]
    for k in want:
        g, w = got[k][0].numpy(), np.asarray(want[k][0])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert _rel(g, w) <= GRAD_SCALE_REL, (k, _rel(g, w))


def _bn_net(layout, shape):
    def fn(pkg, L):
        x = L.data("x", shape=shape)
        y = L.batch_norm(L.scale(x, 2.0, 1.0), act="relu",
                         data_layout=layout, momentum=0.8)
        loss = L.mean(y)
        test = pkg.default_main_program().clone(for_test=True)
        pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
        return loss, y, test
    return fn


@pytest.mark.parametrize("layout,shape", [("NCHW", [3, 4, 5]),
                                          ("NHWC", [4, 5, 3]),
                                          ("NCHW", [6])])
def test_running_statistics_after_a_step_in_place(layout, shape):
    built = build_both(_bn_net(layout, shape))
    (jmain, jstart, (jloss, jy, jtest)), (main, _, (loss, y, test)) = built
    assert main.to_dict() == jmain.to_dict()
    assert test.to_dict() == jtest.to_dict()
    assert [o.attrs["is_test"] for o in test.global_block.ops
            if o.type == "batch_norm"] == [True]
    stats = [p.name for p in main.all_parameters() if not p.trainable]
    assert len(stats) == 2
    feed = {"x": _r(*([4] + shape))}
    jexe, jscope, exe, scope = init_both(jmain, jstart, main)
    held = {n: scope.find_var(n) for n in stats}
    start = {n: t.clone() for n, t in held.items()}
    for _ in range(2):
        with jfluid.scope_guard(jscope):
            jl, = jexe.run(jmain, feed=feed, fetch_list=[jloss])
        tl, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        np.testing.assert_allclose(tl, jl, **FWD)
    for n in stats:
        assert scope.find_var(n) is held[n]        # written in place
        assert not torch.equal(held[n], start[n])
        assert _rel(held[n].numpy(), np.asarray(jscope.find_var(n))) \
            <= SCALE_REL
    with jfluid.scope_guard(jscope):
        jt, = jexe.run(jtest, feed=feed, fetch_list=[jy])
    t, = exe.run(test, feed=feed, fetch_list=[y], scope=scope)
    np.testing.assert_allclose(t, jt, **FWD)
    for n in stats:          # a test run leaves the statistics alone
        assert torch.equal(scope.find_var(n), held[n])


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh"])
def test_batch_norm_act_fuse_output_runs(act):
    def fn(pkg, L):
        x = L.data("x", shape=[3, 6, 6])
        h = L.conv2d(x, num_filters=4, filter_size=3, padding=1)
        y = L.batch_norm(h, act=act)
        return L.pool2d(y, pool_size=2, pool_stride=2, pool_type="avg")

    built = build_both(fn)
    (jmain, jstart, jout), (main, _, out) = built
    feed = {"x": _r(2, 3, 6, 6)}
    jexe, jscope, exe, scope = init_both(jmain, jstart, main)
    for for_test in (False, True):
        jp = jmain.clone(for_test=for_test)
        tp = main.clone(for_test=for_test)
        plain, = exe.run(tp, feed=feed, fetch_list=[out],
                         scope=_copy(scope))
        jir.apply_passes(jp, ["batch_norm_act_fuse"])
        ir.apply_passes(tp, ["batch_norm_act_fuse"])
        assert tp.to_dict() == jp.to_dict()
        assert [o.type for o in tp.global_block.ops].count(
            "fused_batch_norm_act") == 1
        assert act not in [o.type for o in tp.global_block.ops]
        fused, = exe.run(tp, feed=feed, fetch_list=[out], scope=scope)
        with jfluid.scope_guard(jscope):
            want, = jexe.run(jp, feed=feed, fetch_list=[jout])
        np.testing.assert_allclose(fused, plain, **FWD)
        np.testing.assert_allclose(fused, want, **FWD)
        for p in main.all_parameters():   # the same running statistics
            np.testing.assert_allclose(
                scope.find_var(p.name).numpy(),
                np.asarray(jscope.find_var(p.name)), **FWD)


def _copy(scope):
    out = fluid.Scope()
    for n in scope.local_names():
        out.set(n, scope.find_var(n).clone())
    return out


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _fc_several(pkg, L):
    a = L.data("a", shape=[3, 4])
    b = L.data("b", shape=[5])
    h = L.fc([L.reshape(a, [-1, 12]), b], size=6, act="tanh")
    out = L.fc([h, b, h], size=2, num_flatten_dims=1)
    loss = L.mean(L.square(out))
    pkg.optimizer.SGDOptimizer(0.5).minimize(loss)
    return loss, out


def test_fc_over_several_inputs():
    built = build_both(_fc_several)
    (jmain, _, (jloss, jout)), (main, _, (loss, out)) = built
    assert main.to_dict() == jmain.to_dict()
    types = [o.type for o in main.global_block.ops]
    assert types.count("mul") == 5 and types.count("sum") >= 2
    feed = {"a": _r(4, 3, 4), "b": _r(4, 5, seed=1)}
    params = [p.name for p in main.all_parameters()]
    fetch = [loss.name, out.name] + [p + "@GRAD" for p in params]
    want, got, jscope, scope = run_both(built, feed, fetch, steps=2)
    for f, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=f)
    for p in params:
        assert _rel(scope.find_var(p).numpy(),
                    np.asarray(jscope.find_var(p))) <= 1e-4


def _vision_layers(pkg, L):
    x = L.data("x", shape=[4, 9, 9])
    label = L.data("label", shape=[1], dtype="int64")
    c = L.conv2d(x, num_filters=6, filter_size=3, stride=2, padding=1,
                 groups=2, act="relu")
    d = L.conv2d(x, num_filters=3, filter_size=[3, 2], dilation=2,
                 bias_attr=False, act="sigmoid")
    p = L.pool2d(c, pool_size=3, pool_type="avg", pool_stride=2,
                 pool_padding=1)
    g = L.pool2d(d, pool_type="max", global_pooling=True)
    bn = L.batch_norm(p, act="tanh")
    logits = L.fc([bn, g], size=5)
    prob = L.softmax(logits)
    top, idx = L.topk(prob, k=2)
    acc = L.accuracy(prob, label, k=2)
    ce = L.cross_entropy(prob, label)
    soft = L.cross_entropy(prob, L.softmax(L.sigmoid(logits)),
                           soft_label=True)
    loss = L.mean(ce) + L.mean(soft)
    pkg.optimizer.AdamOptimizer(1e-2).minimize(loss)
    return [loss, acc, top, idx, ce, soft]


def test_vision_layers_build_and_train_as_jax():
    built = build_both(_vision_layers)
    (jmain, jstart, jouts), (main, start, outs) = built
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()
    idx = main.global_block.var(outs[3].name)
    assert idx.dtype == "int32" and idx.shape == (-1, 2)   # as recorded
    rng = np.random.RandomState(4)
    feed = {"x": _r(3, 4, 9, 9),
            "label": rng.randint(0, 5, (3, 1)).astype(np.int64)}
    fetch = [o.name for o in outs]
    want, got, jscope, scope = run_both(built, feed, fetch, steps=2)
    for f, g, w in zip(fetch, got, want):
        if g.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=f)
    assert got[3].dtype == np.int64      # top_k's indices run int64
    for p in main.all_parameters():
        assert _rel(scope.find_var(p.name).numpy(),
                    np.asarray(jscope.find_var(p.name))) <= 1e-4, p.name


# ---------------------------------------------------------------------------
# readers and datasets
# ---------------------------------------------------------------------------

def _examples(reader):
    return [tuple(np.asarray(f) for f in ex) for ex in reader()]


def _same(a, b):
    assert len(a) == len(b) and len(a) > 0
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for fa, fb in zip(map(np.asarray, ea), map(np.asarray, eb)):
            assert fa.dtype == fb.dtype
            np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("module,split", [
    ("uci_housing", "train"), ("uci_housing", "test"), ("mnist", "train"),
    ("mnist", "test"), ("cifar", "train10"), ("cifar", "test10")])
def test_datasets_are_jax_bitwise(module, split):
    want = getattr(getattr(paddle_tpu.dataset, module), split)
    got = getattr(getattr(ptt.dataset, module), split)
    _same(_examples(got()), _examples(want()))


def test_readers_are_jax_bitwise():
    src = (ptt.dataset.mnist.train(40), paddle_tpu.dataset.mnist.train(40))
    for make in (
            lambda r, m: m.batch(m.shuffle(r, buf_size=16, seed=3), 7),
            lambda r, m: m.batch(r, 6, drop_last=True),
            lambda r, m: m.chain(r, m.map_readers(
                lambda a, b: (a[0] - b[0], a[1] + b[1]), r, r))):
        got = make(src[0], ptt.reader)
        want = make(src[1], paddle_tpu.reader)
        a, b = list(got()), list(want())
        assert len(a) == len(b)
        for ba, bb in zip(a, b):
            if isinstance(ba, list):
                fa = ptt.reader.to_feed(ba, ["img", "label"])
                fb = paddle_tpu.reader.to_feed(bb, ["img", "label"])
                for k in fb:
                    assert fa[k].dtype == fb[k].dtype
                    np.testing.assert_array_equal(fa[k], fb[k])
            else:
                _same([ba], [bb])
    assert ptt.batch is ptt.reader.batch
