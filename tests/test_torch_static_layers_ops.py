"""`paddle_tpu_torch.fluid.layers.ops` (every public function of the
reference's `paddle_tpu/fluid/layers/ops.py`), `layers.concat` and
`layers.embedding` held against `paddle_tpu.fluid` on the CPU.

* Gradients at kinks: the port's ``vjp_grad`` equals JAX's (1e-7) on
  inputs placed exactly at each kink (abs at 0, relu6 at 0 and at its
  threshold, clip and hard_sigmoid on their bounds, leaky_relu and
  prelu at 0, elementwise max / min and reduce_max / min at ties),
  where the obvious torch call differs (``torch.abs`` passes 0 at 0,
  ``torch.clamp`` all of a bound's gradient where JAX passes half).
  The seeded inputs of `tests/test_torch_static_ops.py` never land on
  a kink.
* Each layer function builds, in a fresh name space, the program the
  JAX layer builds, main and startup, dict for dict.
* ``embedding`` has the reference's signature; ``is_sparse=True`` is
  recorded and raises at backward, ``is_distributed=True`` raises.
* The weights of ``prelu`` (its Alpha), a shared embedding table and
  ``instance_norm``'s scale and bias reach the port through the JAX
  package's saved-model directory and serve JAX's outputs (1e-5).
"""

import inspect

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid.layers import ops as jops
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import layers, unique_name

from test_torch_static_backward import build_both, vjp_pair
from torch_static_common import jax_save, jax_state_unchanged

FWD = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


def _f(*vals):
    return np.array(vals, np.float32)


# ---------------------------------------------------------------------------
# gradients at kinks
# ---------------------------------------------------------------------------

# (op type, inputs on the kinks, attrs, the obvious torch form or None)
KINKS = {
    "abs-at-0": ("abs", {"X": [_f(0.0, -1.0, 1.0, 0.0)]}, {},
                 lambda x, a: torch.abs(x)),
    "relu6-at-0-and-threshold": (
        "relu6", {"X": [_f(0.0, 2.0, -1.0, 1.0, 3.0)]}, {"threshold": 2.0},
        lambda x, a: torch.clamp(x, 0.0, a["threshold"])),
    "clip-on-both-bounds": (
        "clip", {"X": [_f(-0.5, 0.75, 0.0, 1.0, -1.0)]},
        {"min": -0.5, "max": 0.75},
        lambda x, a: torch.clamp(x, a["min"], a["max"])),
    "hard_sigmoid-on-both-bounds": (
        "hard_sigmoid", {"X": [_f(-1.0, 1.0, 0.0, 2.0, -2.0)]},
        {"slope": 0.5, "offset": 0.5},
        lambda x, a: torch.clamp(x * a["slope"] + a["offset"], 0.0, 1.0)),
    "leaky_relu-at-0": ("leaky_relu", {"X": [_f(0.0, 1.0, -1.0)]},
                        {"alpha": 0.1}, None),
    "prelu-at-0": ("prelu", {"X": [_f(0.0, 1.0, -1.0, 0.0).reshape(1, 4)],
                             "Alpha": [_f(0.25)]}, {"mode": "all"}, None),
    "relu-at-0": ("relu", {"X": [_f(0.0, 1.0, -1.0)]}, {}, None),
    "elementwise_max-ties": ("elementwise_max",
                             {"X": [_f(1.0, 2.0, -1.0, 0.0)],
                              "Y": [_f(1.0, 0.0, -1.0, 0.0)]},
                             {"axis": -1}, None),
    "elementwise_min-ties": ("elementwise_min",
                             {"X": [_f(1.0, 2.0, -1.0, 0.0)],
                              "Y": [_f(1.0, 0.0, -1.0, 0.0)]},
                             {"axis": -1}, None),
    "reduce_max-ties": ("reduce_max",
                        {"X": [_f(1.0, 1.0, 0.0, 2.0, -1.0, 2.0)
                               .reshape(2, 3)]},
                        {"dim": [1], "keep_dim": False}, None),
    "reduce_min-ties": ("reduce_min",
                        {"X": [_f(0.0, 1.0, 0.0, -1.0, 2.0, -1.0)
                               .reshape(2, 3)]},
                        {"dim": [1], "keep_dim": False}, None),
}


@pytest.mark.parametrize("case", sorted(KINKS))
@pytest.mark.parametrize("taped", [False, True])
def test_gradient_at_kink_equals_jax(case, taped):
    op_type, ins, attrs, obvious = KINKS[case]
    got, want = vjp_pair(op_type, ins, attrs, taped)
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7,
                                       atol=1e-7, err_msg="%s %s" % (case, k))
    if obvious is not None:
        # the torch call a port would reach for disagrees at the kink
        x = torch.from_numpy(ins["X"][0]).requires_grad_()
        cot = torch.from_numpy(np.random.RandomState(5).standard_normal(
            x.shape).astype(np.float32))
        g, = torch.autograd.grad(obvious(x, attrs), x, cot)
        assert not np.allclose(g.numpy(), np.asarray(want["DX$X"][0]),
                               rtol=1e-3, atol=1e-3), case


# ---------------------------------------------------------------------------
# every layers.ops function (and concat), dict for dict
# ---------------------------------------------------------------------------

def _public(module):
    return sorted(n for n, v in vars(module).items()
                  if callable(v) and not n.startswith("_")
                  and getattr(v, "__module__", None) == module.__name__)


REFERENCE_OPS = _public(jops)


class _In:
    """The data vars the layer builders read, declared in one order."""

    def __init__(self, L):
        def d(name, shape, dtype="float32"):
            return L.data(name, shape=shape, dtype=dtype,
                          append_batch_size=False)

        self.x = d("x", [3, 4])
        self.x2 = d("x2", [3, 4])
        self.y = d("y", [4])
        self.w = d("w", [5, 4])
        self.w2 = d("w2", [4, 5])
        self.w3 = d("w3", [5, 2])
        self.m = d("m", [3, 3])
        self.b = d("b", [3, 2])
        self.c = d("c", [2, 3])
        self.c2 = d("c2", [2, 3])
        self.col = d("col", [3, 1])
        self.img = d("img", [2, 3, 4, 4])
        self.img8 = d("img8", [2, 8, 3, 3])
        self.ch = d("ch", [3])
        self.grid = d("grid", [2, 2, 3, 2])
        self.theta = d("theta", [2, 2, 3])
        self.prior = d("prior", [1, 4])


_UNARY_BUILD = {n: (lambda n: lambda L, v: getattr(L, n)(v.x))(n)
                for n in jops._UNARY}

BUILD = dict(_UNARY_BUILD, **{
    "leaky_relu": lambda L, v: L.leaky_relu(v.x, alpha=0.1),
    "elu": lambda L, v: L.elu(v.x, alpha=0.5),
    "gelu": lambda L, v: L.gelu(v.x, approximate=True),
    "hard_sigmoid": lambda L, v: L.hard_sigmoid(v.x, slope=0.3, offset=0.4),
    "swish": lambda L, v: L.swish(v.x, beta=2.0),
    "relu6": lambda L, v: L.relu6(v.x, threshold=4.0),
    "pow": lambda L, v: L.pow(v.x, factor=2.0),
    "prelu": lambda L, v: [L.prelu(v.img, mode) for mode in
                           ("all", "channel", "element")],
    "scale": lambda L, v: L.scale(v.x, scale=2.0, bias=1.0,
                                  bias_after_scale=False, act="relu"),
    "clip": lambda L, v: L.clip(v.x, -1.0, 1.0),
    "elementwise_add": lambda L, v: L.elementwise_add(v.x, v.y, act="relu"),
    "elementwise_sub": lambda L, v: L.elementwise_sub(v.x, v.x2),
    "elementwise_mul": lambda L, v: L.elementwise_mul(v.x, v.y, axis=1),
    "elementwise_div": lambda L, v: L.elementwise_div(v.x, v.x2),
    "elementwise_pow": lambda L, v: L.elementwise_pow(v.x, v.y),
    "elementwise_max": lambda L, v: L.elementwise_max(v.x, v.y, act="tanh"),
    "elementwise_min": lambda L, v: L.elementwise_min(v.x, v.x2),
    "elementwise_mod": lambda L, v: L.elementwise_mod(v.x, v.y),
    "reduce_sum": lambda L, v: L.reduce_sum(v.x, dim=1, keep_dim=True),
    "reduce_mean": lambda L, v: L.reduce_mean(v.x),
    "reduce_max": lambda L, v: [L.reduce_max(v.x, dim=[0, 1]),
                                L.reduce_max(v.x)],
    "reduce_min": lambda L, v: L.reduce_min(v.x, dim=-1, keep_dim=True),
    "reduce_prod": lambda L, v: L.reduce_prod(v.x, dim=0),
    "mean": lambda L, v: L.mean(v.x),
    "sum": lambda L, v: L.sum([v.x, v.x2]),
    "sums": lambda L, v: L.sums([v.x, v.x2, v.x]),
    "sqrt_": lambda L, v: L.sqrt_(v.x),
    "softmax": lambda L, v: L.softmax(v.x, axis=0),
    "log_softmax": lambda L, v: L.log_softmax(v.x, axis=1),
    "matmul": lambda L, v: L.matmul(v.x, v.w, transpose_y=True, alpha=0.5),
    "mul": lambda L, v: L.mul(v.x, v.w2),
    "dot": lambda L, v: L.dot(v.x, v.x2),
    "topk": lambda L, v: L.topk(v.x, 2),
    "cumsum": lambda L, v: [L.cumsum(v.x, axis=1, exclusive=True,
                                     reverse=True), L.cumsum(v.x)],
    "kron": lambda L, v: L.kron(v.x, v.c),
    "einsum": lambda L, v: L.einsum("ij,jk->ik", v.x, v.w2),
    "cholesky": lambda L, v: L.cholesky(v.m, upper=True),
    "inverse": lambda L, v: L.inverse(v.m),
    "matrix_power": lambda L, v: L.matrix_power(v.m, 3),
    "triangular_solve": lambda L, v: L.triangular_solve(
        v.m, v.b, upper=False, transpose=True, unitriangular=True),
    "cross": lambda L, v: [L.cross(v.c, v.c2, axis=1), L.cross(v.c, v.c2)],
    "multi_dot": lambda L, v: L.multi_dot([v.x, v.w2, v.w3]),
    "roll": lambda L, v: [L.roll(v.x, 1, axis=0), L.roll(v.x, [2])],
    "flip": lambda L, v: L.flip(v.x, 1),
    "broadcast_to": lambda L, v: L.broadcast_to(v.col, [2, 3, 4]),
    "logsumexp": lambda L, v: [L.logsumexp(v.x, axis=[0, 1], keepdim=True),
                               L.logsumexp(v.x)],
    "instance_norm": lambda L, v: [L.instance_norm(v.img, v.ch, v.ch,
                                                   epsilon=1e-3),
                                   L.instance_norm(v.img)],
    "grid_sampler": lambda L, v: L.grid_sampler(v.img, v.grid,
                                                align_corners=False),
    "affine_grid": lambda L, v: L.affine_grid(v.theta, [2, 3, 4, 5]),
    "pixel_shuffle": lambda L, v: L.pixel_shuffle(v.img8, 2),
    "kldiv_loss": lambda L, v: [L.kldiv_loss(v.x, v.x2, r) for r in
                                ("mean", "sum", "batchmean", "none")],
    "label_smooth": lambda L, v: [L.label_smooth(v.x, epsilon=0.2),
                                  L.label_smooth(v.x, v.prior)],
    "cos_sim": lambda L, v: L.cos_sim(v.x, v.x2),
    "concat": lambda L, v: [L.concat([v.x, v.x2, v.x], axis=1),
                            L.concat([v.c, v.c2])],
})


def test_the_port_exports_every_reference_layer_op():
    missing = [n for n in REFERENCE_OPS + ["concat"]
               if not callable(getattr(layers, n, None))]
    assert not missing
    assert sorted(set(REFERENCE_OPS) | {"concat"}) == sorted(BUILD)
    for n in REFERENCE_OPS:
        assert (inspect.signature(getattr(layers.ops, n))
                == inspect.signature(getattr(jops, n))), n
        assert getattr(layers, n) is getattr(layers.ops, n), n


@pytest.mark.parametrize("name", sorted(BUILD))
def test_layer_builds_the_jax_program(name):
    (jmain, jstart, _), (main, start, _) = build_both(
        lambda pkg, L: BUILD[name](L, _In(L)))
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()


# ---------------------------------------------------------------------------
# embedding's signature
# ---------------------------------------------------------------------------

def test_embedding_signature_is_the_reference_one():
    assert (inspect.signature(layers.embedding)
            == inspect.signature(jlayers.embedding))

    def fn(pkg, L):
        ids = L.data("ids", shape=[1], dtype="int64")
        return [L.embedding(ids, [10, 3], False, False, 2),   # positional
                L.embedding(ids, [10, 3], is_sparse=True, padding_idx=-1,
                            param_attr=pkg.ParamAttr(name="t"))]

    (jmain, jstart, _), (main, start, outs) = build_both(fn)
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()
    ops = main.global_block.ops
    assert [o.attrs for o in ops] == [{"padding_idx": 2, "is_sparse": False},
                                      {"padding_idx": 9, "is_sparse": True}]


def test_sparse_embedding_raises_at_backward_and_distributed_raises():
    main, start = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, start):
        ids = layers.data("ids", shape=[1], dtype="int64")
        dense = layers.embedding(ids, [10, 3])
        fluid.gradients(layers.mean(dense), [])          # dense: fine
        sparse = layers.embedding(ids, [10, 3], is_sparse=True)
        with pytest.raises(NotImplementedError, match=r"3 \(b\) 3"):
            fluid.append_backward(layers.mean(sparse))
        with pytest.raises(NotImplementedError, match="Queue A 5"):
            layers.embedding(ids, [10, 3], is_distributed=True)


# ---------------------------------------------------------------------------
# new parameters carried across
# ---------------------------------------------------------------------------

def _carried(pkg, L):
    from_layer_helper = pkg.layer_helper.LayerHelper("instance_norm")
    img = L.data("img", shape=[3, 4, 4])
    ids = L.data("ids", shape=[1], dtype="int64")
    ids2 = L.data("ids2", shape=[1], dtype="int64")
    act = L.prelu(img, "channel")
    act = L.prelu(act, "element")
    scale = from_layer_helper.create_parameter(
        None, [3], dtype="float32",
        default_initializer=pkg.initializer.ConstantInitializer(1.0))
    bias = from_layer_helper.create_parameter(None, [3], dtype="float32",
                                              is_bias=True)
    normed = L.instance_norm(act, scale, bias)
    table = pkg.ParamAttr(name="shared_w")
    e = L.concat([L.embedding(i, [7, 16], param_attr=table)
                  for i in (ids, ids2)], axis=1)
    return [L.reduce_sum(normed, dim=[2, 3]), e]


def test_new_parameters_carry_from_the_jax_saved_model(tmp_path):
    (jmain, jstart, jouts), (main, start, _) = build_both(_carried)
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()
    params = {p.name: p.shape for p in main.all_parameters()}
    assert len(params) == 5 and params["shared_w"] == (7, 16)
    feeds = ["img", "ids", "ids2"]
    d = str(tmp_path / "model")
    saved = jax_save(d, jmain, jstart, feeds, jouts, perturb=0.1, seed=2)
    rng = np.random.RandomState(3)
    feed = {"img": rng.standard_normal((2, 3, 4, 4)).astype(np.float32),
            "ids": rng.randint(0, 7, (2, 1)).astype(np.int64),
            "ids2": rng.randint(0, 7, (2, 1)).astype(np.int64)}
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jprog, jnames, jfetch = jfluid.io.load_inference_model(d, jexe)
        want = jexe.run(jprog, feed=feed, fetch_list=jfetch)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        prog, names, fetch = fluid.io.load_inference_model(d, exe)
    assert names == jnames == feeds
    for n, v in saved.items():
        np.testing.assert_array_equal(scope.find_var(n).numpy(), v)
    got = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **FWD)
