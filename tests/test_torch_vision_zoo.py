"""The eager vision zoo of `paddle_tpu_torch.models` (LeNet-5, VGG,
MobileNetV1) held against `paddle_tpu.models` on the CPU.

Each JAX model's parameters (moved by seeded noise, the running
variances kept positive, so that a dropped or transposed weight shows)
go across through `from_jax_state_dict`; the same numpy images go
through both.  Checked: the ``state_dict`` keys, in order; the eval and
train forwards (logits atol 1e-5 plus rtol 1e-5: the two frameworks sum
convolutions in another order, and VGG's logits reach the hundreds); the
running statistics a train forward leaves (1e-5); one eager SGD step
(``loss.backward()``, ``minimize``) against the JAX dygraph's: loss
1e-5, every parameter and running statistic 1e-4 (as
`test_torch_optimizers.py`'s loop).  VGG trains at dropout 0 there (the
frameworks draw different masks) and serves at the reference's 0.5,
``downgrade_in_infer``: eval scales by 1 - p, checked on its own too.
MobileNetV1's 13 pointwise layers go through the 1x1 conv + BN kernels'
wrappers (`ops.conv1x1_bn_relu` in eval, `ops.conv1x1_bn_stats` in
train), their plain versions on the CPU.

The reference's ``VGG(batch_norm=False)`` passes ``bias_attr=True`` to
its convs, which its ``ParamAttr._to_attr`` refuses (a reference fault;
Paddle's takes True as a default attribute): those tests patch it to do
what Paddle's does.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch import nn

import jax

from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph, framework
from paddle_tpu.fluid import layer_helper as jax_layer_helper
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import optimizer as jax_opt
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu_torch import models, ops, optimizer
from paddle_tpu_torch.ops import nn_ops

FWD_REL = 1e-5
STEP_REL = 1e-4
LR = 0.05


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    from torch_static_common import jax_state_unchanged

    with jax_state_unchanged():
        yield


@pytest.fixture
def bias_attr_true(monkeypatch):
    """Paddle's ``ParamAttr._to_attr(True)``: a default attribute."""
    real = jax_layer_helper.ParamAttr._to_attr

    def to_attr(arg):
        return real(None if arg is True else arg)

    monkeypatch.setattr(jax_layer_helper.ParamAttr, "_to_attr",
                        staticmethod(to_attr))


@contextlib.contextmanager
def _jax(train=True, model=None):
    """Dygraph mode under a fresh name space, ``model``'s variables known
    to its tracer."""
    with jun.guard(), dygraph.guard():
        framework._dygraph_tracer.train_mode = train
        if model is not None:
            model.train() if train else model.eval()
            for vb in model.state_dict().values():
                framework._dygraph_tracer.register_var(vb)
        yield


# name -> (JAX builder, port builder, image shape)
ZOO = {
    "lenet5": (lambda **kw: jax_models.LeNet5(),
               lambda **kw: models.LeNet5(device="cpu"), (4, 1, 28, 28)),
    "vgg11_bn": (lambda **kw: jax_models.VGG(11, 10, batch_norm=True, **kw),
                 lambda **kw: models.VGG(11, 10, batch_norm=True,
                                         device="cpu", **kw),
                 (2, 3, 32, 32)),
    "vgg11": (lambda **kw: jax_models.VGG(11, 10, batch_norm=False, **kw),
              lambda **kw: models.VGG(11, 10, batch_norm=False, device="cpu",
                                      **kw), (2, 3, 32, 32)),
    "mobilenet_v1_0.25": (
        lambda **kw: jax_models.MobileNetV1(num_classes=10, scale=0.25),
        lambda **kw: models.MobileNetV1(num_classes=10, scale=0.25,
                                        device="cpu"), (8, 3, 96, 96)),
}


def _pair(name, **kw):
    """(JAX model, port model, JAX-layout params), the same weights."""
    mk_j, mk_t, _ = ZOO[name]
    with _jax():
        np.random.seed(0)
        jm = mk_j(**kw)
        rng = np.random.default_rng(1)
        params = {}
        for k, v in jm.state_dict().items():
            a = np.asarray(v.numpy())
            noise = 0.05 * rng.standard_normal(a.shape).astype(np.float32)
            params[k] = a + (np.abs(noise) if k.endswith("_variance")
                             else noise)
            v.data = jax.numpy.asarray(params[k])
    tm = mk_t(**kw)
    tm.load_state_dict(models.from_jax_state_dict(params))
    return jm, tm, params


def _images(name, seed=0):
    return np.random.RandomState(seed).standard_normal(
        ZOO[name][2]).astype(np.float32)


def _labels(name, seed=1):
    return np.random.RandomState(seed).randint(
        0, 10, (ZOO[name][2][0], 1)).astype(np.int64)


def _jax_forward(jm, x, train):
    with _jax(train, jm):
        out = np.asarray(jm(dygraph.to_variable(x)).numpy())
        state = {k: np.asarray(v.numpy())
                 for k, v in jm.state_dict().items()}
    return out, state


def _linear_weights(tm):
    return {n + ".weight" for n, m in tm.named_modules()
            if isinstance(m, nn.Linear)}


def _assert_close(got, want, what, tol=1e-5):
    """Within ``tol`` of the tensor's scale (max |want|) and of each
    value."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _assert_state(tm, want, tol, what):
    linear = _linear_weights(tm)
    for k, v in tm.state_dict().items():
        w = want[k].T if k in linear else want[k]
        _assert_close(v.numpy(), w, "%s %s" % (what, k), tol)


# MobileNetV1's train mode has a test of its own below (`MB_FWD`): the
# reference's own f32 train logits stand 5e-5 of their scale from float64
FORWARDS = [(n, t) for n in sorted(ZOO) for t in (False, True)
            if not (n.startswith("mobilenet") and t)]


@pytest.mark.parametrize("name,train", FORWARDS)
def test_forward_matches_jax(name, train, bias_attr_true):
    kw = {"dropout": 0.0} if name.startswith("vgg") and train else {}
    jm, tm, _ = _pair(name, **kw)
    x = _images(name)
    want, jstate = _jax_forward(jm, x, train)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (x.shape[0], 10)
    _assert_close(got.numpy(), want, "logits")
    # a train forward moves the running statistics, as the reference's
    _assert_state(tm, jstate, FWD_REL, "after the forward")


@pytest.mark.parametrize("name", sorted(ZOO))
def test_state_dict_keys_are_the_references_in_order(name, bias_attr_true):
    jm, tm, params = _pair(name)
    assert list(tm.state_dict()) == list(params)
    bn = [k for k in params if k.endswith("._mean")]
    assert len(bn) == {"lenet5": 0, "vgg11": 0, "vgg11_bn": 8,
                       "mobilenet_v1_0.25": 27}[name]


def _jax_sgd_step(jm, x, lab):
    """(loss, state after one SGD step) of the JAX dygraph model."""
    with _jax(True, jm):
        loss = jlayers.reduce_mean(jlayers.softmax_with_cross_entropy(
            jm(dygraph.to_variable(x)), dygraph.to_variable(lab)))
        loss.backward()
        jax_opt.SGDOptimizer(LR).minimize(loss,
                                          parameter_list=jm.parameters())
        return float(np.asarray(loss.numpy())), {
            k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_sgd_step(tm, x, lab):
    """(loss, state after one eager SGD step) of a port model (any
    float dtype), the reference's recipe."""
    tm.train()
    w = next(tm.parameters())
    loss = nn_ops.softmax_with_cross_entropy(
        tm(torch.from_numpy(x).to(w.dtype)), torch.from_numpy(lab)).mean()
    loss.backward()
    optimizer.SGDOptimizer(LR).minimize(loss,
                                        parameter_list=list(tm.parameters()))
    return loss.item(), {k: v.detach().numpy()
                         for k, v in tm.state_dict().items()}


@pytest.mark.parametrize("name", [n for n in sorted(ZOO)
                                  if not n.startswith("mobilenet")])
def test_one_sgd_step_matches_the_jax_dygraph(name, bias_attr_true):
    kw = {"dropout": 0.0} if name.startswith("vgg") else {}
    jm, tm, params = _pair(name, **kw)
    x, lab = _images(name, 2), _labels(name)
    want_loss, want = _jax_sgd_step(jm, x, lab)
    loss, _ = _port_sgd_step(tm, x, lab)
    np.testing.assert_allclose(loss, want_loss, rtol=FWD_REL)
    _assert_state(tm, want, STEP_REL, "after the step")
    moved = max(np.abs(want[k] - params[k]).max() for k in params)
    assert moved > 1e-3


def _stats64(x2d, w2d):
    """Kernel 11's function in float64 (its plain version rounds the
    product to f32)."""
    acc = x2d.double() @ w2d.double().t()
    var, mean = torch.var_mean(acc, dim=0, unbiased=False)
    return acc, mean, var


# MobileNetV1 in train mode: 27 BatchNorms over batch statistics in a
# row amplify each layer's rounding.  Readings at this size on the CPU:
# the f32 logits stand from float64 1.3e-5 (port) and 5.0e-5 (JAX) of
# their scale, the port from JAX 4.8e-5; after one SGD step each tensor
# stands, in 2-norm over its move, from float64 at most 1.6e-3 (port)
# and 1.2e-2 (JAX), the port from JAX 1.2e-2.
MB_FWD = 2e-4       # of the logits' scale
MB_STEP = 3e-2      # of a tensor's move, 2-norms


def _rel_to_moves(got, want, base):
    """Per key: ||got - want|| / ||want - base||, the Linear weights of
    JAX-layout dicts transposed."""
    out = {}
    for k, b in base.items():
        g = got[k].T if got[k].shape != b.shape else got[k]
        w = want[k].T if want[k].shape != b.shape else want[k]
        out[k] = np.linalg.norm(g - w) / np.linalg.norm(w - b)
    return out


def test_mobilenet_train_forward_and_step_match_jax_and_float64(
        monkeypatch):
    """MobileNetV1's train forward (logits and running statistics) and one
    SGD step, f32, held to the JAX run (f32) and both to the port's
    float64 run: the logits within `MB_FWD` of their scale, each
    parameter and running statistic within `MB_STEP` of its move (2-norm
    over 2-norm).  The float64 run checks the reference as much as the
    port: a fault on the port's train path (the batch statistics, the
    running update, the grouped conv's backward, the kernels' 2-D views)
    moves both port runs away from JAX."""
    name = "mobilenet_v1_0.25"
    x, lab = _images(name, 2), _labels(name)
    jm, tm, params = _pair(name)
    want_fwd, jax_fwd_state = _jax_forward(jm, x, True)
    jm, _, _ = _pair(name)
    jax_loss, jax_state = _jax_sgd_step(jm, x, lab)
    with torch.no_grad():
        got_fwd = tm.train()(torch.from_numpy(x)).numpy()
    fwd_state = {k: v.numpy() for k, v in tm.state_dict().items()}
    tm.load_state_dict(models.from_jax_state_dict(params))
    loss, state = _port_sgd_step(tm, x, lab)
    t64 = ZOO[name][1]()
    t64.load_state_dict(models.from_jax_state_dict(params))
    t64.double()
    monkeypatch.setattr(ops, "conv1x1_bn_stats", _stats64)
    with torch.no_grad():
        fwd64 = t64.train()(torch.from_numpy(x).double()).numpy()
    t64.load_state_dict(models.from_jax_state_dict(params))
    loss64, state64 = _port_sgd_step(t64, x, lab)

    scale = np.abs(fwd64).max()
    for what, a, b in (("port from JAX", got_fwd, want_fwd),
                       ("port from float64", got_fwd, fwd64),
                       ("JAX from float64", want_fwd, fwd64)):
        d = np.abs(a - b).max() / scale
        assert d <= MB_FWD, ("train logits, %s: %.3g" % (what, d))
    np.testing.assert_allclose(loss, jax_loss, rtol=FWD_REL)
    np.testing.assert_allclose(loss, loss64, rtol=FWD_REL)
    np.testing.assert_allclose(jax_loss, loss64, rtol=FWD_REL)
    stats = {k: v for k, v in params.items() if k.endswith(("_mean",
                                                            "_variance"))}
    assert len(stats) == 54
    fwd_d = _rel_to_moves(fwd_state, jax_fwd_state, stats)
    worst = max(fwd_d, key=fwd_d.get)
    assert fwd_d[worst] <= MB_STEP, ("running statistics after the "
                                     "forward", worst, fwd_d[worst])
    state64 = {k: np.asarray(v) for k, v in state64.items()}
    for what, a, b in (("port from JAX", state, jax_state),
                       ("port from float64", state, state64),
                       ("JAX from float64", jax_state, state64)):
        d = _rel_to_moves(a, b, params)
        worst = max(d, key=d.get)
        assert d[worst] <= MB_STEP, ("after the step, %s" % what, worst,
                                     d[worst])


def test_vgg_eval_is_downgrade_in_infer(bias_attr_true):
    """The reference's ``Dropout(0.5)`` left at its default: eval scales
    the fc activations by 1 - p (the VGG at 0.5 equals the one at 0 with
    each fc1 / fc2 output halved: relu commutes with a positive scale),
    train keeps the kept values unscaled."""
    _, tm, params = _pair("vgg11_bn")
    _, t0, _ = _pair("vgg11_bn", dropout=0.0)
    x = torch.from_numpy(_images("vgg11_bn"))
    tm.eval()
    t0.eval()
    with torch.no_grad():
        got = tm(x)
        for fc in (t0.fc1, t0.fc2):      # halve fc1's and fc2's outputs
            fc.weight.mul_(0.5)
            fc.bias.mul_(0.5)
        want = t0(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    drop = models.bert.Dropout(0.25)
    assert drop.dropout_implementation == "downgrade_in_infer"
    v = torch.arange(1.0, 4001.0)
    drop.eval()
    torch.testing.assert_close(drop(v), v * 0.75)
    drop.train()
    y = drop(v)
    kept = y != 0
    assert torch.equal(y[kept], v[kept]) and 0.15 < 1 - kept.float().mean()
    assert 1 - kept.float().mean() < 0.35
    with pytest.raises(ValueError, match="dropout_implementation"):
        models.bert.Dropout(0.5, "upscale")


@pytest.mark.parametrize("train", [False, True])
def test_mobilenet_pointwise_layers_go_through_the_conv_bn_kernels(
        train, monkeypatch):
    """Eval: 13 calls of kernel 10's wrapper (each pointwise conv + BN +
    relu); train: 13 of kernel 11's; none of the other; the depthwise
    convs are grouped (groups = channels)."""
    calls = {"conv1x1_bn_relu": [], "conv1x1_bn_stats": []}
    for fn in calls:
        real = getattr(ops, fn)

        def rec(*a, real=real, fn=fn):
            calls[fn].append(tuple(a[0].shape) + (a[1].shape[0],))
            return real(*a)
        monkeypatch.setattr(ops, fn, rec)
    tm = models.MobileNetV1(num_classes=10, scale=0.25, device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(
        models.init_mobilenet_params(10, 0.25, seed=2, bn_stats="random")))
    tm.train(train)
    tm(torch.from_numpy(_images("mobilenet_v1_0.25")))
    used = "conv1x1_bn_stats" if train else "conv1x1_bn_relu"
    assert len(calls[used]) == 13
    assert not calls["conv1x1_bn_relu" if train else "conv1x1_bn_stats"]
    # K from 8 (the first pointwise layer at scale 0.25) to 256
    b, _, h, w = ZOO["mobilenet_v1_0.25"][2]
    assert calls[used][0] == (b * h // 2 * w // 2, 8, 16)
    assert calls[used][-1] == (b * h // 32 * w // 32, 256, 256)
    dw = [m for n, m in tm.named_modules() if n.endswith(".dw")]
    assert len(dw) == 13 and all(
        m.conv_layer.weight.shape[1] == 1 for m in dw)


def test_init_mobilenet_params_has_the_jax_keys_and_laws():
    _, _, params = _pair("mobilenet_v1_0.25")
    got = models.init_mobilenet_params(10, 0.25, seed=3)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in params.items()}
    assert list(got) == list(params)
    big = models.init_mobilenet_params(1000, 1.0, seed=3)
    w = big["blocks.12.pw.conv.weight"]          # [1024, 1024, 1, 1]
    assert abs(w.std() - np.sqrt(2.0 / 1024)) < 0.05 * np.sqrt(2.0 / 1024)
    dw = big["blocks.0.dw.conv.weight"]          # [32, 1, 3, 3]: fan_in 9
    assert dw.shape == (32, 1, 3, 3)
    assert abs(dw.std() - np.sqrt(2.0 / 9)) < 0.15 * np.sqrt(2.0 / 9)
    limit = np.sqrt(6.0 / (1024 + 1000))
    assert big["head.weight"].shape == (1024, 1000)
    assert np.abs(big["head.weight"]).max() <= limit
    assert (big["blocks.3.pw.bn._variance"] == 1).all()
    again = models.init_mobilenet_params(1000, 1.0, seed=3)
    assert all(np.array_equal(big[k], again[k]) for k in big)


def test_mobilenet_trunk_runs_channels_last_and_trains_in_bf16():
    """The trunk turns any input channels-last once; one Momentum(0.1,
    0.9) step under `ShardedTrainStep(amp="bf16")` is finite and moves
    the running statistics."""
    from paddle_tpu_torch import distributed

    tm = models.MobileNetV1(num_classes=10, scale=0.25, device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(
        models.init_mobilenet_params(10, 0.25, seed=4)))
    x = torch.from_numpy(_images("mobilenet_v1_0.25"))
    tm.eval()
    with torch.no_grad():
        a = tm(x)
        b = tm(x.contiguous(memory_format=torch.channels_last))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    tm.train()

    def loss_fn(m, batch):
        return nn_ops.softmax_with_cross_entropy(
            m(batch["image"]), batch["label"]).mean()

    step = distributed.ShardedTrainStep(
        tm, optimizer.MomentumOptimizer(0.1, 0.9), loss_fn, amp="bf16")
    state = step.init()
    before = {k: v.clone() for k, v in state["buffers"].items()}
    state, loss = step(state, {"image": _images("mobilenet_v1_0.25"),
                               "label": _labels("mobilenet_v1_0.25")})
    assert np.isfinite(loss.item())
    assert max((state["buffers"][k] - before[k]).abs().max().item()
               for k in before) > 0
