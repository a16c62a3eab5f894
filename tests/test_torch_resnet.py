"""`paddle_tpu_torch.models` ResNet (eval) held against
`paddle_tpu.models` on the CPU.

ResNet-50 and ResNet-18 at 10 classes, with seeded weights and seeded
non-trivial BatchNorm statistics (`init_resnet_params(bn_stats=
"random")`), are loaded into both packages (the port's through
`from_jax_state_dict`), and the same numpy images, 2x3x32x32 f32, go
through both in eval mode.

Tolerance (f32): the logits agree within 1e-5 of their scale (atol 1e-5
x max |logit|, rtol 1e-5).  The two frameworks sum each conv in another
order and the port folds every BatchNorm into one affine, so each layer
adds f32 rounding differences of ~1e-7 of its scale; over 53 conv + BN
layers the logits measured 1.1e-6 (ResNet-50) and 9e-7 (ResNet-18) of
their scale.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph
from paddle_tpu_torch import models, ops

REL = 1e-5
N_CLASSES = 10


def _images(seed=0, b=2, hw=32):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, hw, hw)).astype(np.float32)


def _jax_model(depth, fmt="NHWC", params=None):
    net = jax_models.ResNet(depth, num_classes=N_CLASSES, data_format=fmt)
    if params is not None:
        net.set_state_dict(params)
    return net.eval()


def _port_model(depth, params, fmt="NHWC", dtype=torch.float32):
    m = models.ResNet(depth, N_CLASSES, data_format=fmt, device="cpu",
                      dtype=dtype)
    m.load_state_dict(models.from_jax_state_dict(params))
    return m.eval()


@pytest.fixture(scope="module")
def params():
    return {d: models.init_resnet_params(d, N_CLASSES, seed=d,
                                         bn_stats="random")
            for d in (50, 18)}


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
@pytest.mark.parametrize("depth", [50, 18])
def test_eval_logits_match_jax(params, depth, fmt):
    x = _images()
    with dygraph.guard():
        want = np.asarray(_jax_model(depth, fmt, params[depth])(
            dygraph.to_variable(x)).numpy())
    with torch.no_grad():
        got = _port_model(depth, params[depth], fmt)(
            torch.from_numpy(x)).numpy()
    assert got.shape == (2, N_CLASSES)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=REL * scale, rtol=REL)


def test_every_key_lands_transposed_exactly_where_it_is_fc_weight():
    """All 267 keys of the JAX ResNet-50's state_dict land in the port's,
    each as it is but ``fc.weight`` ([in, out] -> [out, in])."""
    with dygraph.guard():
        jax_sd = {k: np.asarray(v.numpy())
                  for k, v in _jax_model(50).state_dict().items()}
    assert len(jax_sd) == 267
    assert {"stem._conv.weight", "blocks.0.conv0._bn._mean",
            "blocks.0.short._bn._variance", "fc.weight",
            "fc.bias"} <= set(jax_sd)
    port = models.resnet50(num_classes=N_CLASSES, device="cpu")
    port.load_state_dict(models.from_jax_state_dict(jax_sd))
    got = port.state_dict()
    assert set(got) == set(jax_sd)
    for key, want in jax_sd.items():
        want = want.T if key == "fc.weight" else want
        np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)


@pytest.mark.parametrize("depth", [50, 18])
def test_init_resnet_params_loads_into_both_packages(depth):
    p = models.init_resnet_params(depth, N_CLASSES, seed=1)
    with dygraph.guard():
        jax_sd = _jax_model(depth).state_dict()
        assert set(p) == set(jax_sd)
        assert all(p[k].shape == tuple(v.shape) for k, v in jax_sd.items())
        _jax_model(depth, params=p)
    port = models.ResNet(depth, N_CLASSES, device="cpu")
    port.load_state_dict(models.from_jax_state_dict(p))   # strict
    bn = port.blocks[0].conv0._bn
    assert torch.equal(bn._variance, torch.ones_like(bn._variance))
    with pytest.raises(ValueError, match="bn_stats"):
        models.init_resnet_params(depth, N_CLASSES, bn_stats="zero")


def test_bottleneck_conv0_goes_through_the_kernel_wrapper(params,
                                                          monkeypatch):
    """One `ops.conv1x1_bn_relu` call per bottleneck block (16 in
    ResNet-50), on views of the channels-last trunk that pass the
    kernel's contiguity and dtype checks; none in ResNet-18."""
    calls = []
    real = ops.conv1x1_bn_relu

    def counting(x2d, w2d, scale, shift):
        calls.append((tuple(x2d.shape), tuple(w2d.shape)))
        return real(x2d, w2d, scale, shift)

    monkeypatch.setattr(ops, "conv1x1_bn_relu", counting)
    x = torch.from_numpy(_images(hw=64))
    with torch.no_grad():
        _port_model(50, params[50])(x)
        assert len(calls) == 16
        assert calls[0] == ((2 * 16 * 16, 64), (64, 64))
        assert calls[-1] == ((2 * 2 * 2, 2048), (512, 2048))
        calls.clear()
        _port_model(18, params[18])(x)
    assert calls == []


def test_bf16_keeps_batch_norm_in_f32_and_follows_the_f32_logits(params):
    """dtype=bf16: conv and fc weights bf16, BatchNorm's four vectors f32
    buffers; the logits stand within 5e-2 of the f32 model's in relative
    norm (the repo's bf16 policy)."""
    x = torch.from_numpy(_images(seed=3))
    m16 = _port_model(50, params[50], dtype=torch.bfloat16)
    bn = m16.blocks[3].conv0._bn
    assert {t.dtype for t in (bn.weight, bn.bias, bn._mean, bn._variance)} \
        == {torch.float32}
    assert m16.blocks[3].conv0._conv.weight.dtype == torch.bfloat16
    with torch.no_grad():
        lo = m16(x)
        hi = _port_model(50, params[50])(x)
    assert lo.dtype == torch.bfloat16
    rel = ((lo.float() - hi).norm() / hi.norm()).item()
    assert rel < 5e-2, rel


def test_train_mode_forward_raises(params):
    m = _port_model(18, params[18]).train()
    with pytest.raises(NotImplementedError, match="training slice"):
        m(torch.from_numpy(_images()))


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="data_format"):
        models.ResNet(50, data_format="CHWN", device="cpu")
    with pytest.raises(ValueError, match="depth"):
        models.ResNet(42, device="cpu")


def test_model_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.resnet18(num_classes=N_CLASSES)
    m = models.resnet18(num_classes=N_CLASSES, device="cpu")
    assert all(t.device.type == "cpu"
               for t in list(m.parameters()) + list(m.buffers()))
