"""The 1x1 conv + BN + relu of `paddle_tpu_torch` (`ops.conv1x1_bn_relu`,
`ops.fold_bn`) held against the JAX package on the CPU, on the same
numpy inputs made from a seed.

* The port's plain version (the wrapper on CPU tensors) against the
  experiment's Pallas kernel (`benchmarks/fused_conv_bn_relu_experiment.py`
  `pallas_fused`) in TPU interpret mode.  The module is imported from its
  file and its shape globals ``M, K, N, BM, BN, BK`` are set for a small
  multi-tile grid; its w is ``[K, N]``, the port's ``[N, K]``.
* `fold_bn` against the JAX BatchNorm's ``is_test`` output, and the
  kernel's function against the JAX ResNet's eval 1x1
  `ConvBNLayer(act="relu")`, the layer it carries in the model.

Tolerances: f32 1e-5 (atol and rtol; the sums run in another order and
the BN is folded into one affine); bf16 2e-2, the repo's bf16 policy
(both sides round the f32 value once; a sum that lands on a rounding
boundary differs by one bf16 ulp).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.fluid import dygraph
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu_torch import ops

EXPERIMENT = (Path(__file__).resolve().parents[1] / "benchmarks"
              / "fused_conv_bn_relu_experiment.py")
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
EPS = 1e-5


@pytest.fixture(scope="module")
def experiment():
    spec = importlib.util.spec_from_file_location("fused_conv_bn_relu_exp",
                                                  EXPERIMENT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(seed, m, k, n):
    """x [M, K], w [N, K] (the port's layout), BN gamma, beta, mean and
    a positive var [N], f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * np.sqrt(2.0 / k)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, n).astype(np.float32)
    beta = (rng.standard_normal(n) * 0.1).astype(np.float32)
    mean = (rng.standard_normal(n) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x, w, gamma, beta, mean, var


def _fold(gamma, beta, mean, var):
    return ops.fold_bn(*(torch.from_numpy(a) for a in (gamma, beta, mean,
                                                       var)), EPS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (256, 128, 256, 128, 128, 64),
    (384, 64, 128, 128, 128, 64),
])
def test_plain_version_matches_the_pallas_kernel(experiment, monkeypatch,
                                                 m, k, n, bm, bn, bk, dtype):
    for name, val in zip(("M", "K", "N", "BM", "BN", "BK"),
                         (m, k, n, bm, bn, bk)):
        monkeypatch.setattr(experiment, name, val)
    x, w, gamma, beta, mean, var = _operands(m + k + n, m, k, n)
    scale, shift = _fold(gamma, beta, mean, var)
    jdt = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = experiment.pallas_fused(
            jnp.asarray(x, jdt), jnp.asarray(w.T, jdt),
            jnp.asarray(scale.numpy()[None]),
            jnp.asarray(shift.numpy()[None]))
    tdt = getattr(torch, dtype)
    before = ops.conv1x1_bn_relu.launches
    got = ops.conv1x1_bn_relu(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(w).to(tdt), scale, shift)
    assert ops.conv1x1_bn_relu.launches == before   # CPU: no launch
    assert got.dtype == tdt and got.shape == (m, n)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
        **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_plain_version_rounds_once():
    x, w, gamma, beta, mean, var = _operands(1, 40, 16, 24)
    scale, shift = _fold(gamma, beta, mean, var)
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    got = ops.conv1x1_bn_relu(xb, wb, scale, shift)
    acc = xb.float() @ wb.float().t()
    want = torch.relu(acc * scale + shift).to(torch.bfloat16)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _jax_bn_eval(x_nhwc, gamma, beta, mean, var, act=None):
    """The JAX dygraph BatchNorm in eval mode (the `is_test` branch)."""
    with dygraph.guard():
        bn = dygraph.BatchNorm(x_nhwc.shape[-1], act=act, data_layout="NHWC")
        bn.set_state_dict({"weight": gamma, "bias": beta, "_mean": mean,
                           "_variance": var})
        bn.eval()
        return np.asarray(bn(dygraph.to_variable(x_nhwc)).numpy())


def test_fold_bn_matches_the_jax_batch_norm_is_test():
    rng = np.random.default_rng(2)
    _, _, gamma, beta, mean, var = _operands(2, 1, 1, 48)
    x = rng.standard_normal((2, 5, 5, 48)).astype(np.float32)
    want = _jax_bn_eval(x, gamma, beta, mean, var)
    scale, shift = _fold(gamma, beta, mean, var)
    assert scale.dtype == torch.float32 and shift.dtype == torch.float32
    got = torch.from_numpy(x) * scale + shift
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_kernel_function_is_the_jax_eval_1x1_conv_bn_relu_layer():
    """`conv1x1_bn_relu` over the channels-last rows and the folded BN
    is the JAX ResNet's eval ConvBNLayer(k=1, act="relu")."""
    b, h, w_sp, cin, cout = 2, 6, 5, 32, 48
    _, w, gamma, beta, mean, var = _operands(3, 1, cin, cout)
    x = np.random.default_rng(4).standard_normal(
        (b, h, w_sp, cin)).astype(np.float32)
    with dygraph.guard():
        layer = jax_resnet.ConvBNLayer(cin, cout, 1, act="relu",
                                       data_format="NHWC")
        layer.set_state_dict({
            "_conv.weight": w[:, :, None, None], "_bn.weight": gamma,
            "_bn.bias": beta, "_bn._mean": mean, "_bn._variance": var})
        layer.eval()
        want = np.asarray(layer(dygraph.to_variable(x)).numpy())
    scale, shift = _fold(gamma, beta, mean, var)
    got = ops.conv1x1_bn_relu(torch.from_numpy(x).view(-1, cin),
                              torch.from_numpy(w), scale, shift)
    np.testing.assert_allclose(got.view(b, h, w_sp, cout).numpy(), want,
                               **F32_TOL)


@pytest.mark.parametrize("case,match", [
    ("rank", "2-D kernel"),
    ("k", "disagree in K"),
    ("scale_shape", r"scale must be \[N=24\]"),
    ("scale_dtype", "shift must be float32"),
    ("dtype", "float32 or bfloat16"),
    ("mixed", "w is torch.bfloat16"),
    ("strided", "x must be contiguous"),
    ("bf16_k", "multiples of 8"),
])
def test_argument_checks(case, match):
    x, w, gamma, beta, mean, var = _operands(5, 16, 16, 24)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    scale, shift = _fold(gamma, beta, mean, var)
    if case == "rank":
        xt = xt.view(2, 8, 16)
    elif case == "k":
        wt = wt[:, :8].contiguous()
    elif case == "scale_shape":
        scale = scale[:5]
    elif case == "scale_dtype":
        shift = shift.to(torch.bfloat16)
    elif case == "dtype":
        xt, wt = xt.half(), wt.half()
    elif case == "mixed":
        wt = wt.to(torch.bfloat16)
    elif case == "strided":
        xt = torch.from_numpy(np.ascontiguousarray(x.T)).t()
    else:
        xt = xt[:, :12].contiguous().to(torch.bfloat16)
        wt = wt[:, :12].contiguous().to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError), match=match):
        ops.conv1x1_bn_relu(xt, wt, scale, shift)


def test_wrapper_is_registered_with_a_launch_count():
    assert ops.KERNEL_WRAPPERS["conv_bn_relu"] is ops.conv1x1_bn_relu
    ops.conv1x1_bn_relu.launches = 5
    ops.reset_launch_counts()
    assert ops.launch_counts()["conv_bn_relu"] == 0
