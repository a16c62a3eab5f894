"""The 1x1 conv + BN-statistics op of `paddle_tpu_torch`
(`ops.conv1x1_bn_stats`), train-mode BatchNorm (`nn_ops.batch_norm_train`)
and the eval op's gradients (`ops.conv1x1_bn_relu` under autograd), held
against the JAX package on the CPU, on the same numpy inputs made from a
seed.

* The plain version (the wrapper on CPU tensors) against the
  experiment's Pallas kernel (`benchmarks/fused_conv_bn_relu_experiment.py`
  `pallas_mm_stats`), imported from its file with its shape globals
  ``M, K, N, BM, BN, BK`` set for a small grid: under
  `pltpu.force_tpu_interpret_mode()` at one row tile (M = BM; with more
  the TPU interpreter refuses the revisited statistics block), and under
  the generic interpreter (``pl.pallas_call`` given ``interpret=True``)
  at three row tiles, which carries Σy and Σy² across them.  The
  kernel's Σy and Σy² are held against ``M·mean`` and ``M·(var + mean²)``
  of the port's statistics.
* The statistics where |mean| ≈ 90·std, against float64 numpy and the
  JAX BatchNorm op's own batch statistics (`_bn_train_fused`).
* The op's autograd, through `batch_norm_train` on its statistics,
  against `jax.vjp` of ``x @ w`` followed by `_bn_train_fused`.
* `batch_norm_train` from x against `_bn_train_fused` and its VJP
  (`_bn_train_b`), and its running-statistic update against the JAX
  dygraph `BatchNorm`'s train forward.
* `conv1x1_bn_relu`'s backward against autograd of its plain
  composition, through `fold_bn` to γ and β.

Tolerances: f32 1e-5 (rtol, and atol against the output's scale: the
sums run in another order); a BatchNorm output from x, whose channel 0
rides on an offset of 300, atol 1e-5 + 1e-6 max|x| (``x k + c`` rounds
at x's scale: ulp(300) = 3e-5); f32 gradients 1e-4 of their scale (the
repo's cross-framework gradient policy); Σy against 1e-5 of Σ|y| (Σy
itself cancels); bf16 2e-2 forward and 5e-2 gradients, the repo's bf16
policy (the frameworks round bf16 at different places); the port's
statistics against float64 1e-6 of (|mean| + std) and of var.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.fluid import dygraph
from paddle_tpu.fluid.ops import nn_ops as jax_nn_ops
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import nn_ops

EXPERIMENT = (Path(__file__).resolve().parents[1] / "benchmarks"
              / "fused_conv_bn_relu_experiment.py")
EPS = 1e-5
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
GRAD_REL = 1e-4
BF16_GRAD_REL = 5e-2


@pytest.fixture(scope="module")
def experiment():
    spec = importlib.util.spec_from_file_location("fused_conv_bn_stats_exp",
                                                  EXPERIMENT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(seed, m, k, n):
    """x [M, K] and w [N, K] (the port's layout), f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * np.sqrt(2.0 / k)).astype(np.float32)
    return x, w


def _close_rel(got, want, rel, name=""):
    """Within ``rel`` of the reference's largest magnitude, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=rel,
                               err_msg=name)


def _set_shape(monkeypatch, experiment, m, k, n, bm=128, bn=128, bk=64):
    for name, val in zip(("M", "K", "N", "BM", "BN", "BK"),
                         (m, k, n, bm, bn, bk)):
        monkeypatch.setattr(experiment, name, val)


def _against_pallas(experiment, m, k, n, dtype, seed):
    x, w = _operands(seed, m, k, n)
    jdt = jnp.dtype(dtype)
    want_y, s1, s2 = experiment.pallas_mm_stats(jnp.asarray(x, jdt),
                                                jnp.asarray(w.T, jdt))
    tdt = getattr(torch, dtype)
    before = ops.conv1x1_bn_stats.launches
    y, mean, var = ops.conv1x1_bn_stats(torch.from_numpy(x).to(tdt),
                                        torch.from_numpy(w).to(tdt))
    assert ops.conv1x1_bn_stats.launches == before   # CPU: no launch
    assert y.dtype == tdt and y.shape == (m, n)
    assert mean.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(
        y.float().numpy(), np.asarray(jnp.asarray(want_y, jnp.float32)),
        **(F32_TOL if dtype == "float32" else BF16_TOL))
    acc = (torch.from_numpy(x).to(tdt).double()
           @ torch.from_numpy(w).to(tdt).double().t()).numpy()
    mean, var = mean.double().numpy(), var.double().numpy()
    np.testing.assert_allclose(np.asarray(s1)[0], m * mean, rtol=1e-5,
                               atol=1e-5 * np.abs(acc).sum(0).max())
    np.testing.assert_allclose(np.asarray(s2)[0], m * (var + mean ** 2),
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_pallas_kernel_in_tpu_interpret_mode(
        experiment, monkeypatch, dtype):
    """One row tile (M = BM), two column tiles, two K steps."""
    _set_shape(monkeypatch, experiment, 128, 128, 256)
    with pltpu.force_tpu_interpret_mode():
        _against_pallas(experiment, 128, 128, 256, dtype, seed=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_carried_sums_over_row_tiles(
        experiment, monkeypatch, dtype):
    """Three row tiles (M = 3·BM) under the generic interpreter, so Σy
    and Σy² are carried across row tiles as on the TPU."""
    monkeypatch.setattr(experiment.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    _set_shape(monkeypatch, experiment, 384, 64, 256)
    _against_pallas(experiment, 384, 64, 256, dtype, seed=2)


def _cancelling_operands(m=4096, k=64, n=16, seed=3):
    """Column 0 of y = x w has mean 128 and std ~1.4 (|mean| ≈ 90 std):
    x's column 0 is 1, w[0, 0] is 128."""
    x, w = _operands(seed, m, k, n)
    x[:, 0] = 1.0
    w[0, 0] = 128.0
    return x, w


def test_statistics_do_not_cancel_when_the_mean_dwarfs_the_std():
    x, w = _cancelling_operands()
    _, mean, var = ops.conv1x1_bn_stats(torch.from_numpy(x),
                                        torch.from_numpy(w))
    acc = (torch.from_numpy(x) @ torch.from_numpy(w).t()).double().numpy()
    want_mean, want_var = acc.mean(0), acc.var(0)
    assert want_mean[0] / np.sqrt(want_var[0]) > 80
    np.testing.assert_allclose(mean.numpy(), want_mean,
                               atol=1e-6 * (np.abs(want_mean)
                                            + np.sqrt(want_var)).max())
    np.testing.assert_allclose(var.numpy(), want_var, rtol=1e-6)
    # the one-pass f32 form the experiment's caller uses is far off here
    acc32 = acc.astype(np.float32)
    naive = (acc32 * acc32).mean(0) - acc32.mean(0) ** 2
    assert abs(naive[0] - want_var[0]) > 100 * abs(var[0].item()
                                                   - want_var[0])
    # the JAX BatchNorm op's batch statistics of the same f32 product
    _, m, rstd = jax_nn_ops._bn_train_fused(
        jnp.asarray(acc32), jnp.ones(16), jnp.zeros(16), 1, EPS)
    np.testing.assert_allclose(mean.numpy(), np.asarray(m), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(),
                               1.0 / np.square(np.asarray(rstd)) - EPS,
                               rtol=1e-4)


def _bn_vectors(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.5, n).astype(np.float32),
            (rng.standard_normal(n) * 0.1).astype(np.float32))


def test_autograd_through_batch_norm_matches_jax_vjp():
    """`conv1x1_bn_stats` + `batch_norm_train` on its statistics, over a
    channels-last image's rows, against ``jax.vjp`` of ``x @ w`` then
    `_bn_train_fused`: the output and dx, dw, dγ, dβ (f32)."""
    b, h, w_sp, cin, cout = 2, 6, 5, 32, 48
    x, w = _operands(4, b * h * w_sp, cin, cout)
    gamma, beta = _bn_vectors(5, cout)
    dy = np.random.default_rng(6).standard_normal(
        (b * h * w_sp, cout)).astype(np.float32)

    def jax_fn(x, w, g, bt):
        return jax_nn_ops._bn_train_fused(x @ w.T, g, bt, 1, EPS)[0]

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (x, w, gamma,
                                                            beta)))
    want_grads = vjp(jnp.asarray(dy))

    tx, tw, tg, tb = (torch.from_numpy(a).requires_grad_()
                      for a in (x, w, gamma, beta))
    img = tx.view(b, h, w_sp, cin).permute(0, 3, 1, 2)   # channels-last
    y2d, mean, var = ops.conv1x1_bn_stats(
        img.permute(0, 2, 3, 1).reshape(-1, cin), tw)
    y4 = y2d.view(b, h, w_sp, cout).permute(0, 3, 1, 2)
    out, mean_out, var_out = nn_ops.batch_norm_train(
        y4, tg, tb, torch.zeros(cout), torch.ones(cout),
        batch_stats=(mean, var))
    out2d = out.permute(0, 2, 3, 1).reshape(-1, cout)
    grads = torch.autograd.grad(out2d, (tx, tw, tg, tb),
                                torch.from_numpy(dy))
    _close_rel(out2d.detach().numpy(), np.asarray(want), 1e-5, "y")
    for name, got, ref in zip(("dx", "dw", "dgamma", "dbeta"), grads,
                              want_grads):
        _close_rel(got.numpy(), np.asarray(ref), GRAD_REL, name)
    assert not mean_out.requires_grad and not var_out.requires_grad


def _jax_bn(x, gamma, beta, dy):
    y, vjp = jax.vjp(lambda a, g, b: jax_nn_ops._bn_train_fused(
        a, g, b, 1, EPS)[0], jnp.asarray(x), jnp.asarray(gamma),
        jnp.asarray(beta))
    return np.asarray(jnp.asarray(y, jnp.float32)), [
        np.asarray(jnp.asarray(g, jnp.float32)) for g in vjp(jnp.asarray(dy))]


def _bn_out_tol(x):
    """f32 BatchNorm output limit for input x (see the module docstring)."""
    return dict(rtol=1e-5, atol=1e-5 + 1e-6 * float(np.abs(x).max()))


def _image(seed, b=4, c=24, hw=5, offset=True):
    """NCHW f32 activations; channel 0 rides on an offset of 300 (std 1),
    so statistics without the shift would cancel."""
    x = np.random.default_rng(seed).standard_normal(
        (b, c, hw, hw)).astype(np.float32)
    if offset:
        x[:, 0] += 300.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_from_x_matches_the_jax_op_and_its_vjp(dtype):
    x = _image(7)
    c = x.shape[1]
    gamma, beta = _bn_vectors(8, c)
    dy = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want, want_grads = _jax_bn(jnp.asarray(x, jdt), gamma, beta,
                               jnp.asarray(dy, jdt))
    tx = torch.from_numpy(x).to(tdt).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    tg, tb = (torch.from_numpy(a).requires_grad_() for a in (gamma, beta))
    out, _, _ = nn_ops.batch_norm_train(tx, tg, tb, torch.zeros(c),
                                        torch.ones(c))
    assert out.dtype == tdt
    grads = torch.autograd.grad(out, (tx, tg, tb),
                                torch.from_numpy(dy).to(tdt))
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), want,
                                   **_bn_out_tol(x))
        rel = GRAD_REL
    else:
        np.testing.assert_allclose(out.detach().float().numpy(), want,
                                   **BF16_TOL)
        rel = BF16_GRAD_REL
    for name, got, ref in zip(("dx", "dgamma", "dbeta"), grads, want_grads):
        _close_rel(got.float().numpy(), ref, rel, name)


def test_running_statistics_follow_the_jax_batch_norm_train_forward():
    """One train forward: MeanOut = 0.9 mean + 0.1 batch mean, and the
    same of the *biased* batch variance, as the JAX dygraph BatchNorm
    writes back; and the normalized output."""
    x = _image(10)
    c = x.shape[1]
    gamma, beta = _bn_vectors(11, c)
    rng = np.random.default_rng(12)
    mean0 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    with dygraph.guard():
        bn = dygraph.BatchNorm(c, data_layout="NCHW")
        bn.set_state_dict({"weight": gamma, "bias": beta, "_mean": mean0,
                           "_variance": var0})
        bn.train()
        want = np.asarray(bn(dygraph.to_variable(x)).numpy())
        want_mean = np.asarray(bn._mean.numpy())
        want_var = np.asarray(bn._variance.numpy())
    out, mean_out, var_out = nn_ops.batch_norm_train(
        torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
        torch.from_numpy(mean0), torch.from_numpy(var0))
    np.testing.assert_allclose(out.numpy(), want, **_bn_out_tol(x))
    np.testing.assert_allclose(mean_out.numpy(), want_mean, **F32_TOL)
    np.testing.assert_allclose(var_out.numpy(), want_var, **F32_TOL)
    biased = x.astype(np.float64).var(axis=(0, 2, 3))
    np.testing.assert_allclose(var_out.numpy(), 0.9 * var0 + 0.1 * biased,
                               rtol=1e-5)


def test_batch_norm_train_on_given_statistics_equals_it_from_x():
    """The two inputs of `batch_norm_train` give one function: from the
    statistics of the plain conv's f32 product, or from x itself."""
    x, w = _operands(13, 4 * 3 * 3, 16, 24)
    y2d, mean, var = ops.conv1x1_bn_stats(torch.from_numpy(x),
                                          torch.from_numpy(w))
    y4 = y2d.view(4, 3, 3, 24).permute(0, 3, 1, 2)
    gamma, beta = (torch.from_numpy(a) for a in _bn_vectors(14, 24))
    run = (torch.zeros(24), torch.ones(24))
    a = nn_ops.batch_norm_train(y4, gamma, beta, *run,
                                batch_stats=(mean, var))
    b = nn_ops.batch_norm_train(y4, gamma, beta, *run)
    for got, want in zip(a, b):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_kernel_gradients_equal_autograd_of_the_plain_composition(
        dtype):
    """`conv1x1_bn_relu` under grad on the CPU: x, w and γ, β (through
    `fold_bn`) get the gradients autograd gives the plain composition
    ``relu(x w · scale + shift)``."""
    x, w = _operands(15, 96, 32, 40)
    gamma, beta = _bn_vectors(16, 40)
    mean = torch.linspace(-0.2, 0.2, 40)
    var = torch.linspace(0.5, 2.0, 40)
    dy = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (96, 40)).astype(np.float32))
    tdt = getattr(torch, dtype)

    def run(fn):
        tx, tw = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (x, w))
        tg, tb = (torch.from_numpy(a).requires_grad_() for a in (gamma, beta))
        scale, shift = ops.fold_bn(tg, tb, mean, var, EPS)
        y = fn(tx, tw, scale, shift)
        return [y] + list(torch.autograd.grad(y, (tx, tw, tg, tb),
                                              dy.to(tdt)))

    def plain(tx, tw, scale, shift):
        acc = torch.matmul(tx.float(), tw.float().t())
        return torch.relu(acc * scale + shift).to(tx.dtype)

    got, want = run(ops.conv1x1_bn_relu), run(plain)
    rel = 1e-6 if dtype == "float32" else BF16_GRAD_REL
    for name, g, r in zip(("y", "dx", "dw", "dgamma", "dbeta"), got, want):
        assert g.dtype == r.dtype
        _close_rel(g.detach().float().numpy(), r.detach().float().numpy(),
                   rel, name)


@pytest.mark.parametrize("case,match", [
    ("rank", "2-D kernel"),
    ("k", "disagree in K"),
    ("dtype", "float32 or bfloat16"),
    ("mixed", "w is torch.bfloat16"),
    ("strided", "x must be contiguous"),
    ("bf16_n", "multiples of 8"),
])
def test_argument_checks(case, match):
    x, w = _operands(18, 16, 16, 24)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if case == "rank":
        xt = xt.view(2, 8, 16)
    elif case == "k":
        wt = wt[:, :8].contiguous()
    elif case == "dtype":
        xt, wt = xt.half(), wt.half()
    elif case == "mixed":
        wt = wt.to(torch.bfloat16)
    elif case == "strided":
        xt = torch.from_numpy(np.ascontiguousarray(x.T)).t()
    else:
        xt = xt.to(torch.bfloat16)
        wt = wt[:20].contiguous().to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError), match=match):
        ops.conv1x1_bn_stats(xt, wt)


def test_wrapper_is_registered_with_a_launch_count():
    assert ops.KERNEL_WRAPPERS["conv_bn_stats"] is ops.conv1x1_bn_stats
    ops.conv1x1_bn_stats.launches = 4
    ops.reset_launch_counts()
    assert ops.launch_counts()["conv_bn_stats"] == 0
