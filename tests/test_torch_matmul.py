"""The fused-epilogue GEMM of `paddle_tpu_torch` (`ops.matmul_bias_act`,
`nn.functional.fused_linear`) held against the JAX package's Pallas
kernels run in interpret mode on the CPU, on the same numpy inputs made
from a seed.

On the CPU the port's `torch.autograd.Function` runs through the plain
versions of its three kernels (`matmul_bias_act_reference` forward,
`matmul_bias_act_bwd_reference` backward from the saved residual), so
these tests exercise the residual policy and the gradient plumbing the
card uses.  The JAX side runs `_mba_core`'s forward and custom VJP with
128 blocks, a multi-block grid at M, K, N = 256, 256, 512.  The port's
weight is ``[N, K]``; the JAX one is its transpose.

Tolerances, as `tests/test_pallas_matmul.py` holds the reference: f32
forward 1e-5; gradients rtol 2e-4 / atol 2e-5 (both sides sum in f32,
in another order).  bf16 operands: forward 2e-2, gradients 5e-2 (the
repo's bf16 policy).
"""

import contextlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import matmul as jax_mm
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import matmul as port_mm

MKN = (256, 256, 512)
BLOCKS = dict(block_m=128, block_n=128, block_k=128)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-4)
BF16_FWD_TOL = dict(atol=2e-2, rtol=2e-2)
BF16_GRAD_TOL = dict(atol=5e-2, rtol=5e-2)
ACTS = [("none", False), ("relu", False), ("tanh", False), ("gelu", False),
        ("gelu", True)]


def _operands(seed=0, mkn=MKN):
    """x [M, K], w [N, K] (the port's layout), bias [N], cotangent
    [M, N], f32."""
    rng = np.random.default_rng(seed)
    m, k, n = mkn
    x = (rng.standard_normal((m, k)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    g = (rng.standard_normal((m, n)) * 0.01).astype(np.float32)
    return x, w, b, g


def _jax_fwd_vjp(x, w, b, g, act, approx, dtype=jnp.float32):
    """The JAX kernels' forward and (dx, dw [K, N], dbias) through their
    custom VJP, interpret mode."""
    args = [jnp.asarray(x, dtype), jnp.asarray(w.T, dtype)]
    if b is not None:
        args.append(jnp.asarray(b, dtype))

    def f(x, w, *bias):
        return jax_mm.matmul_bias_act(
            x, w, bias[0] if bias else None, activation=act,
            approximate=approx, interpret=True, **BLOCKS)

    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(g, out.dtype))
    return [np.asarray(jnp.asarray(t, jnp.float32)) for t in (out,) + grads]


def _port_fwd_grads(x, w, b, g, act, approx, dtype=torch.float32):
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    wt = torch.tensor(w, dtype=dtype, requires_grad=True)
    bt = None if b is None else torch.tensor(b, dtype=dtype,
                                             requires_grad=True)
    out = ops.matmul_bias_act(xt, wt, bt, act, approx)
    out.backward(torch.tensor(g, dtype=dtype))
    res = [out, xt.grad, wt.grad] + ([] if bt is None else [bt.grad])
    return [t.detach().float().numpy() for t in res]


def _truth_distances(x, w, b, act, approx, got, want):
    """The failure message of the forward check: how far each side lies
    from the same function in float64, so a failure names the side that
    drifted."""
    z = x.astype(np.float64) @ w.T.astype(np.float64)
    if b is not None:
        z = z + b
    truth = port_mm._apply_act(torch.from_numpy(z), act, approx).numpy()
    return ("y: max |port - f64| %.3g, max |pallas - f64| %.3g"
            % (np.abs(got - truth).max(), np.abs(want - truth).max()))


@pytest.mark.parametrize("act,approx", ACTS,
                         ids=["none", "relu", "tanh", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_forward_and_grads_match_the_pallas_kernels(act, approx, with_bias):
    x, w, b, g = _operands()
    b = b if with_bias else None
    want = _jax_fwd_vjp(x, w, b, g, act, approx)
    got = _port_fwd_grads(x, w, b, g, act, approx)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL,
                               err_msg=_truth_distances(x, w, b, act, approx,
                                                        got[0], want[0]))
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL, err_msg="dx")
    # the port's dW is [N, K]: the transpose of the reference's
    np.testing.assert_allclose(got[2], want[2].T, **GRAD_TOL, err_msg="dw")
    if with_bias:
        np.testing.assert_allclose(got[3], want[3], **GRAD_TOL,
                                   err_msg="dbias")


def _drifting_f32_tanh(tanh):
    """``torch.tanh`` as the worker of a failed run of
    `test_forward_and_grads_match_the_pallas_kernels[bias-tanh]` computed
    it: in float32, off by up to 3.6e-5 wherever |x| > ln 2 (the 21
    outputs with |y| > 0.6 of that case, and no other), while exact in
    float64 (that failure's float64 truth agreed with the Pallas kernel
    to 2.3e-7)."""
    def drifting(t, *args, **kwargs):
        y = tanh(t, *args, **kwargs)
        if t.dtype == torch.float32:
            y = y + torch.where(t.abs() > math.log(2.0),
                                3.6e-5 * torch.sign(t), 0.0)
        return y
    return drifting


def test_forward_is_immune_to_a_drifting_f32_tanh(monkeypatch):
    """The flaky [bias-tanh] failure, with its state set by hand: under a
    float32 tanh that drifts as the failing worker's did, an f32
    activation breaks FWD_TOL against the Pallas kernel, and the port's
    forward, which evaluates its activation in float64, keeps it."""
    x, w, b, g = _operands()
    want = _jax_fwd_vjp(x, w, b, g, "tanh", False)[0]
    monkeypatch.setattr(torch, "tanh", _drifting_f32_tanh(torch.tanh))
    z = torch.tensor(x) @ torch.tensor(w).t() + torch.tensor(b)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(torch.tanh(z).numpy(), want, **FWD_TOL)
    got = _port_fwd_grads(x, w, b, g, "tanh", False)
    np.testing.assert_allclose(got[0], want, **FWD_TOL)


@pytest.mark.parametrize("act,approx", [("gelu", False), ("relu", False)])
def test_bf16_operands_match_at_the_bf16_policy(act, approx):
    x, w, b, g = _operands(seed=1)
    want = _jax_fwd_vjp(x, w, b, g, act, approx, jnp.bfloat16)
    got = _port_fwd_grads(x, w, b, g, act, approx, torch.bfloat16)
    np.testing.assert_allclose(got[0], want[0], **BF16_FWD_TOL)
    for name, a, r in zip(("dx", "dw", "dbias"), got[1:],
                          (want[1], want[2].T, want[3])):
        np.testing.assert_allclose(a, r, **BF16_GRAD_TOL, err_msg=name)


def test_plain_forward_rounds_once_and_emits_z():
    """y is act(z_f32), evaluated in float64, rounded once to x's dtype;
    the saved z is z_f32 rounded to x's dtype; the kernel wrapper on CPU
    tensors is the plain version."""
    x, w, b, _ = _operands(seed=2, mkn=(16, 24, 32))
    xt, wt, bt = (torch.tensor(a).to(torch.bfloat16) for a in (x, w, b))
    y, z = ops.matmul_bias_act_fwd(xt, wt, bt, "gelu", emit_z=True)
    z32 = xt.float() @ wt.float().t() + bt.float()
    torch.testing.assert_close(z, z32.to(torch.bfloat16), atol=0, rtol=0)
    torch.testing.assert_close(
        y, torch.nn.functional.gelu(z32.double()).to(torch.bfloat16), atol=0,
        rtol=0)
    y2, none = ops.matmul_bias_act_fwd(xt, wt, bt, "gelu")
    assert none is None and torch.equal(y, y2)


# ---------------------------------------------------------------------------
# the residual policy: what the backward saves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act,kind", [("gelu", "z"), ("relu", "y"),
                                      ("tanh", "y"), ("none", None)])
def test_residual_policy_saves_what_the_reference_saves(act, kind):
    x, w, b, _ = _operands(seed=3, mkn=(8, 16, 24))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = ops.matmul_bias_act(xt, wt, bt, act)
    assert y.grad_fn.residual_kind == kind
    assert saved[0] is xt and saved[1] is wt and saved[2] is bt
    extra = saved[3:]
    if kind is None:
        assert extra == []
    else:
        (res,) = extra
        z = torch.tensor(x) @ torch.tensor(w).t() + torch.tensor(b)
        want = z if kind == "z" else y.detach()
        torch.testing.assert_close(res.detach(), want, atol=0, rtol=0)


def test_backward_computes_only_the_gradients_asked_for():
    x, w, b, g = _operands(seed=4, mkn=(8, 16, 24))
    xt = torch.tensor(x)                               # no grad for x
    wt = torch.tensor(w, requires_grad=True)
    y = ops.matmul_bias_act(xt, wt, torch.tensor(b), "gelu")
    y.backward(torch.tensor(g))
    assert xt.grad is None and wt.grad is not None
    with torch.no_grad():                              # no graph at all
        out = ops.matmul_bias_act(xt, wt, None, "gelu")
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# argument checks and the block contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["activation", "rank", "bias"])
def test_argument_checks_raise_as_the_reference_does(case):
    x, w, b, _ = _operands(seed=5, mkn=(8, 16, 24))
    kw = {}
    if case == "activation":
        kw = dict(activation="swish")
    elif case == "rank":
        x = x.reshape(2, 4, 16)
    else:
        b = b[:5]
    with pytest.raises(ValueError) as want:
        jax_mm.matmul_bias_act(jnp.asarray(x), jnp.asarray(w.T),
                               jnp.asarray(b), interpret=True, **kw)
    with pytest.raises(ValueError) as got:
        ops.matmul_bias_act(torch.tensor(x), torch.tensor(w),
                            torch.tensor(b), **kw)
    head = str(want.value).split(":")[0].split("[")[0]
    assert str(got.value).startswith(head)


@pytest.mark.parametrize("env,explicit", [
    (None, {}),
    ("256,256,256", {}),
    ("256,256,256", dict(block_m=128)),
    ("100,256,256", {}),
    (None, dict(block_n=512, block_k=256)),
])
def test_block_contract_matches_the_reference(env, explicit, monkeypatch):
    """Explicit blocks beat PADDLE_TPU_GEMM_BLOCKS, which beats the
    largest-divisor heuristic; a non-dividing env falls back with a
    warning.  The card's kernels do not take the resolved blocks."""
    if env is None:
        monkeypatch.delenv("PADDLE_TPU_GEMM_BLOCKS", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_GEMM_BLOCKS", env)
    m, n, k = 512, 1024, 256
    def warns():
        return (pytest.warns(UserWarning) if env == "100,256,256"
                else contextlib.nullcontext())

    with warns():
        got = port_mm._block_sizes(m, n, k, **explicit)
    with warns():
        want = jax_mm._block_sizes(m, n, k, **explicit)
    assert got == want


def test_explicit_non_divisor_raises_and_ragged_shapes_run():
    x, w, b, _ = _operands(seed=6, mkn=(200, 64, 96))
    xt, wt, bt = torch.tensor(x), torch.tensor(w), torch.tensor(b)
    with pytest.raises(ValueError, match="block_m=128 must divide"):
        ops.matmul_bias_act(xt, wt, bt, "gelu", block_m=128)
    with pytest.raises(ValueError, match="block_m=128 must divide"):
        jax_mm.matmul_bias_act(jnp.asarray(x), jnp.asarray(w.T),
                               jnp.asarray(b), "gelu", interpret=True,
                               block_m=128)
    # no 128-divisible dim: the reference falls back to its naive
    # composition, the port's kernels take the shape as it is
    want = jax_mm.naive_matmul_bias_act(jnp.asarray(x), jnp.asarray(w.T),
                                        jnp.asarray(b), "gelu")
    got = ops.matmul_bias_act(xt, wt, bt, "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


# ---------------------------------------------------------------------------
# fused_linear and the launch counters
# ---------------------------------------------------------------------------


def test_fused_linear_flattens_leading_dims():
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((3, 5, 16)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((24, 16)).astype(np.float32))
    b = torch.tensor(rng.standard_normal(24).astype(np.float32))
    out = port_nn.functional.fused_linear(x, w, b, activation="gelu")
    flat = ops.matmul_bias_act(x.reshape(15, 16), w, b, "gelu")
    assert out.shape == (3, 5, 24)
    torch.testing.assert_close(out, flat.reshape(3, 5, 24), atol=0, rtol=0)
    want = jax_mm.naive_matmul_bias_act(
        jnp.asarray(x.numpy().reshape(15, 16)), jnp.asarray(w.numpy().T),
        jnp.asarray(b.numpy()), "gelu")
    np.testing.assert_allclose(out.reshape(15, 24).numpy(), np.asarray(want),
                               **FWD_TOL)


def test_cpu_calls_launch_no_kernel():
    ops.reset_launch_counts()
    x, w, b, g = _operands(seed=8, mkn=(8, 16, 24))
    xt = torch.tensor(x, requires_grad=True)
    y = ops.matmul_bias_act(xt, torch.tensor(w), torch.tensor(b), "tanh")
    y.backward(torch.tensor(g))
    counts = ops.launch_counts()
    assert {k: counts[k] for k in ("matmul_bias_act", "matmul_bwd_dx",
                                   "matmul_bwd_dw")} == {
        "matmul_bias_act": 0, "matmul_bwd_dx": 0, "matmul_bwd_dw": 0}
