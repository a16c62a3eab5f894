"""`paddle_tpu_torch.ops` on the CPU: each kernel module's plain version
held against the JAX package's Pallas kernel run in interpret mode, on
the same numpy inputs made from a seed.

Tolerance: f32 atol 1e-5, rtol 1e-5 — the two sides sum in another
order, nothing else differs.  The CUDA kernels themselves run only on
the card (`chip_smoke.py` holds them against these plain versions);
here the wrappers take the plain path because the tensors lie on the
CPU, and their launch counters must not move.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import attention as jax_attention
from paddle_tpu.ops.pallas import attention as jax_flash
from paddle_tpu.ops.pallas import decode_attention as jax_decode
from paddle_tpu.ops.pallas import paged_attention as jax_paged
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build

TOL = dict(atol=1e-5, rtol=1e-5)
H, D = 2, 64


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# flash forward (prefill)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [8, 130, 256])
def test_flash_plain_matches_jax_kernel_causal_bshd(s):
    rng = np.random.default_rng(s)
    q, k, v = (_randn(rng, 1, s, H, D) for _ in range(3))
    want = jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        layout="BSHD", interpret=True)
    before = ops.flash_fwd.launches
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              layout="BSHD")
    assert ops.flash_fwd.launches == before   # CPU: no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sq,sk,causal", [(5, 40, True), (40, 5, True),
                                          (33, 33, False)])
def test_flash_ragged_bottom_right_and_dead_rows(sq, sk, causal):
    """Sq != Sk: the causal mask is bottom-right aligned, and a query row
    with no visible key (Sq > Sk) emits zeros — as the JAX composition."""
    rng = np.random.default_rng(sq * 100 + sk)
    q = _randn(rng, 2, H, sq, D)
    k, v = _randn(rng, 2, H, sk, D), _randn(rng, 2, H, sk, D)
    want = jax_attention.naive_attention_with_layout(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, D ** -0.5,
        causal, "BHSD")
    got = ops.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                           causal=causal, layout="BHSD")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if sq > sk and causal:
        assert not got[:, :, :sq - sk].any()


def test_flash_unported_operands_raise():
    """Only a row bias [B|1, H|1, 1, Sk] is an operand of the kernels (a
    full [B, H, Sq, Sk] bias is the reference's naive fallback, not
    ported); unknown layouts raise too."""
    x = torch.zeros(1, 8, H, D)
    with pytest.raises(ValueError, match="row bias"):
        ops.flash_attention(x, x, x, bias=torch.zeros(1, 1, 8, 8))
    with pytest.raises(ValueError, match="row bias"):
        ops.flash_attention(x, x, x, bias=torch.zeros(1, 3, 1, 8))
    with pytest.raises(ValueError):
        ops.flash_attention(x, x, x, layout="SBHD")


def test_flash_bias_and_segment_ids_run():
    """The row bias and segment ids are ported: the plain path gives the
    JAX composition's result (segment ids as its additive bias)."""
    rng = np.random.default_rng(4)
    q, k, v = (_randn(rng, 2, 24, H, D) for _ in range(3))
    bias = np.where(rng.random((2, 1, 1, 24)) < 0.3, -1e4, 0.0)
    bias = bias.astype(np.float32)
    seg = np.repeat(np.array([[0, 1, 2]]), 8, axis=1).repeat(2, axis=0)
    want = jax_attention.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=jnp.asarray(bias), segment_ids=jnp.asarray(seg), causal=True,
        layout="BSHD")
    got = ops.flash_attention(_t(q), _t(k), _t(v), bias=_t(bias),
                              segment_ids=_t(seg), causal=True,
                              layout="BSHD")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# decode attention, dense and paged
# ---------------------------------------------------------------------------


def test_dense_decode_plain_matches_jax_kernel():
    rng = np.random.default_rng(1)
    n, t = 3, 256
    q = _randn(rng, n, H, D)
    k, v = _randn(rng, n, t, H, D), _randn(rng, n, t, H, D)
    lengths = np.array([0, 1, t], np.int32)
    want = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        interpret=True)
    before = ops.decode_attention.launches
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(lengths))
    assert ops.decode_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any()                      # empty slot -> zeros


def _paged_case(rng, bs, n=3, max_blocks=4):
    """A shuffled pool; entries past each slot's live blocks are 0 (the
    garbage block) or stale ids, which must not be read."""
    t = bs * max_blocks
    lengths = np.array([0, 1, t], np.int32)
    nb = n * max_blocks + 1
    k_pool, v_pool = _randn(rng, nb, bs, H, D), _randn(rng, nb, bs, H, D)
    perm = rng.permutation(nb - 1) + 1
    tables = np.zeros((n, max_blocks), np.int32)
    used = 0
    for i, ln in enumerate(lengths):
        need = -(-int(ln) // bs)
        tables[i, :need] = perm[used:used + need]
        used += need
    tables[1, 1:] = perm[-1]                     # stale, past the length
    return _randn(rng, n, H, D), k_pool, v_pool, tables, lengths


@pytest.mark.parametrize("bs", [16, 128])
def test_paged_decode_plain_matches_jax_kernel(bs):
    rng = np.random.default_rng(bs)
    q, k_pool, v_pool, tables, lengths = _paged_case(rng, bs)
    want = jax_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(lengths), interpret=True)
    before = ops.paged_decode_attention.launches
    got = ops.paged_decode_attention(_t(q), _t(k_pool), _t(v_pool),
                                     _t(tables), _t(lengths))
    assert ops.paged_decode_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any()


@pytest.mark.parametrize("bs", [16, 128])
def test_paged_gather_and_reference_match_jax(bs):
    rng = np.random.default_rng(bs + 7)
    q, k_pool, v_pool, tables, lengths = _paged_case(rng, bs)
    got = ops.paged_gather_kv(_t(k_pool), _t(tables))
    want = jax_paged.paged_gather_kv(jnp.asarray(k_pool), jnp.asarray(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = ops.paged_decode_attention_reference(
        _t(q), _t(k_pool), _t(v_pool), _t(tables), _t(lengths))
    dense = ops.decode_attention_reference(
        _t(q), got, ops.paged_gather_kv(_t(v_pool), _t(tables)),
        _t(lengths))
    torch.testing.assert_close(ref, dense, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# build and launch plumbing that needs no card
# ---------------------------------------------------------------------------


def test_launch_counters_reset():
    ops.flash_fwd.launches = 3
    ops.flash_bwd_fused.launches = 2
    ops.matmul_bwd_dw.launches = 1
    ops.reset_launch_counts()
    assert ops.launch_counts() == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "flash_bwd_fused": 0, "decode_attention": 0, "paged_attention": 0,
        "matmul_bias_act": 0, "matmul_bwd_dx": 0, "matmul_bwd_dw": 0,
        "conv_bn_relu": 0}


def test_build_targets_sm90a_from_the_checkout_sources():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.KERNELS:
        assert (_build.CSRC / (name + ".cu")).is_file()
        assert _build._lib_path(name).name.startswith(name + "-")


def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["flash_fwd"])
