"""The host side and the arithmetic of the port's split decode kernels
(`ops.decode_attention`, `ops.paged_decode_attention`, one body in
`csrc/decode_common.cuh`), on the CPU.

* `decode_split_plan` covers every position below the cache's capacity
  exactly once, in whole blocks, with no empty chunk; the dense cache
  and a pool of 16-row blocks plan alike.
* The split-and-combine arithmetic, emulated in plain PyTorch in the
  kernels' fixed chunk order (each chunk's max, sum and weighted values,
  merged in chunk order against the largest max), equals the JAX
  package's `decode_attention` and `paged_decode_attention` run in
  interpret mode, with lengths 0, 1, bs - 1, a chunk +- 1 and T and
  stale table entries past a length.  Limit: atol 1e-5, rtol 1e-4 (the
  sides sum in other orders).
* A CPU call launches no kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import decode_attention as jax_decode
from paddle_tpu.ops.pallas import paged_attention as jax_paged
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops.decode_attention import (DECODE_MAX_CHUNKS,
                                                   DECODE_MAX_HEADS,
                                                   decode_head_groups,
                                                   decode_split_plan)

TOL = dict(atol=1e-5, rtol=1e-4)
H, D = 2, 64


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("cap", ["bs", "1024", "1000", "77.5bs", "300bs"])
def test_plan_covers_every_position_once_in_whole_blocks(bs, cap):
    """T = bs, 1024, a ragged T, and capacities past 64 blocks."""
    cap = (int(float(cap[:-2]) * bs) if cap.endswith("bs") and cap != "bs"
           else bs if cap == "bs" else int(cap))
    chunk, chunks = decode_split_plan(cap, bs)
    assert chunk % bs == 0 and 1 <= chunks <= DECODE_MAX_CHUNKS
    seen = np.zeros(cap, np.int32)
    for c in range(chunks):
        lo, hi = c * chunk, min(cap, (c + 1) * chunk)
        assert hi > lo                            # no empty chunk
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert chunks * chunk >= cap > (chunks - 1) * chunk


@pytest.mark.parametrize("t", [16, 1024, 1000, 4096, 65536])
def test_dense_and_16_row_pools_plan_alike(t):
    mb = -(-t // 16)
    assert decode_split_plan(t) == decode_split_plan(mb * 16, 16)


@pytest.mark.parametrize("h,max_heads,want", [
    (1, 6, 1), (12, 6, 6), (16, 6, 6), (20, 6, 5), (32, 6, 6), (12, 12, 12),
    (12, 16, 12), (32, 16, 16), (40, 16, 14)])
def test_head_groups_cover_the_heads_in_even_shares(h, max_heads, want):
    hg = decode_head_groups(h, max_heads)
    assert hg == want and hg <= max_heads
    assert -(-h // hg) * hg - h < hg           # the last group not empty
    assert decode_head_groups(h) <= DECODE_MAX_HEADS


def split_decode(q, k, v, lengths, scale, chunk):
    """The kernels' arithmetic at chunk granularity: q [N, H, D], k / v
    [N, T, H, D] (the rows each slot reads, in order), f32.  Each live
    chunk's (m, l, acc); then M = max m, out = sum acc e^(m - M) / sum
    l e^(m - M), summed in chunk order; an empty slot emits zeros."""
    out = torch.zeros_like(q)
    for i, ln in enumerate(int(x) for x in lengths):
        parts = []
        for lo in range(0, ln, chunk):
            hi = min(ln, lo + chunk)
            s = torch.einsum("hd,thd->ht", q[i], k[i, lo:hi]) * scale
            m = s.amax(dim=-1)
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(dim=-1),
                          torch.einsum("ht,thd->hd", p, v[i, lo:hi])))
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l_tot, o = torch.zeros_like(mx), torch.zeros_like(q[i])
        for m, l, acc in parts:
            w = torch.exp(m - mx)
            l_tot = l_tot + l * w
            o = o + acc * w[:, None]
        out[i] = o / l_tot[:, None]
    return out


def _lengths(t, bs, chunk):
    return np.array([0, 1, bs - 1, chunk - 1, chunk + 1, t], np.int32)


@pytest.mark.parametrize("t,max_chunks", [(256, 64), (256, 4), (200, 32),
                                          (1024, 32)])
def test_split_arithmetic_matches_jax_dense_decode(t, max_chunks):
    rng = np.random.default_rng(t + max_chunks)
    chunk, _ = decode_split_plan(t, 16, max_chunks)
    lengths = _lengths(t, 16, chunk)
    n = len(lengths)
    q = _randn(rng, n, H, D)
    k, v = _randn(rng, n, t, H, D), _randn(rng, n, t, H, D)
    want = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        interpret=True)
    got = split_decode(_t(q), _t(k), _t(v), lengths, D ** -0.5, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any()


@pytest.mark.parametrize("bs,max_blocks,max_chunks",
                         [(16, 16, 64), (16, 16, 4), (128, 4, 64),
                          (128, 4, 2)])
def test_split_arithmetic_matches_jax_paged_decode(bs, max_blocks,
                                                   max_chunks):
    rng = np.random.default_rng(bs * max_blocks + max_chunks)
    t = bs * max_blocks
    chunk, _ = decode_split_plan(t, bs, max_chunks)
    lengths = _lengths(t, bs, chunk)
    n = len(lengths)
    nb = n * max_blocks + 1
    k_pool, v_pool = _randn(rng, nb, bs, H, D), _randn(rng, nb, bs, H, D)
    perm = rng.permutation(nb - 1) + 1
    tables = np.zeros((n, max_blocks), np.int32)
    used = 0
    for i, ln in enumerate(lengths):
        need = -(-int(ln) // bs)
        tables[i, :need] = perm[used:used + need]
        tables[i, need:] = perm[-1 - i]          # stale, past the length
        used += need
    q = _randn(rng, n, H, D)
    want = jax_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(lengths), interpret=True)
    k = ops.paged_gather_kv(_t(k_pool), _t(tables))
    v = ops.paged_gather_kv(_t(v_pool), _t(tables))
    got = split_decode(_t(q), k, v, lengths, D ** -0.5, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any()


def test_cpu_calls_launch_no_kernel():
    ops.reset_launch_counts()
    rng = np.random.default_rng(3)
    n, bs, mb = 3, 16, 4
    q = _t(_randn(rng, n, H, D))
    k_pool, v_pool = (_t(_randn(rng, n * mb + 1, bs, H, D)) for _ in range(2))
    tables = _t(np.arange(1, n * mb + 1, dtype=np.int32).reshape(n, mb))
    lengths = _t(np.array([0, 5, 64], np.int32))
    k, v = ops.paged_gather_kv(k_pool, tables), ops.paged_gather_kv(v_pool,
                                                                    tables)
    dense = ops.decode_attention(q, k, v, lengths)
    paged = ops.paged_decode_attention(q, k_pool, v_pool, tables, lengths)
    torch.testing.assert_close(dense, ops.decode_attention_reference(
        q, k, v, lengths), atol=0, rtol=0)
    torch.testing.assert_close(paged, dense, atol=0, rtol=0)
    counts = ops.launch_counts()
    assert (counts["decode_attention"], counts["paged_attention"]) == (0, 0)
