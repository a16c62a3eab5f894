"""The numerical scheme of the bf16 flash kernels (`csrc/flash_fwd.cu`'s
wgmma forward, `csrc/flash_bwd_fused.cu`'s mma.sync backward and the
mma.sync dQ + dK/dV pair of `csrc/flash_bwd.cu`), modelled on the CPU
and held to the port's f32 plain versions.

The model repeats the kernels' arithmetic: Q, K, V and dO are bf16 and
enter the products exactly (each product of two bf16 values is exact in
f32); the operands the kernels form themselves, P in the forward and P
and dS in the backward, are f32 and go into their products as two bf16
halves, hi = bf16(x) and lo = bf16(x - hi), each product accumulated in
f32; the forward walks 64-key tiles with the online-softmax rescale and
rounds O to bf16 once at the end; the pair forms P and dS twice, by
query rows in its dQ kernel and by keys in its dK/dV kernel, each
walking 64-row tiles of the other axis.

Limits: `chip_smoke.py`'s bf16 ones, which the kernels must meet on the
card against the same f32 plain versions: atol 1e-5, rtol 2 * 2^-8 for O
and the gradients (TOL / GRAD_TOL), atol 1e-4, rtol 1e-5 for the LSE
(LSE_TOL).  A model that rounds P and dS to bf16 once, as a plain
bf16 product would, must be further from the f32 result than the
(hi, lo) model: that is what the second MMA buys; for the pair, at
D = 64 and 128, it must break the limits outright.  The forward is also
held against the JAX package's Pallas kernel in interpret mode on the
same bf16 inputs, under the repo's bf16 policy (2e-2,
``PADDLE_TPU_FLASH_ACC``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import attention as jax_flash
from paddle_tpu_torch import ops

B, H = 2, 2
NEG_INF = -1e30
BF16_ROUND = 2.0 ** -8
TOL = dict(atol=1e-5, rtol=2 * BF16_ROUND)        # chip_smoke.TOL[bf16]
GRAD_TOL = dict(atol=1e-5, rtol=2 * BF16_ROUND)   # chip_smoke.GRAD_TOL
LSE_TOL = dict(atol=1e-4, rtol=1e-5)              # chip_smoke.LSE_TOL
JAX_BF16_TOL = dict(atol=2e-2, rtol=2e-2)
KEY_TILE = 64


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    """(hi, lo) bf16 halves of an f32 tensor, as f32 tensors."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _prod(a, b, split):
    """a @ b with a formed in f32: two bf16 products (hi, lo) or one."""
    if not split:
        return _bf16(a) @ b
    hi, lo = _split(a)
    return hi @ b + lo @ b


def _case(seed, s, d, masked):
    """bf16-exact BHSD q, k, v, dO; with ``masked`` a -1e4 padding bias on
    row 0's last quarter of keys and segment ids packing row 1 into two
    segments, its query 3 matching no key (a dead row)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(torch.from_numpy(
        rng.standard_normal((B, H, s, d)).astype(np.float32)))
        for _ in range(4))
    bias = segs = None
    if masked:
        bias = torch.zeros(B, 1, 1, s)
        bias[0, :, :, s - s // 4:] = -1e4
        kseg = torch.zeros(B, s, dtype=torch.int32)
        kseg[1, s // 2:] = 1
        qseg = kseg.clone()
        qseg[1, 3] = 7
        segs = (qseg, kseg)
    return q, k, v, do, bias, segs


def _scores(q, k, bias, segs, scale, causal):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    if segs is not None:
        same = segs[0][:, None, :, None] == segs[1][:, None, None, :]
        s = torch.where(same, s, NEG_INF)
    if causal:
        sq, sk = s.shape[-2:]
        vis = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
        s = torch.where(vis, s, NEG_INF)
    return s


def model_fwd(q, k, v, bias, segs, scale, causal, split=True):
    """The forward kernel's arithmetic: (o in f32 before its bf16
    rounding, lse [B*H, S])."""
    s_all = _scores(q, k, bias, segs, scale, causal)
    b, h, sq, sk = s_all.shape
    m = torch.full((b, h, sq), NEG_INF)
    l = torch.zeros(b, h, sq)
    o = torch.zeros(b, h, sq, v.shape[-1])
    for n0 in range(0, sk, KEY_TILE):
        s = s_all[..., n0:n0 + KEY_TILE]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(s <= NEG_INF / 2, 0.0,
                        torch.exp(s - m_new[..., None]))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + _prod(p, v[:, :, n0:n0 + KEY_TILE], split)
        m = m_new
    dead = m <= NEG_INF / 2
    lsafe = torch.where(l == 0, 1.0, l)
    o = torch.where(dead[..., None], 0.0, o / lsafe[..., None])
    lse = torch.where(dead, NEG_INF, m + torch.log(lsafe))
    return o, lse.reshape(b * h, sq)


def model_bwd(q, k, v, o, do, lse, bias, segs, scale, causal, split=True):
    """The fused backward kernel's arithmetic from the forward's bf16 O
    and its LSE: (dq, dk, dv in f32 before their bf16 rounding, dbias)."""
    b, h, sq, _ = q.shape
    s = _scores(q, k, bias, segs, scale, causal)
    lse = lse.reshape(b, h, sq)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    delta = (do * o).sum(dim=-1)
    ds = p * (dp - delta[..., None])
    dbias = ds.sum(dim=-2, keepdim=True)
    ds = ds * scale
    dv = _prod(p.transpose(-1, -2), do, split)
    dk = _prod(ds.transpose(-1, -2), q, split)
    dq = _prod(ds, k, split)
    return dq, dk, dv, dbias


def _bhsd_to_bshd(t):
    return t.transpose(1, 2)


def _share(got, want, tol):
    """The largest share of its limit any element uses."""
    return float(((got - want).abs()
                  / (tol["atol"] + tol["rtol"] * want.abs())).max())


CASES = [(s, causal, masked) for s in (128, 200) for causal in (False, True)
         for masked in (False, True)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,causal,masked", CASES)
def test_forward_scheme_meets_the_card_limits(s, causal, masked, d):
    q, k, v, _, bias, segs = _case(7 * s + d + 2 * causal + masked, s, d,
                                   masked)
    scale = d ** -0.5
    want, want_lse = ops.flash_attention_reference(
        q, k, v, bias, segs, scale, causal, layout="BHSD")
    o, lse = model_fwd(q, k, v, bias, segs, scale, causal)
    assert _share(_bf16(o), want, TOL) <= 1.0
    assert _share(lse, want_lse, LSE_TOL) <= 1.0
    once, _ = model_fwd(q, k, v, bias, segs, scale, causal, split=False)
    err, err_once = ((x - want).abs().max() for x in (o, once))
    assert err < err_once, (float(err), float(err_once))
    if masked:
        assert not _bf16(o)[1, :, 3].any()
        assert (lse.view(B, H, s)[1, :, 3] == NEG_INF).all()


@pytest.mark.parametrize("s,causal,masked", CASES)
def test_fused_backward_scheme_meets_the_card_limits(s, causal, masked):
    d = 64
    q, k, v, do, bias, segs = _case(11 * s + 2 * causal + masked, s, d,
                                    masked)
    scale = d ** -0.5
    o32, lse = model_fwd(q, k, v, bias, segs, scale, causal)
    o = _bf16(o32)                 # the forward kernel's bf16 output
    want = ops.flash_attention_bwd_reference(
        q, k, v, bias, segs, o, do, lse, scale, causal, layout="BHSD")
    got = model_bwd(q, k, v, o, do, lse, bias, segs, scale, causal)
    once = model_bwd(q, k, v, o, do, lse, bias, segs, scale, causal,
                     split=False)
    for name, g, w, g1 in zip(("dq", "dk", "dv"), got, want, once):
        assert _share(_bf16(g), w, GRAD_TOL) <= 1.0, name
        err, err_once = (g - w).abs().max(), (g1 - w).abs().max()
        assert err < err_once, (name, float(err), float(err_once))
    if masked:
        assert _share(got[3], want[3], GRAD_TOL) <= 1.0
        assert not _bf16(got[0])[1, :, 3].any()


def model_pair_bwd(q, k, v, o, do, lse, bias, segs, scale, causal,
                   split=True, tile=64):
    """The dQ + dK/dV pair's arithmetic from the forward's bf16 O and its
    LSE: (dq, dk, dv in f32 before their bf16 rounding, dbias, delta).
    The dQ kernel forms S = Q K^T, P and scale dS by query rows and adds
    dQ += (scale dS) K over 64-key tiles; the dK/dV kernel forms S^T,
    P^T and dS^T by keys and adds dV += P^T dO and dK += (scale dS^T) Q
    over 64-query tiles; each formed operand enters its product as
    (hi, lo) halves, or rounded once with ``split=False``."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    lse = lse.reshape(b, h, sq)
    delta = (do * o).sum(dim=-1)               # the dQ kernel's prologue

    def probs(s):
        return torch.where(s <= NEG_INF / 2, 0.0,
                           torch.exp(s - lse[..., None]))

    # the dQ kernel: rows, walking key tiles
    s_rows = _scores(q, k, bias, segs, scale, causal)
    ds_rows = probs(s_rows) * (torch.einsum("bhqd,bhkd->bhqk", do, v)
                               - delta[..., None]) * scale
    dq = sum(_prod(ds_rows[..., n0:n0 + tile], k[:, :, n0:n0 + tile], split)
             for n0 in range(0, sk, tile))
    # the dK/dV kernel: keys, walking query tiles
    st = _scores(q, k, bias, segs, scale, causal).transpose(-1, -2)
    pt = torch.where(st <= NEG_INF / 2, 0.0,
                     torch.exp(st - lse[:, :, None, :]))
    dst = pt * (torch.einsum("bhkd,bhqd->bhkq", v, do) - delta[:, :, None])
    dbias = dst.sum(dim=-1)[:, :, None, :]
    dst = dst * scale
    dk = sum(_prod(dst[..., m0:m0 + tile], q[:, :, m0:m0 + tile], split)
             for m0 in range(0, sq, tile))
    dv = sum(_prod(pt[..., m0:m0 + tile], do[:, :, m0:m0 + tile], split)
             for m0 in range(0, sq, tile))
    return dq, dk, dv, dbias, delta.reshape(b * h, sq)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,causal,masked", CASES)
def test_pair_backward_scheme_meets_the_card_limits(s, causal, masked, d):
    """dQ from dS, dK from dS^T and dV from P^T, each formed operand as
    (hi, lo) halves, meet chip_smoke's limits against the f32 plain
    version; rounded once to bf16, each output breaks them."""
    q, k, v, do, bias, segs = _case(17 * s + d + 2 * causal + masked, s, d,
                                    masked)
    scale = d ** -0.5
    o32, lse = model_fwd(q, k, v, bias, segs, scale, causal)
    o = _bf16(o32)
    want = ops.flash_attention_bwd_reference(
        q, k, v, bias, segs, o, do, lse, scale, causal, layout="BHSD")
    got = model_pair_bwd(q, k, v, o, do, lse, bias, segs, scale, causal)
    once = model_pair_bwd(q, k, v, o, do, lse, bias, segs, scale, causal,
                          split=False)
    for name, g, w, g1 in zip(("dq", "dk", "dv"), got, want, once):
        assert _share(_bf16(g), w, GRAD_TOL) <= 1.0, name
        assert _share(_bf16(g1), w, GRAD_TOL) > 1.0, name
    want_delta = (do * o).sum(dim=-1).reshape(B * H, s)
    torch.testing.assert_close(got[4], want_delta, atol=1e-5, rtol=1e-4)
    if masked:
        assert _share(got[3], want[3], GRAD_TOL) <= 1.0
        assert not _bf16(got[0])[1, :, 3].any()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,causal,masked", [(128, False, False),
                                             (200, True, True)])
def test_forward_scheme_matches_the_pallas_kernel_bf16(s, causal, masked, d):
    q, k, v, _, bias, segs = _case(13 * s + d, s, d, masked)
    o, _ = model_fwd(q, k, v, bias, segs, d ** -0.5, causal)
    cast = (lambda t: jnp.asarray(_bhsd_to_bshd(t).numpy(), jnp.bfloat16))
    want = jax_flash.flash_attention(
        cast(q), cast(k), cast(v),
        bias=None if bias is None else jnp.asarray(bias.numpy()),
        segment_ids=None if segs is None else tuple(
            jnp.asarray(x.numpy()) for x in segs),
        causal=causal, layout="BSHD", interpret=True)
    want = torch.from_numpy(np.asarray(want, np.float32))
    torch.testing.assert_close(_bhsd_to_bshd(_bf16(o)), want,
                               **JAX_BF16_TOL)


if __name__ == "__main__":
    # The largest share of its limit that the (hi, lo) model and the
    # rounded-once model use over the cases above, D = 64 (forward, fused
    # backward, pair):
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_flash_numerics.py
    shares = {}
    for s, causal, masked in CASES:
        q, k, v, do, bias, segs = _case(1, s, 64, masked)
        want, _ = ops.flash_attention_reference(q, k, v, bias, segs, 0.125,
                                                causal, layout="BHSD")
        o, lse = model_fwd(q, k, v, bias, segs, 0.125, causal)
        o = _bf16(o)
        gw = ops.flash_attention_bwd_reference(
            q, k, v, bias, segs, o, do, lse, 0.125, causal, layout="BHSD")
        for split in (True, False):
            of, _ = model_fwd(q, k, v, bias, segs, 0.125, causal, split)
            g = model_bwd(q, k, v, o, do, lse, bias, segs, 0.125, causal,
                          split)
            key = "hi_lo" if split else "rounded_once"
            shares.setdefault("forward " + key, []).append(
                _share(_bf16(of), want, TOL))
            shares.setdefault("backward " + key, []).append(max(
                _share(_bf16(a), w, GRAD_TOL) for a, w in zip(g[:3], gw[:3])))
            gp = model_pair_bwd(q, k, v, o, do, lse, bias, segs, 0.125, causal,
                                split)
            shares.setdefault("pair " + key, []).append(max(
                _share(_bf16(a), w, GRAD_TOL) for a, w in zip(gp[:3], gw[:3])))
    for key, vals in shares.items():
        print("%-24s %.4f of the limit" % (key, max(vals)))
