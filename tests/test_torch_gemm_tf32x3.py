"""The arithmetic of the port's f32 GEMM backward (`ops.matmul_bwd_dx`,
`ops.matmul_bwd_dw`, `csrc/gemm_tf32x3.cuh`), modelled in plain PyTorch
on the CPU.

The kernels split every operand element a into hi = tf32(a) and lo =
tf32(a - hi) (`cvt.rna`: round to nearest, ties away from zero, here
by bit masking), take each product as lo·hi, then hi·lo, then hi·hi, a
k step of 8 contraction rows at a time, into an f32 partial that is
added into the f32 sum after each k block of 32 rows (`PROMOTE` = 1);
dW's splits of M (`dw_split_plan`) are merged in split order, and dbias
is summed by each thread over its rows' elements in order and then over
the four lanes of a row in pairs.  The tensor cores' own summation
order inside a k step is not modelled (f32 sums stand in for it).

* The model equals the JAX package's dX, dW and dbias from `_mba_core`'s
  custom VJP, its Pallas kernels run in interpret mode, at a shape that
  leaves every edge of the kernels' 128 x 128 tiles and 32-row stages
  ragged (dW in 11 splits, the last one short), for all five
  activations, within `chip_smoke.py`'s f32 limit (`gemm_tol`: atol
  2^-16 of the output's scale, rtol 1e-5).
* A single TF32 product (hi·hi alone) misses that limit at a
  contraction of 3072 (the static BERT step's dX), while the split
  meets it: the card's gate tells TF32 from f32.
* The bit masking rounds as `cvt.rna.tf32.f32` does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import matmul as jax_mm
from paddle_tpu_torch.ops import matmul as port_mm

ACTS = [("none", False), ("relu", False), ("tanh", False), ("gelu", False),
        ("gelu", True)]
ACT_IDS = ["none", "relu", "tanh", "gelu", "gelu_tanh"]
# M, K, N: M = 2.6 row tiles of dX and 10.5 stages of dW's contraction,
# K = 1.3 column tiles, N = 6.25 stages of dX's contraction and 1.6 row
# tiles of dW; the Pallas blocks divide them
MKN = (336, 168, 200)
JAX_BLOCKS = dict(block_m=48, block_n=40, block_k=56)
STEP, BLOCK = 8, port_mm.F32_BWD_DEPTH   # a k step, a k block
PROMOTE = 1                              # k blocks between promotions


def gemm_tol(want):
    """`chip_smoke.gemm_tol` for f32 outputs."""
    return dict(atol=2.0 ** -16 * want.abs().max().item(), rtol=1e-5)


def assert_within(got, want, tol, what):
    share = ((got - want).abs()
             / (tol["atol"] + tol["rtol"] * want.abs())).max().item()
    assert share <= 1.0, "%s: %.3g of its limit" % (what, share)
    return share


def tf32(t):
    """f32 -> the nearest tf32 (10 stored mantissa bits), ties away from
    zero, as `cvt.rna.tf32.f32`."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(t):
    hi = tf32(t)
    return hi, tf32(t - hi)


def x3_product(a, b, terms=("lohi", "hilo", "hihi")):
    """a [R, C] (contraction C) times b [C, Q] as the kernel sums it: per
    k step the three TF32 products into the partial, the partial into
    the sum after each PROMOTE k blocks."""
    r, c = a.shape
    steps = -(-c // STEP)
    pad = steps * STEP - c
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ah, al = split(a)
    bh, bl = split(b)
    pairs = {"lohi": (al, bh), "hilo": (ah, bl), "hihi": (ah, bh)}
    prods = [torch.einsum("rsk,skq->srq", pa.view(r, steps, STEP),
                          pb.view(steps, STEP, -1))
             for pa, pb in (pairs[t] for t in terms)]
    total = torch.zeros(r, b.shape[1])
    part = torch.zeros_like(total)
    per_block = BLOCK // STEP
    for s in range(steps):
        for p in prods:
            part = part + p[s]
        if (s + 1) % (per_block * PROMOTE) == 0 or s + 1 == steps:
            total, part = total + part, torch.zeros_like(part)
    return total


def x3_dbias(dz):
    """dZ [rows of M, N] summed over M as a thread sums it: lane q takes
    contraction rows q and q + 4 of each k step in order, then the four
    lanes add in pairs, (q0 + q1) + (q2 + q3)."""
    m, n = dz.shape
    steps = -(-m // STEP)
    d = torch.nn.functional.pad(dz, (0, 0, 0, steps * STEP - m))
    d = d.view(steps, STEP, n)
    lanes = []
    for q in range(4):
        s = torch.zeros(n)
        for k in range(steps):
            s = s + d[k, q]
            s = s + d[k, q + 4]
        lanes.append(s)
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def x3_backward(x, w, res, g, act, approx, splits, chunk):
    """The kernels' dX, dW and dbias (dW and dbias over ``splits``
    chunks of M, merged in split order)."""
    dz = port_mm._dz_reference(g, res, act, approx)
    dx = x3_product(dz, w)
    dw = db = None
    for s in range(splits):
        lo, hi = s * chunk, min(x.shape[0], (s + 1) * chunk)
        pw = x3_product(dz[lo:hi].t(), x[lo:hi])
        pb = x3_dbias(dz[lo:hi])
        dw, db = (pw, pb) if dw is None else (dw + pw, db + pb)
    return dx, dw, db


def _operands(seed, mkn):
    rng = np.random.default_rng(seed)
    m, k, n = mkn
    x = (rng.standard_normal((m, k)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    g = (rng.standard_normal((m, n)) * 0.01).astype(np.float32)
    return x, w, b, g


def _jax_grads(x, w, b, g, act, approx):
    """dx, dW [K, N] and dbias from the JAX kernels' custom VJP,
    interpret mode."""
    def f(x, w, b):
        return jax_mm.matmul_bias_act(x, w, b, activation=act,
                                      approximate=approx, interpret=True,
                                      **JAX_BLOCKS)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(b))
    return [np.asarray(t) for t in vjp(jnp.asarray(g, out.dtype))]


def _residual(xt, wt, bt, act, approx):
    y, z = port_mm.matmul_bias_act_reference(xt, wt, bt, act, approx,
                                             emit_z=True)
    kind = port_mm._residual_kind(act)
    return z if kind == "z" else (y if kind == "y" else None)


def test_masking_rounds_as_cvt_rna():
    ulp = 2.0 ** -10   # a tf32 ulp at 1
    vals = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23,
                         1.0 + 1.5 * ulp, -(1.0 + ulp / 2), 3.0e-39,
                         -2.5, 65504.0 + 1 / 3], dtype=torch.float32)
    got = tf32(vals)
    want = torch.tensor([1.0, 1.0 + ulp, 1.0, 1.0 + 2 * ulp,
                         -(1.0 + ulp), tf32(torch.tensor([3.0e-39]))[0],
                         -2.5, 65504.0], dtype=torch.float32)
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    rnd = torch.randn(4096) * 100
    hi, lo = split(rnd)
    # a = hi + lo to 2^-22 of |a|
    err = (rnd.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * rnd.double().abs()).all()


def test_split_plan_takes_the_f32_tile_and_covers_every_row():
    for m, n, k in ((4096, 3072, 768), (336, 200, 168), (1, 3072, 768),
                    (777, 200, 264)):
        splits, chunk = port_mm.dw_split_plan(m, n, k,
                                              dtype=torch.float32)
        assert chunk % port_mm.F32_BWD_DEPTH == 0 and chunk > 0
        assert splits == -(-m // chunk) <= port_mm.MAX_SPLITS
        assert (splits - 1) * chunk < m
    # the static step's dW (144 tiles of 128 x 128 on 132 SMs) splits M
    assert port_mm.dw_split_plan(4096, 3072, 768,
                                 dtype=torch.float32)[0] > 1


@pytest.mark.parametrize("act,approx", ACTS, ids=ACT_IDS)
def test_x3_model_matches_the_pallas_backward(act, approx):
    m, k, n = MKN
    splits, chunk = port_mm.dw_split_plan(m, n, k, dtype=torch.float32)
    assert splits > 1 and m % chunk, "dW must split, raggedly"
    x, w, b, g = _operands(7, MKN)
    xt, wt, bt, gt = (torch.from_numpy(a) for a in (x, w, b, g))
    res = _residual(xt, wt, bt, act, approx)
    dx, dw, db = x3_backward(xt, wt, res, gt, act, approx, splits, chunk)
    want_dx, want_dw, want_db = (torch.from_numpy(np.array(a)) for a in
                                 _jax_grads(x, w, b, g, act, approx))
    # the port's dW is [N, K]: the transpose of the reference's
    for tag, got, want in (("dx", dx, want_dx), ("dw", dw, want_dw.t()),
                           ("dbias", db, want_db)):
        assert_within(got, want, gemm_tol(want), tag)


@pytest.mark.parametrize("act,approx", [("none", False), ("gelu", False)],
                         ids=["none", "gelu"])
def test_one_tf32_product_misses_the_f32_limit_at_3072(act, approx):
    """dX of the static step's FFN at 16 rows: N = 3072 contraction
    rows, K = 64 columns.  The plain f32 version is the card's
    reference; the split meets its limit, hi·hi alone does not."""
    m, k, n = 16, 64, 3072
    x, w, b, g = _operands(11, (m, k, n))
    xt, wt, bt, gt = (torch.from_numpy(a) for a in (x, w, b, g))
    res = _residual(xt, wt, bt, act, approx)
    want, _, _ = port_mm.matmul_bias_act_bwd_reference(
        xt, wt, bt, res, gt, act, approx, needs=(True, False, False))
    dz = port_mm._dz_reference(gt, res, act, approx)
    tol = gemm_tol(want)
    share = assert_within(x3_product(dz, wt), want, tol, "3xTF32 dX")
    one = x3_product(dz, wt, terms=("hihi",))
    one_share = ((one - want).abs()
                 / (tol["atol"] + tol["rtol"] * want.abs())).max().item()
    assert one_share > 1.0, "1xTF32 within the f32 limit (%.3g)" % one_share
    assert one_share > 20 * share
