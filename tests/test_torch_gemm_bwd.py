"""The host side of the port's bf16 GEMM backward (`ops.matmul_bwd_dx`,
`ops.matmul_bwd_dw`, `csrc/gemm_tc.cuh`), on the CPU.

* `dw_split_plan`, the split of M that the dW kernel runs, covers every
  row of M exactly once in chunks of whole 64-row stages, none empty.
* The dW kernel's split-M arithmetic, emulated in plain PyTorch in its
  fixed order (f32 partials of dZᵀ x and of Σ dZ a chunk, added in
  chunk order), equals the JAX package's dW and dbias from `_mba_core`'s
  custom VJP, its Pallas kernels run in interpret mode, at a shape whose
  last chunk is short.  Limits as `tests/test_torch_matmul.py` holds the
  f32 gradients: rtol 2e-4 / atol 2e-5 (both sides sum in f32, in
  other orders).
* The wrappers hold their operand contract on CPU tensors too: a
  16-byte-misaligned storage offset raises (TMA and the 16-byte loads
  need aligned bases), and a CPU call launches no kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import matmul as jax_mm
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import matmul as port_mm

GRAD_TOL = dict(atol=2e-5, rtol=2e-4)
ACTS = [("none", False), ("relu", False), ("tanh", False), ("gelu", False),
        ("gelu", True)]
# M = 7 x 128 rows (the Pallas blocks divide it); the plan cuts it into
# 5 chunks of 192, the last one 128 rows
SPLIT_MKN = (896, 256, 512)


def _chunks(m, splits, chunk):
    return [(s * chunk, min(m, (s + 1) * chunk)) for s in range(splits)]


@pytest.mark.parametrize("m", [1, 63, 777, 30720])
@pytest.mark.parametrize("nk", [(3072, 768), (200, 264), (512, 256)],
                         ids=["ffn", "ragged", "small"])
def test_split_plan_covers_every_row_once(m, nk):
    n, k = nk
    splits, chunk = port_mm.dw_split_plan(m, n, k)
    assert chunk % port_mm.BWD_DEPTH == 0 and chunk > 0
    assert 1 <= splits <= port_mm.MAX_SPLITS
    assert splits == -(-m // chunk)
    covered = np.zeros(m, np.int64)
    for lo, hi in _chunks(m, splits, chunk):
        assert hi > lo, "an empty chunk"
        covered[lo:hi] += 1
    assert (covered == 1).all()


def test_split_plan_fills_the_card_at_the_ffn_shape():
    """At M = 30720, K = 768, N = 3072 the unsplit grid is 72 CTAs of
    128 x 256 on 132 SMs: the plan splits M."""
    splits, chunk = port_mm.dw_split_plan(30720, 3072, 768)
    assert splits > 1
    assert port_mm.dw_split_plan(30720, 3072, 768, sms=8) == (1, 30720)


def _operands(seed, mkn):
    rng = np.random.default_rng(seed)
    m, k, n = mkn
    x = (rng.standard_normal((m, k)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    g = (rng.standard_normal((m, n)) * 0.01).astype(np.float32)
    return x, w, b, g


def _jax_dw_db(x, w, b, g, act, approx):
    """dW ``[K, N]`` and dbias from the JAX kernels' custom VJP,
    interpret mode, 128 blocks."""
    def f(x, w, b):
        return jax_mm.matmul_bias_act(
            x, w, b, activation=act, approximate=approx, interpret=True,
            block_m=128, block_n=128, block_k=128)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(b))
    _, dw, db = vjp(jnp.asarray(g, out.dtype))
    return np.asarray(dw), np.asarray(db)


def _split_merge_dw(x, g, res, act, approx, splits, chunk):
    """The dW kernel's arithmetic in plain PyTorch: per chunk of M the
    f32 partials dZᵀ x and Σ dZ, then their sums in chunk order."""
    dz = port_mm._dz_reference(g, res, act, approx)
    dw = db = None
    for lo, hi in _chunks(x.shape[0], splits, chunk):
        pw, pb = dz[lo:hi].t() @ x[lo:hi], dz[lo:hi].sum(dim=0)
        dw, db = (pw, pb) if dw is None else (dw + pw, db + pb)
    return dw, db


@pytest.mark.parametrize("act,approx", ACTS,
                         ids=["none", "relu", "tanh", "gelu", "gelu_tanh"])
def test_split_merge_matches_the_pallas_dw_and_dbias(act, approx):
    m, k, n = SPLIT_MKN
    splits, chunk = port_mm.dw_split_plan(m, n, k)
    assert splits > 1 and m % chunk, "the shape must split, raggedly"
    x, w, b, g = _operands(5, SPLIT_MKN)
    xt, wt, bt, gt = (torch.from_numpy(a) for a in (x, w, b, g))
    y, z = port_mm.matmul_bias_act_reference(xt, wt, bt, act, approx,
                                             emit_z=True)
    kind = port_mm._residual_kind(act)
    res = z if kind == "z" else (y if kind == "y" else None)
    dw, db = _split_merge_dw(xt, gt, res, act, approx, splits, chunk)
    want_dw, want_db = _jax_dw_db(x, w, b, g, act, approx)
    # the port's dW is [N, K]: the transpose of the reference's
    np.testing.assert_allclose(dw.numpy(), want_dw.T, **GRAD_TOL,
                               err_msg="dw")
    np.testing.assert_allclose(db.numpy(), want_db, **GRAD_TOL,
                               err_msg="dbias")


def _misaligned(rows, cols, dtype):
    """A contiguous [rows, cols] view whose storage offset leaves its
    base 2 or 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(rows * cols + 8, dtype=dtype)
    view = flat[1:1 + rows * cols].view(rows, cols)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wrappers_raise_on_a_misaligned_storage_offset(dtype):
    m, k, n = 16, 8, 24
    x, w = torch.zeros(m, k, dtype=dtype), torch.zeros(n, k, dtype=dtype)
    g = torch.zeros(m, n, dtype=dtype)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.matmul_bwd_dx(_misaligned(m, n, dtype), None, w)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.matmul_bwd_dx(g, None, _misaligned(n, k, dtype))
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.matmul_bwd_dw(_misaligned(m, k, dtype), g, None)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.matmul_bwd_dw(x, g, _misaligned(m, n, dtype), "relu")


def test_cpu_calls_of_the_backward_wrappers_launch_nothing():
    ops.reset_launch_counts()
    x, w, b, g = (torch.from_numpy(a) for a in _operands(6, (64, 16, 24)))
    y, _ = port_mm.matmul_bias_act_reference(x, w, b, "relu")
    dx = ops.matmul_bwd_dx(g, y, w, "relu")
    dw, db = ops.matmul_bwd_dw(x, g, y, "relu", bias=b)
    want = port_mm.matmul_bias_act_bwd_reference(x, w, b, y, g, "relu")
    for got, ref in zip((dx, dw, db), want):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    counts = ops.launch_counts()
    assert (counts["matmul_bwd_dx"], counts["matmul_bwd_dw"]) == (0, 0)
