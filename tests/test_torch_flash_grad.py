"""The flash op's forward, LSE and gradients in `paddle_tpu_torch` held
against the JAX package's Pallas kernels run in interpret mode on the
CPU, on the same numpy inputs made from a seed.

On the CPU the port's `torch.autograd.Function` runs through the plain
versions of its kernels (`flash_attention_reference` for the forward
and its LSE, `flash_attention_bwd_reference` for the backward from that
LSE), so these tests exercise the residual plumbing the card uses.  The
JAX side: S=128 runs its fused single-block backward, S=256 with
``block_q=block_k=128`` its dQ + dK/dV pair.

Tolerances (f32): forward and LSE atol 1e-5, gradients atol 1e-4 (rtol
1e-5 / 1e-4): both sides compute in f32 and sum in another order, and a
gradient sums over every row of a column.  bf16: forward 2e-2,
gradients 5e-2, the repo's ``PADDLE_TPU_FLASH_ACC`` policy.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import attention as jax_flash
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import attention as port_attention

B, H, D = 2, 2, 64
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_FWD_TOL = dict(atol=2e-2, rtol=2e-2)
BF16_GRAD_TOL = dict(atol=5e-2, rtol=5e-2)


def _case(seed, s, layout, bias, segs):
    """q, k, v, dO in ``layout``; a [B, 1, 1, S] -1e4 padding bias on
    row 0's last quarter of keys; segment ids packing row 1 into two
    segments with query 3 matching no key (a dead row)."""
    rng = np.random.default_rng(seed)
    shape = (B, s, H, D) if layout == "BSHD" else (B, H, s, D)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    b = None
    if bias:
        b = np.zeros((B, 1, 1, s), np.float32)
        b[0, :, :, s - s // 4:] = -1e4
        b[1, :, :, :3] = rng.standard_normal(3).astype(np.float32)
    seg = None
    if segs:
        kseg = np.zeros((B, s), np.int32)
        kseg[1, s // 2:] = 1
        qseg = kseg.copy()
        qseg[1, 3] = 7
        seg = (qseg, kseg)
    return q, k, v, do, b, seg


def _jax_call(q, k, v, b, seg, causal, layout, block=None, dtype=None):
    cast = (lambda a: jnp.asarray(a, dtype)) if dtype else jnp.asarray
    jseg = None if seg is None else tuple(jnp.asarray(x) for x in seg)
    return jax_flash.flash_attention(
        cast(q), cast(k), cast(v), bias=None if b is None else jnp.asarray(b),
        segment_ids=jseg, causal=causal, layout=layout, interpret=True,
        block_q=block, block_k=block)


def _jax_grads(q, k, v, do, b, seg, causal, layout, block=None):
    def f(q, k, v, b):
        return jnp.sum(jax_flash.flash_attention(
            q, k, v, bias=b,
            segment_ids=None if seg is None else tuple(
                jnp.asarray(x) for x in seg),
            causal=causal, layout=layout, interpret=True, block_q=block,
            block_k=block) * jnp.asarray(do))

    argnums = (0, 1, 2, 3) if b is not None else (0, 1, 2)
    args = [jnp.asarray(x) for x in (q, k, v)] + [
        None if b is None else jnp.asarray(b)]
    return jax.grad(f, argnums=argnums)(*args)


def _port_grads(q, k, v, do, b, seg, causal, layout, dtype=torch.float32):
    tq, tk, tv = (torch.tensor(x, dtype=dtype, requires_grad=True)
                  for x in (q, k, v))
    tb = None if b is None else torch.tensor(b, requires_grad=True)
    tseg = None if seg is None else tuple(torch.tensor(x) for x in seg)
    before = ops.launch_counts()
    out = ops.flash_attention(tq, tk, tv, bias=tb, segment_ids=tseg,
                              causal=causal, layout=layout)
    (out.float() * torch.tensor(do)).sum().backward()
    assert ops.launch_counts() == before        # CPU: no kernel launched
    grads = [tq.grad, tk.grad, tv.grad] + ([tb.grad] if tb is not None
                                           else [])
    return out, grads


# ---------------------------------------------------------------------------
# forward and LSE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("bias,segs,causal", [
    (True, False, False), (False, True, True), (True, True, False)])
def test_forward_and_lse_match_jax_kernel(layout, bias, segs, causal):
    """o against the public kernel; the LSE against the kernel's own
    residual (`_fwd` at two 128-row blocks, where it emits the LSE)."""
    s = 256
    q, k, v, _, b, seg = _case(11, s, layout, bias, segs)
    want = _jax_call(q, k, v, b, seg, causal, layout)
    got, lse = ops.flash_attention_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        bias=None if b is None else torch.tensor(b),
        segment_ids=None if seg is None else tuple(map(torch.tensor, seg)),
        causal=causal, layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)

    flat = (lambda a: a.reshape(B * H, s, D)) if layout == "BHSD" else \
        (lambda a: a)
    jb = None if b is None else jnp.broadcast_to(
        jnp.asarray(b), (B, H, 1, s)).reshape(B * H, 1, s)
    jqs = jks = None
    if seg is not None:
        jqs = jnp.broadcast_to(jnp.asarray(seg[0])[:, :, None], (B, s, 128))
        jks = jnp.broadcast_to(jnp.asarray(seg[1])[:, None, :], (B, 8, s))
    _, want_lse = jax_flash._fwd(
        flat(jnp.asarray(q)), flat(jnp.asarray(k)), flat(jnp.asarray(v)),
        jb, jqs, jks, H, D ** -0.5, causal, True, 0, layout, 128, 128)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :, 0],
                               **FWD_TOL)


# ---------------------------------------------------------------------------
# gradients through the autograd.Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,block", [(128, None), (256, 128)])
@pytest.mark.parametrize("layout", ["BSHD", "BHSD"])
@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_fused_and_pair(s, block, layout, causal):
    """S=128: JAX's fused single-block backward; S=256 at 128-row
    blocks: its dQ + dK/dV pair.  Bias (with its gradient) and segment
    ids with a dead row, in both."""
    q, k, v, do, b, seg = _case(s + causal, s, layout, True, True)
    out, got = _port_grads(q, k, v, do, b, seg, causal, layout)
    want_out = _jax_call(q, k, v, b, seg, causal, layout, block)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **FWD_TOL)
    want = _jax_grads(q, k, v, do, b, seg, causal, layout, block)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_dead_row_gets_zero_gradients_and_no_nan():
    q, k, v, do, b, seg = _case(3, 128, "BSHD", False, True)
    out, (dq, dk, dv) = _port_grads(q, k, v, do, None, seg, False, "BSHD")
    for t in (out.detach(), dq, dk, dv):
        assert torch.isfinite(t).all()
    assert not out[1, 3].any() and not dq[1, 3].any()
    _, lse = ops.flash_attention_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        segment_ids=tuple(map(torch.tensor, seg)))
    assert (lse.view(B, H, 128)[1, :, 3] == port_attention.NEG_INF).all()
    jdq = _jax_grads(q, k, v, do, None, seg, False, "BSHD")[0]
    assert not np.asarray(jdq)[1, 3].any()


def test_bf16_matches_jax_at_the_bf16_policy():
    q, k, v, do, b, seg = _case(5, 128, "BSHD", True, False)
    out, got = _port_grads(q, k, v, do, b, None, True, "BSHD",
                           dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    want_out = _jax_call(q, k, v, b, None, True, "BSHD", dtype=jnp.bfloat16)
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(want_out, np.float32),
                               **BF16_FWD_TOL)

    def f(q, k, v, b):
        o = jax_flash.flash_attention(q, k, v, bias=b, causal=True,
                                      layout="BSHD", interpret=True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(b))
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   **BF16_GRAD_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# the kernel wrappers' plain paths and the backward dispatch
# ---------------------------------------------------------------------------


def test_wrappers_agree_with_the_reference_on_cpu():
    q, k, v, do, b, seg = (torch.tensor(x) if isinstance(x, np.ndarray)
                           else x for x in _case(9, 64, "BSHD", True, False))
    o, lse = ops.flash_fwd(q, k, v, bias=b, with_lse=True)
    dq, delta = ops.flash_bwd_dq(q, k, v, o, do, lse, bias=b)
    dk, dv, db = ops.flash_bwd_dkv(q, k, v, o, do, lse, delta, bias=b,
                                   bias_grad=True)
    fused = ops.flash_bwd_fused(q, k, v, o, do, lse, bias=b, bias_grad=True)
    want = ops.flash_attention_bwd_reference(q, k, v, b, None, o, do, lse)
    for got in ((dq, dk, dv, db), fused):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)
    torch.testing.assert_close(
        delta, (do * o).sum(-1).transpose(1, 2).reshape(B * H, 64))
    assert ops.flash_bwd_dkv(q, k, v, o, do, lse, delta)[2] is None


def test_backward_dispatch_rule_and_knob(monkeypatch):
    """bf16: both schedules run on the tensor cores, and the rule counts
    waves and tile steps with constants fitted to chip times on the H100
    (`FUSED_WAVE_BF16`, `PAIR_WAVE_BF16`, `PAIR_MIN_BF16`).  There the
    pair was the faster at B=1-4 and 12-16 for S=448 and 512 (H=12: the
    fused kernel's one CTA a head leaves its last wave mostly empty), the
    fused kernel at B=10-11 and 22-60 there, at every B for S=128 and at
    B<=4 for S=256 (where the host's time for the pair's two launches
    sets it); chip_smoke.py's bwd_crossover cases are among these, and
    there the rule must pick the faster."""
    use = functools.partial(port_attention._use_fused_bwd, sms=132,
                            dtype=torch.bfloat16)
    for bh, s in ((120, 512), (132, 512), (264, 512), (720, 512),
                  (120, 448), (132, 448), (264, 448), (720, 448),
                  (24, 128), (720, 128), (12, 256), (48, 256)):
        assert use(bh, s, s, 64), (bh, s)
    for bh, s in ((12, 512), (24, 512), (144, 512), (192, 512),
                  (12, 448), (24, 448), (144, 448)):
        assert not use(bh, s, s, 64), (bh, s)
    assert not use(720, 513, 512, 64) and not use(720, 512, 1024, 64)
    assert not use(720, 128, 128, 128)      # the fused kernel is D=64 only
    monkeypatch.setenv("PADDLE_TPU_FLASH_FUSED_BWD", "0")
    assert not use(720, 512, 512, 64)


def test_backward_dispatch_rule_keeps_f32_choices(monkeypatch):
    """f32: both kernels on FMA, the rule as before the bf16 fused kernel
    moved to the tensor cores."""
    use = functools.partial(port_attention._use_fused_bwd, sms=132,
                            dtype=torch.float32)
    # S=512 on 132 SMs: the fused kernel where its waves are full
    for bh in (120, 132, 264, 720):
        assert use(bh, 512, 512, 64), bh
    for bh in (24, 144):                    # a mostly empty last wave
        assert not use(bh, 512, 512, 64), bh
    assert use(720, 128, 128, 64) and not use(24, 128, 128, 64)
    assert not use(720, 513, 512, 64) and not use(720, 512, 1024, 64)
    assert not use(720, 128, 128, 128)
    monkeypatch.setenv("PADDLE_TPU_FLASH_FUSED_BWD", "0")
    assert not use(720, 512, 512, 64)


def test_cpu_backward_runs_the_plain_version_once(monkeypatch):
    """On CPU tensors the op's backward is one plain backward, under
    either schedule."""
    calls = []
    plain = port_attention.flash_attention_bwd_reference
    monkeypatch.setattr(port_attention, "flash_attention_bwd_reference",
                        lambda *a: calls.append(1) or plain(*a))
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _case(9, 64, "BSHD", False, False)[:3])
    for knob in ("1", "0"):
        monkeypatch.setenv("PADDLE_TPU_FLASH_FUSED_BWD", knob)
        ops.flash_attention(q, k, v).sum().backward()
    assert len(calls) == 2


def test_no_grad_call_skips_the_lse_and_the_function():
    x = torch.zeros(1, 8, H, D, requires_grad=True)
    with torch.no_grad():
        out = ops.flash_attention(x, x, x)
    assert out.grad_fn is None
    out = ops.flash_attention(x, x, x)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"


def test_backward_row_statistics_are_validated():
    """The kernels read lse / delta through raw pointers: a wrong shape,
    dtype or layout is refused before any launch."""
    check = port_attention._check_rows
    dev = torch.device("cpu")
    check(dev, 4, 8, lse=torch.zeros(4, 8), delta=torch.zeros(4, 8))
    for bad in (torch.zeros(4, 7), torch.zeros(8, 4).t(),
                torch.zeros(4, 8, dtype=torch.float64)):
        with pytest.raises(ValueError, match="lse"):
            check(dev, 4, 8, lse=bad)


# ---------------------------------------------------------------------------
# chip_smoke.py's bf16 limit
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bf16_limit_fails_a_scale_error_the_policy_passes():
    """chip_smoke holds a bf16 kernel against the f32 plain version
    within twice the output's rounding: the rounded f32 gradients use
    about half of that limit, while 2% too large a dQ fails it (the
    PADDLE_TPU_FLASH_ACC policy, 5e-2, lets it through)."""
    smoke = _chip_smoke()
    q, k, v, do = (torch.tensor(x).to(torch.bfloat16)
                   for x in _case(21, 256, "BSHD", False, False)[:4])
    o, lse = ops.flash_attention_reference(q, k, v)
    ref32 = ops.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), None, None, o.float(), do.float(),
        lse)[0]
    ref_bf16 = ops.flash_attention_bwd_reference(q, k, v, None, None, o, do,
                                                 lse)[0]
    tol = smoke.GRAD_TOL[torch.bfloat16]
    _, share = smoke.compare("dq", ref32.to(torch.bfloat16), ref32, tol)
    assert 0.4 < share <= 0.5
    wrong = (ref32 * 1.02).to(torch.bfloat16)
    torch.testing.assert_close(wrong.float(), ref_bf16.float(),
                               **BF16_GRAD_TOL)
    with pytest.raises(AssertionError, match="of its limit"):
        smoke.compare("dq", wrong, ref32, tol)
