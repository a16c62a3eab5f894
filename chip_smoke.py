#!/usr/bin/env python3
"""Chip smoke of paddle_tpu_torch: builds the CUDA kernels and holds
each against its plain PyTorch version (the flash forward and its three
backward kernels over f32/bf16, S in {128, 512, 1024}, causal or not,
with a padding bias and segment ids that leave a dead row, and at the
training step's own shape, the fused backward and the dQ + dK/dV pair
each launched twice for bitwise-equal gradients; the bf16 forward at
head dim 128 too, and the pair at head dim 128 over f32/bf16, S in
{512, 1024}; the decode kernels at serving shapes; the
fused-epilogue GEMM forward, dX and dW + dbias over f32/bf16, five
activations, bias or not, z emitted or not, a ragged shape, M = 1 and
63, a bf16 shape whose M splits raggedly, and the BERT FFN's own shape,
each backward launched twice for bitwise-equal outputs); times the fused against the pair backward over
B*H around the SM count; runs full-width BERT-base once on the card and
on the CPU with the same weights, with the default FFN and with
PADDLE_TPU_FUSED_FFN=1; trains it as `bench.py`'s flagship step does
(B=60, S=512, bf16, ShardedTrainStep + AdamW), fused and pair flash
backward and the fused-epilogue FFN, with a profile of one step of each
FFN; then serves a full-width TransformerLM through the paged generation
engine and checks the streams against the port's sequential oracle and
the dense engine; last, holds the 1x1 conv + BN + relu kernel against
its plain version (f32/bf16, the Pallas experiment's shape, ResNet-50's
eight conv0 shapes at B=128 and a ragged one; in bf16 every tile width
at the ragged shape, an M below one tile and a shape with fewer tiles
than SMs, and y bitwise equal over two launches and between one CTA an
SM and one CTA a tile) and times it there,
checks full-width ResNet-50 eval on the card against the CPU, and
serves B=128 224x224 batches through it in f32 and bf16 (16 kernel
launches a forward), with a profile of one forward of each; then holds
the 1x1 conv + BN-statistics kernel against its plain version (f32/bf16,
the experiment's shape, the twelve shapes of the ResNet-50 train step at
B=128, a ragged one and a column whose mean is ~90 times its std, each
launched twice for bitwise-equal statistics; in bf16 the same width and
grid cases as kernel 10, y and the statistics bitwise) and times it
there over a step's 33 launches; runs the eval model under grad through kernel 10
against its plain version; checks one f32 Momentum step of full-width
ResNet-50 (B=4, 64x64) on the card against the CPU and against kernel
11's plain version; and trains ResNet-50 as `bench.py:_bench_resnet`
does (B=128, 224x224, bf16, ShardedTrainStep + Momentum(0.1, 0.9), 33
kernel-11 launches a step), with a profile of one step.

    python3 chip_smoke.py

Needs one CUDA device (exits non-zero without one, printing no
result).  Imports neither JAX nor `paddle_tpu`.  Every phase prints one
JSON line; then a ``{"kernels": [...]}`` line, the card's name and
power limit as nvidia-smi reports them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises and exits
non-zero before that line.

Float32 products run in full f32 (TF32 off for matmul and cuDNN).
Tolerances: each kernel is held against its plain version run in f32
on the same inputs (bf16 inputs upcast exactly).  f32 kernels: atol
1e-5 / rtol 1e-4 (the sums run in another order), gradients 1e-4.  bf16
flash kernels compute in f32 (the tensor-core forward and fused
backward take each operand they form, P and dS, as two bf16 halves,
flash_tc.cuh; the pair likewise) and round each output once, so an
output is off by little more than half a bf16 ulp, 2^-8 of its value:
the limit is rtol 2^-7 (that bound doubled) plus atol 1e-5, far inside
the repo's PADDLE_TPU_FLASH_ACC policy (2e-2 / 5e-2), which at S=512
is as large as the gradients themselves.  Two bf16 kernels against each other
(fused vs pair): rtol 2^-6.  The GEMM kernels: rtol 2^-7 (bf16) or
1e-5 (f32) with an atol set against the output's scale, widened for
the bf16 backward's rounding of dZ (`gemm_tol`).  Kernel 11's mean and
variance: within 1e-5 (f32) or 5e-5 (bf16) of (|mean| + std) and of the
variance, against float64 sums of the f32 product (STATS_RTOL), and its
cancellation case must put the one-pass form Σy²/M − μ² outside those
limits, so that they would catch it.  Dense vs
paged decode bitwise; the model checks state theirs beside them (the
ResNet gradient checks on one run's relu decisions, `_relu_decisions`).
Bounds: the larger of bytes / 3.35 TB/s and flops / peak, with the
H100 SXM data-sheet peaks: 67 TFLOP/s f32 (the f32 kernels use FMA),
989 TFLOP/s bf16 (the bf16 kernels' tensor cores).
"""

import ctypes
import json
import os
import subprocess
import sys
import time
from unittest.mock import patch

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
BF16_ROUND = 2.0 ** -8      # half a bf16 ulp, relative to the value
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-5, rtol=2 * BF16_ROUND)}
GRAD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=1e-5, rtol=2 * BF16_ROUND)}
PAIR_TOL = {torch.float32: GRAD_TOL[torch.float32],
            torch.bfloat16: dict(atol=1e-5, rtol=4 * BF16_ROUND)}
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
NEG_INF = -1e30
H, D = 12, 64
TRAIN_B, TRAIN_S, TRAIN_P = 60, 512, 80


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def queued_ms(fn, iters=20, warmup=3):
    """The card's time for one call of ``fn``: the timed calls queue
    behind a sleep kernel long enough for the host to enqueue them all,
    so the card runs them back to back.  Back-to-back CUDA events around
    a wrapper whose kernel is shorter than its host work (the decode
    kernels) read the host's enqueue rate instead (`time_ms`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t        # one call, host and card
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(0.2, 2 * iters * host_s + 1e-3) * 2e9))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want, tol):
    """Raises unless |got - want| <= atol + rtol |want| everywhere (and
    both are finite).  Returns (max |got - want|, the largest share of
    its limit any element uses)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    share = (diff / (tol["atol"] + tol["rtol"] * want.abs())).max().item()
    err = diff.max().item()
    if not (share <= 1.0 and torch.isfinite(got).all()):
        raise AssertionError("%s: max |err| %g, %.3g of its limit (atol %g, "
                             "rtol %g)" % (name, err, share,
                                           torch.as_tensor(tol["atol"]).max(),
                                           tol["rtol"]))
    return err, share


def upcast(*ts):
    return [None if t is None else t.float() for t in ts]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(ops):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    cases = [(s, dt, False) for dt in (torch.float32, torch.bfloat16)
             for s in (8, 200, 512, 1024)]
    # QKV column slices (row stride 3 H D), as BERT passes them
    cases += [(1024, torch.float32, True), (512, torch.bfloat16, True)]
    for s, dt, strided in cases:
        if strided:
            qkv = torch.randn(1, s, 3 * H * D, device="cuda",
                              generator=gen).to(dt)
            q, k, v = (t.view(1, s, H, D) for t in qkv.split(H * D, dim=2))
        else:
            q, k, v = (torch.randn(1, s, H, D, device="cuda", generator=gen,
                                   dtype=torch.float32).to(dt)
                       for _ in range(3))
        scale = D ** -0.5
        out = ops.flash_attention(q, k, v, scale=scale, causal=True)
        plain = lambda: ops.flash_attention_reference(  # noqa: E731
            q, k, v, scale=scale, causal=True)[0]
        want = ops.flash_attention_reference(*upcast(q, k, v), scale=scale,
                                             causal=True)[0]
        torch.cuda.synchronize()
        err, share = compare("flash S=%d %s" % (s, dt), out, want, TOL[dt])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        elt = q.element_size()
        nbytes = 4 * s * H * D * elt
        flops = 4 * H * D * s * (s + 1) // 2
        bms, by = bound(nbytes, flops, dt)
        rows.append({
            "S": s, "dtype": str(dt).replace("torch.", ""),
            "strided_qkv": strided, "max_abs_err": err, "limit_share": share,
            "ms": time_ms(lambda: ops.flash_attention(q, k, v, scale=scale,
                                                      causal=True)),
            "plain_ms": time_ms(plain),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale)),
            "bound_ms": bms, "bound_by": by})
    emit({"phase": "kernel_check", "kernel": "flash_fwd", "B": 1, "H": H,
          "D": D, "causal": True, "cases": rows})
    return rows


def check_flash_d128(ops):
    """The bf16 forward at head dim 128 (its own wgmma path: m64n128 for
    P V, two 64-column chunks a tile) at B=2, H=12: S = 200 and 512,
    causal and not, and S=512 masked (padding bias + segment ids with a
    dead row); o and lse against the f32 plain version, timed beside
    SDPA."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(7)
    d, b = 128, 2
    rows = []
    cases = [(s, causal, False) for s in (200, 512) for causal in (False,
                                                                    True)]
    cases.append((512, False, True))
    for s, causal, masked in cases:
        q, k, v = (torch.randn(b, s, H, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        bias = segs = None
        if masked:
            bias = torch.zeros(b, 1, 1, s, device="cuda")
            bias[0, :, :, s - s // 4:] = -1e4
            kseg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
            kseg[1, s // 2:] = 1
            qseg = kseg.clone()
            qseg[1, 3] = 7
            segs = (qseg, kseg)
        kw = dict(bias=bias, segment_ids=segs, scale=d ** -0.5,
                  causal=causal)
        name = "D=128 S=%d causal=%s masked=%s" % (s, causal, masked)
        o, lse = ops.flash_fwd(q, k, v, with_lse=True, **kw)
        o_ref, lse_ref = ops.flash_attention_reference(*upcast(q, k, v),
                                                       **kw)
        torch.cuda.synchronize()
        err, share = compare(name + " o", o, o_ref, TOL[torch.bfloat16])
        lse_err, lse_share = compare(name + " lse", lse, lse_ref, LSE_TOL)
        if masked and (o[1, 3].abs().max().item() or
                       (lse.view(b, H, s)[1, :, 3] != NEG_INF).any()):
            raise AssertionError("%s: the dead row is not dead" % name)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        nbytes = 4 * b * s * H * d * 2 + b * H * s * 4
        bms, by = bound(nbytes, 4 * b * H * _visible_pairs(s, s, causal) * d,
                        torch.bfloat16)
        rows.append({
            "S": s, "causal": causal, "masked": masked, "max_abs_err": err,
            "limit_share": share, "lse_max_abs_err": lse_err,
            "lse_limit_share": lse_share,
            "ms": time_ms(lambda: ops.flash_fwd(q, k, v, with_lse=True,
                                                **kw)),
            "plain_ms": time_ms(lambda: ops.flash_attention_reference(
                q, k, v, **kw), iters=5, warmup=1),
            "library_ms": None if masked else time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=d ** -0.5)),
            "bound_ms": bms, "bound_by": by})
    emit({"phase": "kernel_check", "kernel": "flash_fwd_d128", "B": b,
          "H": H, "D": d, "dtype": "bfloat16", "cases": rows})
    return rows


def _visible_pairs(sq, sk, causal):
    """(query, key) pairs a head computes: all, or the bottom-right
    causal triangle (row i sees keys j <= i + Sk - Sq)."""
    if not causal:
        return sq * sk
    return sum(max(0, min(sk, i + sk - sq + 1)) for i in range(sq))


def flash_bounds(b, s, dtype, causal, masked, d=D):
    """{kernel: (bound_ms, bound_by)} of the four flash kernels at
    [b, s, H, d]: each input read once and each output written once over
    3.35 TB/s, against the products the function needs (forward 2: QK^T
    and PV; dQ 3: S, dP, dS K; dK/dV 4: S, dP, P^T dO, dS^T Q; fused 5)
    of 2 flops per visible (query, key, d) over the dtype's peak."""
    elt = torch.tensor([], dtype=dtype).element_size()
    x = b * s * H * d * elt                 # one q/k/v/o/do-sized tensor
    row = b * H * s * 4                     # lse or delta, f32
    mask = (b * s * 4 + 2 * b * s * 4) if masked else 0   # bias, segs
    dbias = b * H * s * 4 if masked else 0
    pairs = b * H * _visible_pairs(s, s, causal) * d
    return {
        "flash_fwd": bound(4 * x + row + mask, 4 * pairs, dtype),
        "flash_bwd_dq": bound(6 * x + 2 * row + mask, 6 * pairs, dtype),
        "flash_bwd_dkv": bound(6 * x + 2 * row + mask + dbias, 8 * pairs,
                               dtype),
        "flash_bwd_fused": bound(8 * x + row + mask + dbias, 10 * pairs,
                                 dtype),
    }


def _library_attention(q, k, v, do, bias, segs, causal, scale):
    """F.scaled_dot_product_attention's forward, backward alone (on a
    retained graph) and forward+backward at the same shapes, with the
    bias and masks as one float mask: the yardstick, timed only."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    mask = None
    if bias is not None or segs is not None:
        b, s = q.shape[0], q.shape[1]
        mask = torch.zeros(b, 1, s, s, device=q.device)
        if bias is not None:
            mask = mask + bias
        if segs is not None:
            same = segs[0][:, None, :, None] == segs[1][:, None, None, :]
            mask = torch.where(same, mask, -1e30)
        if causal:
            vis = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
            mask = torch.where(vis, mask, -1e30)
        mask = mask.to(q.dtype)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                scale=scale)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            scale=scale)
        return torch.autograd.grad(out, (qt, kt, vt), dot)

    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        scale=scale)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                 retain_graph=True))
    return time_ms(fwd), bwd_ms, time_ms(fwd_bwd)


def flash_train_case(ops, gen, b, s, dt, causal, masked, d=D):
    """One shape of the training kernels against their plain versions:
    the forward with its LSE, the dQ + dK/dV pair (its delta too,
    launched twice for bitwise-equal outputs) and (where it fits: D = 64,
    S <= 512) the fused backward, each held against the plain version on
    the same inputs, the fused held against the pair; then every one
    timed.  ``masked``: row 0 pads its last quarter of keys with a -1e4
    bias (which needs a gradient), row 1 packs two segments, and its
    query 3 has a segment id no key has: a dead row."""
    q, k, v, do = (torch.randn(b, s, H, d, device="cuda", generator=gen)
                   .to(dt) for _ in range(4))
    bias = segs = None
    if masked:
        bias = torch.zeros(b, 1, 1, s, device="cuda")
        bias[0, :, :, s - s // 4:] = -1e4
        kseg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        kseg[1, s // 2:] = 1
        qseg = kseg.clone()
        qseg[1, 3] = 7
        segs = (qseg, kseg)
    scale = d ** -0.5
    kw = dict(bias=bias, segment_ids=segs, scale=scale, causal=causal)
    name = "D=%d S=%d %s causal=%s masked=%s" % (
        d, s, str(dt).replace("torch.", ""), causal, masked)

    errs, shares = {}, {}

    def check(tag, got, want, tol):
        errs[tag], shares[tag] = compare("%s %s" % (name, tag), got, want,
                                         tol)

    o, lse = ops.flash_fwd(q, k, v, with_lse=True, **kw)
    o_ref, lse_ref = ops.flash_attention_reference(*upcast(q, k, v), **kw)
    torch.cuda.synchronize()
    check("o", o, o_ref, TOL[dt])
    check("lse", lse, lse_ref, LSE_TOL)
    # the f32 plain backward from the kernel's own o and lse
    want = ops.flash_attention_bwd_reference(
        *upcast(q, k, v), bias, segs, o.float(), do.float(), lse, scale,
        causal)
    dq, delta = ops.flash_bwd_dq(q, k, v, o, do, lse, **kw)
    dk, dv, db = ops.flash_bwd_dkv(q, k, v, o, do, lse, delta,
                                   bias_grad=masked, **kw)
    pair = (dq, dk, dv, db)
    dq2, delta2 = ops.flash_bwd_dq(q, k, v, o, do, lse, **kw)
    again = (dq2,) + ops.flash_bwd_dkv(q, k, v, o, do, lse, delta,
                                       bias_grad=masked, **kw)
    torch.cuda.synchronize()
    for tag, got, ref in zip(("dq", "dk", "dv", "dbias"), pair, want):
        if got is not None:
            check("pair_" + tag, got, ref, GRAD_TOL[dt])
    check("pair_delta", delta, (do.float() * o.float()).sum(-1)
          .transpose(1, 2).reshape(b * H, s), TOL[torch.float32])
    pair_bitwise = torch.equal(delta, delta2) and all(
        a is None or torch.equal(a, b_) for a, b_ in zip(pair, again))
    if not pair_bitwise:
        raise AssertionError("%s: two launches of the pair differ" % name)
    fits = s <= 512 and d == 64
    if fits:
        fused = ops.flash_bwd_fused(q, k, v, o, do, lse, bias_grad=masked,
                                    **kw)
        again = ops.flash_bwd_fused(q, k, v, o, do, lse, bias_grad=masked,
                                    **kw)
        torch.cuda.synchronize()
        bitwise = all(a is None or torch.equal(a, b_)
                      for a, b_ in zip(fused, again))
        if not bitwise:
            raise AssertionError("%s: two launches of the fused backward "
                                 "differ" % name)
        for tag, got, ref, other in zip(("dq", "dk", "dv", "dbias"), fused,
                                        want, pair):
            if got is not None:
                check("fused_" + tag, got, ref, GRAD_TOL[dt])
                check("fused_vs_pair_" + tag, got, other, PAIR_TOL[dt])
    if masked:
        dead = [o[1, 3].abs().max().item(), dq[1, 3].abs().max().item()]
        if any(dead) or (lse.view(b, H, s)[1, :, 3] != NEG_INF).any():
            raise AssertionError("%s: the dead row is not dead: |o|, |dq| "
                                 "= %s" % (name, dead))

    lib_fwd, lib_bwd, lib_fwd_bwd = _library_attention(
        q, k, v, do, bias, segs, causal, scale)
    row = {
        "B": b, "S": s, "dtype": str(dt).replace("torch.", ""),
        "causal": causal, "masked": masked, "max_abs_err": errs,
        "D": d, "limit_share": shares, "pair_bitwise": pair_bitwise,
        "fused_bitwise": bitwise if fits else None,
        "fwd_ms": time_ms(lambda: ops.flash_fwd(q, k, v, with_lse=True,
                                                **kw)),
        "dq_ms": time_ms(lambda: ops.flash_bwd_dq(q, k, v, o, do, lse, **kw)),
        "dkv_ms": time_ms(lambda: ops.flash_bwd_dkv(
            q, k, v, o, do, lse, delta, bias_grad=masked, **kw)),
        "fused_ms": (time_ms(lambda: ops.flash_bwd_fused(
            q, k, v, o, do, lse, bias_grad=masked, **kw)) if fits else None),
        "plain_fwd_ms": time_ms(lambda: ops.flash_attention_reference(
            q, k, v, **kw), iters=5, warmup=1),
        "plain_bwd_ms": time_ms(lambda: ops.flash_attention_bwd_reference(
            q, k, v, bias, segs, o, do, lse, scale, causal),
            iters=5, warmup=1),
        "library_fwd_ms": lib_fwd, "library_bwd_ms": lib_bwd,
        "library_fwd_bwd_ms": lib_fwd_bwd,
        "bounds": flash_bounds(b, s, dt, causal, masked, d)}
    return row


def check_flash_train(ops):
    """The four training kernels at B=2, H=12, D=64 over f32 / bf16,
    S in {128, 512, 1024}, causal and not, masked (bias + segments with
    a dead row); plus the unmasked S=512 shape.  S=1024 runs only the
    pair (the fused kernel takes S <= 512)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for s in (128, 512, 1024):
            for causal in (False, True):
                rows.append(flash_train_case(ops, gen, 2, s, dt, causal,
                                             True))
        rows.append(flash_train_case(ops, gen, 2, 512, dt, False, False))
    emit({"phase": "kernel_check", "kernel": "flash_train", "H": H, "D": D,
          "cases": rows})
    return rows


def check_flash_bwd_d128(ops):
    """The pair at head dim 128 (the fused kernel takes D = 64 only):
    B=2, H=12, S = 512 and 1024, causal and not, masked (bias + segments
    with a dead row), bf16 and f32, through `flash_train_case`."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = [flash_train_case(ops, gen, 2, s, dt, causal, True, d=128)
            for dt in (torch.bfloat16, torch.float32) for s in (512, 1024)
            for causal in (False, True)]
    emit({"phase": "kernel_check", "kernel": "flash_bwd_d128", "H": H,
          "D": 128, "cases": rows})
    return rows


def check_flash_main_shape(ops):
    """The four kernels at the training step's own shape (B=60, S=512,
    bf16, no mask, not causal): errors against the plain versions and
    the times the `kernels` line reports."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    row = flash_train_case(ops, gen, TRAIN_B, TRAIN_S, torch.bfloat16,
                           False, False)
    row["bitwise_with_dbias"] = bitwise_with_dbias(ops, gen)
    emit({"phase": "kernel_check", "kernel": "flash_main_shape", **row})
    return row


def bitwise_with_dbias(ops, gen):
    """Two launches of the fused backward and of each pair kernel at the
    training step's shape with a padding bias that needs a gradient:
    dQ, dK, dV, dbias (and the pair's delta) must be equal bit for bit
    (a fixed order of sums, no atomics).  The unmasked launches are
    compared in `flash_train_case`."""
    b, s = TRAIN_B, TRAIN_S
    q, k, v, do = (torch.randn(b, s, H, D, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    bias = torch.zeros(b, 1, 1, s, device="cuda")
    bias[::2, :, :, s - s // 4:] = -1e4
    o, lse = ops.flash_fwd(q, k, v, bias=bias, with_lse=True)
    kw = dict(bias=bias, bias_grad=True)

    def pair():
        dq, delta = ops.flash_bwd_dq(q, k, v, o, do, lse, bias=bias)
        return (dq, delta) + ops.flash_bwd_dkv(q, k, v, o, do, lse, delta,
                                               **kw)

    same = {}
    for name, run, tags in (
            ("fused", lambda: ops.flash_bwd_fused(q, k, v, o, do, lse, **kw),
             ("dq", "dk", "dv", "dbias")),
            ("pair", pair, ("dq", "delta", "dk", "dv", "dbias"))):
        first, second = run(), run()
        torch.cuda.synchronize()
        same[name] = {tag: torch.equal(a, b_) for tag, a, b_ in
                      zip(tags, first, second)}
    if not all(all(v.values()) for v in same.values()):
        raise AssertionError("flash backward, B=60 S=512 with dbias: two "
                             "launches differ: %s" % same)
    return same


def check_bwd_crossover(ops):
    """Fused against pair backward at S=512, 448 and 128 over B*H from
    one 12-head sequence to past the SM count, bf16, no mask: each one's
    ms and what `_use_fused_bwd` picks, which must be the faster.  Each
    is timed as `flash_attention_bwd` runs it: the fused kernel's
    wrapper, or the pair's two launches from one parameter block
    (`flash_attention_bwd` under PADDLE_TPU_FLASH_FUSED_BWD=0), over
    50 calls: where the host's time for a call exceeds the card's, the
    host's jitter sets the reading.  Times only; the kernels' values are
    checked above."""
    from paddle_tpu_torch.ops.attention import _use_fused_bwd

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for b, s in ((1, 512), (2, 512), (10, 512), (11, 512), (12, 512),
                 (22, 512), (60, 512), (1, 448), (2, 128), (60, 128)):
        q, k, v, do = (torch.randn(b, s, H, D, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = ops.flash_fwd(q, k, v, with_lse=True)

        fused_ms = time_ms(lambda: ops.flash_bwd_fused(q, k, v, o, do, lse),
                           iters=50)
        with _env("PADDLE_TPU_FLASH_FUSED_BWD", "0"):
            pair_ms = time_ms(lambda: ops.flash_attention_bwd(q, k, v, o, do,
                                                              lse), iters=50)
        rule = _use_fused_bwd(b * H, s, s, D, sms, torch.bfloat16)
        faster = "fused" if fused_ms < pair_ms else "pair"
        rows.append({"B": b, "S": s, "BH": b * H, "fused_ms": fused_ms,
                     "pair_ms": pair_ms, "rule": "fused" if rule else "pair",
                     "faster": faster,
                     "rule_costs_ms": max(0.0, (fused_ms if rule else pair_ms)
                                          - min(fused_ms, pair_ms))})
    emit({"phase": "bwd_crossover", "sms": sms, "H": H, "D": D,
          "dtype": "bfloat16", "cases": rows})
    if any(r["rule"] != r["faster"] for r in rows):
        raise AssertionError("the bf16 dispatch rule does not pick the "
                             "faster backward in every case: %s" % rows)
    return rows


# check_decode's serving shape: 8 slots of a 1024-position cache in
# 16-row blocks, these lengths; then one slot of 1024 (where the split
# of the key range matters most), and lengths at the chunk plan's edges
DECODE_T, DECODE_BS = 1024, 16
DECODE_LENGTHS = (0, 1, 17, 1024, 300, 511, 64, 900)


def decode_inputs(ops, gen, lengths_l, d=D, dt=torch.float32, t=DECODE_T,
                  bs=DECODE_BS, stale=False):
    """One decode step's operands: q [N, H, d], K and V pools [N * t / bs
    + 1, bs, H, d] shuffled so that slot n's live blocks are scattered
    pool blocks, tables whose entries past ceil(len / bs) are 0 (the
    garbage block) or, with ``stale``, other slots' live blocks, the
    gathered dense caches and the int32 lengths."""
    n, mb = len(lengths_l), t // bs
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device="cuda")
    q = torch.randn(n, H, d, device="cuda", generator=gen).to(dt)
    nb = n * mb + 1
    k_pool = torch.randn(nb, bs, H, d, device="cuda", generator=gen).to(dt)
    v_pool = torch.randn(nb, bs, H, d, device="cuda", generator=gen).to(dt)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(2))
    tables = torch.zeros(n, mb, dtype=torch.int32)
    used = 0
    for i, ln in enumerate(lengths_l):
        need = -(-ln // bs)
        tables[i, :need] = perm[used:used + need] + 1
        if stale:
            tables[i, need:] = perm[(used + need + torch.arange(mb - need))
                                    % (nb - 1)] + 1
        used += need
    tables = tables.cuda()
    k_dense = ops.paged_gather_kv(k_pool, tables).contiguous()
    v_dense = ops.paged_gather_kv(v_pool, tables).contiguous()
    return q, k_pool, v_pool, tables, k_dense, v_dense, lengths


def decode_bytes(lengths_l, d, dt, bs=DECODE_BS):
    """(bytes, flops) of one decode step: q and the output, each live K
    and V row once, the lengths (the paged kernel adds its live table
    entries: 4 bytes a live block)."""
    elt = torch.finfo(dt).bits // 8
    live = sum(lengths_l)
    nbytes = 2 * len(lengths_l) * H * d * elt + 2 * live * H * d * elt \
        + 4 * len(lengths_l)
    return nbytes, 4 * live * H * d


def decode_case(ops, gen, lengths_l, d=D, dt=torch.float32, stale=False):
    """The dense and paged kernels on one step, each launched twice:
    raises unless the four outputs are bitwise equal, an empty slot
    emits zeros and both lie within TOL of their plain versions (f32,
    on the same inputs upcast).  Returns (error, limit share, operands)."""
    q, k_pool, v_pool, tables, k_dense, v_dense, lengths = decode_inputs(
        ops, gen, lengths_l, d, dt, stale=stale)
    scale = d ** -0.5
    name = "decode N=%d D=%d %s%s" % (len(lengths_l), d,
                                      str(dt).replace("torch.", ""),
                                      " stale" if stale else "")
    outs = [ops.decode_attention(q, k_dense, v_dense, lengths, scale=scale),
            ops.paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                       scale=scale)]
    outs += [ops.decode_attention(q, k_dense, v_dense, lengths, scale=scale),
             ops.paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                        scale=scale)]
    torch.cuda.synchronize()
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError(
            "%s: dense, paged and their second launches differ: max %g"
            % (name, max((outs[0].float() - o.float()).abs().max().item()
                         for o in outs[1:])))
    for i, ln in enumerate(lengths_l):
        if ln == 0 and outs[0][i].abs().max().item() != 0.0:
            raise AssertionError("%s: an empty slot did not emit zeros"
                                 % name)
    qf, kf, vf = upcast(q, k_dense, v_dense)
    want = ops.decode_attention_reference(qf, kf, vf, lengths, scale)
    want_p = ops.paged_decode_attention_reference(
        *upcast(q, k_pool, v_pool), tables, lengths, scale)
    err, share = compare(name, outs[0], want, TOL[dt])
    compare(name + " paged", outs[1], want_p, TOL[dt])
    return err, share, (q, k_pool, v_pool, tables, k_dense, v_dense,
                        lengths, scale)


def check_decode(ops):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.decode_attention import (decode_head_groups,
                                                       decode_split_plan)

    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths_l = list(DECODE_LENGTHS)
    n, t, bs = len(lengths_l), DECODE_T, DECODE_BS
    err, share, ins = decode_case(ops, gen, lengths_l)
    q, k_pool, v_pool, tables, k_dense, v_dense, lengths, scale = ins
    chunk, chunks = decode_split_plan(t)
    plan = {"chunk": chunk, "chunks": chunks, "heads_a_cta":
            decode_head_groups(H)}

    # the split's own cases: one slot of T, bf16, D = 128, and lengths at
    # the plan's edges with stale table entries past them
    edge = [0, 1, bs - 1, chunk - 1, chunk, chunk + 1, t - 1, t]
    cases = [(lengths_l, D, torch.bfloat16, False),
             (lengths_l, 128, torch.float32, False),
             (lengths_l, 128, torch.bfloat16, False),
             (edge, D, torch.float32, True), (edge, 128, torch.bfloat16, True)]
    rows = []
    for ls, d, dt, stale in cases:
        e, sh, _ = decode_case(ops, gen, ls, d, dt, stale)
        rows.append({"lengths": ls, "D": d,
                     "dtype": str(dt).replace("torch.", ""), "stale": stale,
                     "max_abs_err": e, "limit_share": sh})
    _, one_share, one = decode_case(ops, gen, [t])
    q1, kp1, vp1, tb1, kd1, vd1, len1, _ = one

    def paged_ms(*a):
        return queued_ms(lambda: ops.paged_decode_attention(*a, scale=scale))

    def dense_ms(*a):
        return queued_ms(lambda: ops.decode_attention(*a, scale=scale))

    nbytes, flops = decode_bytes(lengths_l, D, torch.float32)
    bms, by = bound(nbytes, flops, torch.float32)
    live_blocks = sum(-(-ln // bs) for ln in lengths_l)
    bms_p, by_p = bound(nbytes + live_blocks * 4, flops, torch.float32)
    nb1, fl1 = decode_bytes([t], D, torch.float32)
    one_bound = bound(nb1 + (t // bs) * 4, fl1, torch.float32)
    mask = (torch.arange(t, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    qs, kt, vt = q[:, :, None], k_dense.transpose(1, 2), v_dense.transpose(1, 2)
    dense_call = lambda: ops.decode_attention(  # noqa: E731
        q, k_dense, v_dense, lengths, scale=scale)
    paged_call = lambda: ops.paged_decode_attention(  # noqa: E731
        q, k_pool, v_pool, tables, lengths, scale=scale)
    dense_plain = lambda: ops.decode_attention_reference(  # noqa: E731
        q, k_dense, v_dense, lengths, scale)
    paged_plain = lambda: ops.paged_decode_attention_reference(  # noqa: E731
        q, k_pool, v_pool, tables, lengths, scale)
    # ms, plain_ms, library_ms: the card's time (`queued_ms`); call_ms:
    # back-to-back calls as a caller issues them, host included;
    # device_ms: the kernel alone, from the profiler
    dense_row = {
        "max_abs_err": err,
        "ms": queued_ms(dense_call),
        "call_ms": time_ms(dense_call),
        "device_ms": device_ms(dense_call, "decode_attention"),
        "plain_ms": queued_ms(dense_plain),
        "library_ms": queued_ms(lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, scale=scale)),
        "bound_ms": bms, "bound_by": by, "plan": plan,
        "one_slot_ms": dense_ms(q1, kd1, vd1, len1)}
    paged_row = {
        "max_abs_err": err,
        "ms": queued_ms(paged_call),
        "call_ms": time_ms(paged_call),
        "device_ms": device_ms(paged_call, "paged_attention"),
        "plain_ms": queued_ms(paged_plain),
        "library_ms": None,
        "bound_ms": bms_p, "bound_by": by_p, "plan": plan,
        "one_slot_ms": paged_ms(q1, kp1, vp1, tb1, len1),
        "one_slot_device_ms": device_ms(lambda: ops.paged_decode_attention(
            q1, kp1, vp1, tb1, len1, scale=scale), "paged_attention"),
        "one_slot_bound_ms": one_bound[0]}
    emit({"phase": "kernel_check", "kernel": "decode_attention", "N": n,
          "T": t, "H": H, "D": D, "lengths": lengths_l,
          "limit_share": share, **dense_row})
    emit({"phase": "kernel_check", "kernel": "paged_attention", "N": n,
          "bs": bs, "max_blocks": t // bs, "H": H, "D": D,
          "lengths": lengths_l, "dense_equals_paged_bitwise": True,
          "launches_bitwise": True, "one_slot_limit_share": one_share,
          "cases": rows, **paged_row})
    return dense_row, paged_row


# ---------------------------------------------------------------------------
# the fused-epilogue GEMM kernels
# ---------------------------------------------------------------------------

MM_ACTS = (("none", False), ("relu", False), ("tanh", False),
           ("gelu", False), ("gelu", True))
MM_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 * BF16_ROUND}
FFN_M, FFN_K, FFN_N = TRAIN_B * TRAIN_S, 768, 3072


def gemm_tol(dtype, want, dz_rounded=False):
    """The limit of one GEMM output against its plain version, atol set
    against the output's scale s = max |want|.

    * rtol: f32 1e-5 (the activations' last-ulp differences); bf16 2^-7,
      twice the output's one rounding.
    * atol 2^-16 s: the f32 sums run in another order (~1e-7 s), which
      the rtol term misses only where an output is near zero.
    * The bf16 dX and dW round dZ to bf16 before the tensor cores (one
      rounding the f32 plain version lacks).  Each output then carries
      sum_i dz_i w_i d_i with independent |d_i| <= 2^-8: about 2^-8 /
      sqrt(3) of its rms, ~5.5 of those at the largest of 2.4e7 outputs,
      ~1.2% of the rms or ~0.25% of s.  atol 2^-7 s there: twice that
      and more, while a missing 32-wide K tile (~10% of the rms) or a
      2% scale error still fails."""
    s = want.abs().max().item()
    return dict(atol=(2 * BF16_ROUND if dz_rounded else 2.0 ** -16) * s,
                rtol=MM_RTOL[dtype])


def matmul_case(ops, gen, m, k, n, dt, act, approx, has_bias, scale=1.0):
    """Kernels 5-7 on one shape against their plain versions on the same
    inputs (bf16 upcast exactly): the forward with and without z, dX and
    dW(+dbias) from the kernel's own residual, each kernel launched
    twice for bitwise-equal outputs.  Returns (errors, limit shares,
    tensors) keyed by output."""
    x = torch.randn(m, k, device="cuda", generator=gen).to(dt)
    w = (torch.randn(n, k, device="cuda", generator=gen) * scale
         * k ** -0.5).to(dt)
    b = (torch.randn(n, device="cuda", generator=gen) * 0.1).to(dt) \
        if has_bias else None
    g = torch.randn(m, n, device="cuda", generator=gen).to(dt)
    name = "matmul M=%d K=%d N=%d %s %s%s bias=%s" % (
        m, k, n, str(dt).replace("torch.", ""), act,
        "(tanh)" if approx else "", has_bias)
    kind = ops.matmul._residual_kind(act)
    y, z = ops.matmul_bias_act_fwd(x, w, b, act, approx, emit_z=True)
    y2, z2 = ops.matmul_bias_act_fwd(x, w, b, act, approx, emit_z=True)
    y_noz, none = ops.matmul_bias_act_fwd(x, w, b, act, approx)
    res = z if kind == "z" else (y if kind == "y" else None)
    dx = ops.matmul_bwd_dx(g, res, w, act, approx)
    dw, db = ops.matmul_bwd_dw(x, g, res, act, approx, bias=b)
    dx2 = ops.matmul_bwd_dx(g, res, w, act, approx)
    dw2, db2 = ops.matmul_bwd_dw(x, g, res, act, approx, bias=b)
    torch.cuda.synchronize()
    if none is not None or not torch.equal(y, y_noz):
        raise AssertionError("%s: the forward without z differs" % name)
    if not (torch.equal(y, y2) and torch.equal(z, z2)):
        raise AssertionError("%s: two forward launches differ" % name)
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)
            and (b is None or torch.equal(db, db2))):
        raise AssertionError("%s: two backward launches differ" % name)
    xf, wf, bf, gf, rf = upcast(x, w, b, g, res)
    y_ref, z_ref = ops.matmul_bias_act_reference(xf, wf, bf, act, approx,
                                                 emit_z=True)
    dx_ref, dw_ref, db_ref = ops.matmul_bias_act_bwd_reference(
        xf, wf, bf, rf, gf, act, approx)
    bf16 = dt == torch.bfloat16
    checks = [("y", y, y_ref, gemm_tol(dt, y_ref)),
              ("z", z, z_ref, gemm_tol(dt, z_ref)),
              ("dx", dx, dx_ref, gemm_tol(dt, dx_ref, bf16)),
              ("dw", dw, dw_ref, gemm_tol(dt, dw_ref, bf16))]
    if b is not None:
        checks.append(("dbias", db, db_ref, gemm_tol(dt, db_ref)))
    errs, shares = {}, {}
    for tag, got, want, tol in checks:
        errs[tag], shares[tag] = compare("%s %s" % (name, tag), got, want,
                                         tol)
    return errs, shares, dict(x=x, w=w, b=b, g=g, res=res)


# check_matmul's shapes (M, K, N): 128-tileable; ragged (every edge
# masked); M = 1 and M = 63 (a consumer warpgroup of the bf16 backward
# sees only zero rows); and, bf16 only, one whose M is not a multiple of
# its dW split's chunk (`dw_split_plan`: 9 chunks of 448 rows)
MM_SHAPES = ((256, 128, 384), (777, 264, 200), (1, 768, 3072),
             (63, 264, 200))
MM_SPLIT_SHAPE = (4000, 256, 512)


def check_matmul(ops):
    """Kernels 5-7 against their plain versions at small shapes
    (MM_SHAPES, f32 and bf16; MM_SPLIT_SHAPE, bf16): the five
    activations, with and without a bias, z emitted and not, each
    backward twice for bitwise-equal outputs."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        shapes = MM_SHAPES + ((MM_SPLIT_SHAPE,) if dt == torch.bfloat16
                              else ())
        for m, k, n in shapes:
            for act, approx in MM_ACTS:
                for has_bias in (False, True):
                    errs, shares, _ = matmul_case(ops, gen, m, k, n, dt, act,
                                                  approx, has_bias)
                    rows.append({"M": m, "K": k, "N": n,
                                 "dtype": str(dt).replace("torch.", ""),
                                 "act": act + ("_tanh" if approx else ""),
                                 "bias": has_bias, "max_abs_err": errs,
                                 "limit_share": shares,
                                 "launches_bitwise": True})
    worst = {tag: max(r["limit_share"].get(tag, 0.0) for r in rows)
             for tag in ("y", "z", "dx", "dw", "dbias")}
    emit({"phase": "kernel_check", "kernel": "matmul_bias_act",
          "cases": len(rows), "worst_limit_share": worst, "rows": rows})
    return rows


def check_matmul_main_shape(ops):
    """Kernels 5-7 at the fused FFN's own shape (M = 60 * 512, K = 768, N
    = 3072, bf16, exact gelu, bias, z emitted; fc1's init scale): errors
    against the plain versions (each backward launched twice, bitwise),
    then each timed beside its plain version and the library yardstick
    (F.linear + F.gelu; torch's dX, and dW + dbias, of that composition
    on a retained graph); the backward's tile and dW's split of
    M beside them."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(9)
    m, k, n, dt = FFN_M, FFN_K, FFN_N, torch.bfloat16
    errs, shares, t = matmul_case(ops, gen, m, k, n, dt, "gelu", False, True,
                                  scale=0.02 * k ** 0.5)
    x, w, b, g, res = t["x"], t["w"], t["b"], t["g"], t["res"]
    fwd = lambda: ops.matmul_bias_act_fwd(x, w, b, "gelu", emit_z=True)  # noqa: E731
    xl, wl, bl = (v.detach().requires_grad_() for v in (x, w, b))
    out = F.gelu(F.linear(xl, wl, bl))
    elt = 2
    bounds = {
        "matmul_bias_act": bound((m * k + n * k + n + 2 * m * n) * elt,
                                 2 * m * n * k, dt),
        "matmul_bwd_dx": bound((2 * m * n + n * k + m * k) * elt,
                               2 * m * n * k, dt),
        "matmul_bwd_dw": bound((m * k + 2 * m * n + n * k + n) * elt,
                               2 * m * n * k, dt)}
    mm = ops.matmul
    row = {
        "M": m, "K": k, "N": n, "dtype": "bfloat16", "act": "gelu",
        "max_abs_err": errs, "limit_share": shares,
        "launches_bitwise": True,
        "fwd_tile": [mm.FWD_ROWS, mm.FWD_COLS],
        "fwd_ctas": mm.fwd_schedule(m, n, mm._sm_count(x.device)),
        "fwd_tiles": mm.fwd_tiles(m, n),
        "bwd_tile": [mm.BWD_ROWS, mm.BWD_COLS],
        "dw_splits": mm.dw_split_plan(m, n, k, mm._sm_count(x.device))[0],
        "fwd_ms": time_ms(fwd),
        "dx_ms": time_ms(lambda: ops.matmul_bwd_dx(g, res, w, "gelu")),
        "dw_ms": time_ms(lambda: ops.matmul_bwd_dw(x, g, res, "gelu",
                                                   bias=b)),
        "plain_fwd_ms": time_ms(lambda: ops.matmul_bias_act_reference(
            x, w, b, "gelu", emit_z=True), iters=5, warmup=1),
        "plain_dx_ms": time_ms(lambda: ops.matmul_bias_act_bwd_reference(
            x, w, b, res, g, "gelu", needs=(True, False, False)),
            iters=5, warmup=1),
        "plain_dw_ms": time_ms(lambda: ops.matmul_bias_act_bwd_reference(
            x, w, b, res, g, "gelu", needs=(False, True, True)),
            iters=5, warmup=1),
        "library_fwd_ms": time_ms(lambda: F.gelu(F.linear(x, w, b))),
        "library_dx_ms": time_ms(lambda: torch.autograd.grad(
            out, (xl,), g, retain_graph=True)),
        "library_dw_ms": time_ms(lambda: torch.autograd.grad(
            out, (wl, bl), g, retain_graph=True)),
        # where the kernels' time goes: the same products with no
        # activation, bias or z (no dZ to form), and cuBLAS's bare GEMMs
        "noact_ms": {
            "fwd": time_ms(lambda: ops.matmul_bias_act_fwd(x, w)),
            "dx": time_ms(lambda: ops.matmul_bwd_dx(g, None, w)),
            "dw": time_ms(lambda: ops.matmul_bwd_dw(x, g, None))},
        "cublas_gemm_ms": {
            "fwd": time_ms(lambda: torch.matmul(x, w.t())),
            "dx": time_ms(lambda: torch.matmul(g, w)),
            "dw": time_ms(lambda: torch.matmul(g.t(), x))},
        "bounds": bounds}
    del out
    emit({"phase": "kernel_check", "kernel": "matmul_main_shape", **row})
    return row


# ---------------------------------------------------------------------------
# phase 3: BERT-base pretraining at full width
# ---------------------------------------------------------------------------

# bench.py's flagship configuration (vocab padded to a multiple of 64)
BERT_BASE = dict(vocab_size=30528, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512)
TRAIN_STEPS, REPEAT_STEPS, PAIR_STEPS = 10, 8, 3
# card vs CPU, f32: the loss within 1e-4; each gradient within 1e-4 of
# its own largest entry.  The sums run in other orders (cuBLAS vs the
# CPU's BLAS, the kernels' tiles vs the plain einsums) through 12
# layers, ~1e-6 of the scale; a wrong mask or a missing term is 1e-2.
MODEL_LOSS_ATOL, MODEL_GRAD_REL = 1e-4, 1e-4
# fused vs pair backward in the bf16 train step.  Their dQ differs by at
# most one bf16 ulp, so the losses agree to ~1e-4 (1.3e-4 over 3 steps
# on the H100) and one step's master gradients to under 1e-2 in
# relative norm (6.6e-3 at layer 0's qkv_proj, 2.5e-6 at layer 11's:
# the ulps of dQ grow as the bf16 backward carries them down); the
# limits are 3x and more those readings.
PAIR_LOSS_ATOL, PAIR_GRAD_REL = 1e-3, 2e-2
# fused-epilogue FFN vs the default FFN in the bf16 train step.  The two
# round at other places (the fused kernel applies gelu to the f32
# pre-activation, the default path to its bf16 rounding), so every FFN
# element differs by up to an ulp.  On the H100 (700 W): the first step's
# loss 7.8e-5 apart (same parameters), then 7.8e-5, 5.3e-4, 8.6e-3 as
# AdamW's first updates, ~lr * sign(g), turn near-zero gradient noise
# into whole steps; step-1 master gradients 0.85-1.5% apart in relative
# norm, while each bf16 step stands 1.2-1.8% from the same step in f32,
# the fused one 0.90-0.98 times as far as the default.  Limits: the
# first loss 1e-3, every loss 3e-2, gradients 5e-2 apart, and the fused
# step at most 1.25 times as far from the f32 step as the default.
FFN_STEPS = 4
FFN_LOSS1_ATOL, FFN_LOSS_ATOL = 1e-3, 3e-2
FFN_GRAD_REL, FFN_VS_F32 = 5e-2, 1.25


def _grad_names(L):
    return ("bert.encoder.0.attn.qkv_proj.weight",
            "bert.encoder.%d.attn.qkv_proj.weight" % (L - 1),
            "bert.embeddings.word.weight")


def _ffn_grad_names(L):
    return _grad_names(L) + ("bert.encoder.0.fc1.weight",
                             "bert.encoder.0.fc1.bias",
                             "bert.encoder.%d.fc1.weight" % (L - 1))


def _grad_rel(state_a, state_b, names, limit, tag):
    """Relative norm of the difference of two first steps' master
    gradients: from zero moments, Moment1 = (1 - beta1) * grad."""
    errs = {}
    for name in names:
        ga, gb = (st["opt"][name]["Moment1"] for st in (state_a, state_b))
        rel = ((ga - gb).norm() / gb.norm()).item()
        errs[name] = rel
        if not rel <= limit:
            raise AssertionError("step-1 grad %s: %s relative error %g, "
                                 "limit %g" % (name, tag, rel, limit))
    return errs


def flops_per_step(cfg, params, b, s, p):
    """`bench.py:_flops_per_step`: 6 FLOPs per matmul parameter per
    token for the trunk, the MLM head (tied decoder + mlm_transform) on
    the P masked rows only, plus the exact attention term 12 L S h per
    token (forward and backward); embedding lookups cost none."""
    d, v = cfg.hidden_size, cfg.vocab_size
    head = v * d + d * d + d + v
    trunk = 0
    for name, arr in params.items():
        if not ("position" in name or "token_type" in name
                or "word" in name or "mlm" in name):
            trunk += int(np.prod(arr.shape))
    attn = 12.0 * cfg.num_hidden_layers * cfg.hidden_size * s
    return b * s * (6.0 * trunk + attn) + b * p * 6.0 * head


def make_bert_batch(rng, cfg, b, s, p):
    """One pretraining batch as `bench.py:287-307` makes it."""
    pos = np.stack([np.sort(rng.choice(s, size=p, replace=False))
                    for _ in range(b)]).astype(np.int32)
    return {
        "input_ids": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "token_type_ids": np.zeros((b, s), np.int32),
        "position_ids": np.tile(np.arange(s, dtype=np.int32), (b, 1)),
        "masked_positions": pos,
        "mlm_labels": rng.randint(0, cfg.vocab_size, (b, p)).astype(np.int32),
        "mlm_weights": np.ones((b, p), np.float32),
        "nsp_labels": rng.randint(0, 2, (b, 1)).astype(np.int32),
    }


def bert_loss_fn(model, batch):
    logits, nsp_logits = model(
        batch["input_ids"], batch["token_type_ids"], batch["position_ids"],
        attention_mask=batch.get("attention_mask"),
        segment_ids=batch.get("segment_ids"),
        masked_positions=batch["masked_positions"])
    return model.loss(logits, nsp_logits, batch["mlm_labels"],
                      batch["mlm_weights"], batch["nsp_labels"])


class _env:
    """Set (or, with None, remove) one environment variable for a block
    and restore its old value after it, whatever happens inside."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        if self.value is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.old
        return False


def train_model_check(ptt):
    """Full-width BERT-base, dropout 0, one f32 forward and backward at
    B=2, S=128, P=20 on the card (the kernels) and, with the same
    weights and batch, on the CPU (the plain versions), once with the
    default FFN and once with PADDLE_TPU_FUSED_FFN=1 (fc1 + gelu through
    the fused-epilogue GEMM kernels, M = 256).  Row 0 pads its last 40
    keys through ``attention_mask`` and row 1 packs two segments through
    ``segment_ids``, so the bias and segment paths run inside the
    model."""
    models, ops = ptt.models, ptt.ops
    cfg = models.BertConfig(**BERT_BASE, hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    weights = models.from_jax_state_dict(models.init_bert_params(cfg, 13))
    b, s, p = 2, 128, 20
    batch = make_bert_batch(np.random.RandomState(1), cfg, b, s, p)
    batch["attention_mask"] = np.ones((b, s), np.int32)
    batch["attention_mask"][0, s - 40:] = 0
    batch["segment_ids"] = np.zeros((b, s), np.int32)
    batch["segment_ids"][1, s // 2:] = 1
    L = cfg.num_hidden_layers
    names = ("bert.encoder.0.attn.qkv_proj.weight",
             "bert.encoder.%d.attn.qkv_proj.weight" % (L - 1),
             "bert.embeddings.word.weight", "mlm_bias",
             "bert.encoder.0.fc1.weight", "bert.encoder.%d.fc1.bias" % (L - 1))
    # B=2: 24 heads leave the card mostly idle, so the rule takes the pair
    fused = ops.attention._use_fused_bwd(
        b * cfg.num_attention_heads, s, s, D,
        torch.cuda.get_device_properties(0).multi_processor_count,
        torch.float32)
    for fused_ffn in (False, True):
        got = {}
        with _env("PADDLE_TPU_FUSED_FFN", "1" if fused_ffn else None):
            for dev in ("cuda", "cpu"):
                model = models.BertForPretraining(cfg, device=dev)
                model.load_state_dict(weights)
                tb = {k: torch.from_numpy(v).to(dev)
                      for k, v in batch.items()}
                params = dict(model.named_parameters())
                ops.reset_launch_counts()
                loss = bert_loss_fn(model, tb)
                grads = torch.autograd.grad(loss,
                                            [params[n] for n in names])
                got[dev] = (loss.item(), [g.cpu() for g in grads],
                            ops.launch_counts())
                del model, params, grads
        (loss_c, grads_c, launches), (loss_h, grads_h, _) = got["cuda"], \
            got["cpu"]
        tag = "BERT-base%s" % (" fused FFN" if fused_ffn else "")
        if not np.isfinite(loss_c) or abs(loss_c - loss_h) > MODEL_LOSS_ATOL:
            raise AssertionError("%s loss: card %r, CPU %r"
                                 % (tag, loss_c, loss_h))
        errs = {}
        for name, gc, gh in zip(names, grads_c, grads_h):
            scale = gh.abs().max().item()
            err = (gc - gh).abs().max().item()
            errs[name] = {"max_abs_err": err, "max_abs": scale}
            if not torch.isfinite(gc).all() or err > MODEL_GRAD_REL * scale:
                raise AssertionError("%s grad %s: max err %g against "
                                     "max |g| %g" % (tag, name, err, scale))
        ffn = L if fused_ffn else 0
        _expect_launches("card forward/backward (%s)" % tag, launches, {
            "flash_fwd": L, "flash_bwd_fused": L if fused else 0,
            "flash_bwd_dq": 0 if fused else L,
            "flash_bwd_dkv": 0 if fused else L, "matmul_bias_act": ffn,
            "matmul_bwd_dx": ffn, "matmul_bwd_dw": ffn})
        emit({"phase": "train_model_check", "fused_ffn": fused_ffn,
              "B": b, "S": s, "P": p,
              "backward": "fused" if fused else "pair",
              "loss_card": loss_c, "loss_cpu": loss_h,
              "loss_abs_err": abs(loss_c - loss_h),
              "loss_atol": MODEL_LOSS_ATOL, "grad_rel_tol": MODEL_GRAD_REL,
              "grads": errs, "launches": launches})


def _run_steps(step, state, batches, ids):
    """``step`` over ``batches[i]`` for i in ``ids``; CUDA events around
    every step.  Returns (state, losses, per-step ms)."""
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(len(ids) + 1)]
    losses = []
    evs[0].record()
    for n, i in enumerate(ids):
        state, loss = step(state, batches[i])
        losses.append(loss)
        evs[n + 1].record()
    torch.cuda.synchronize()
    ms = [evs[n].elapsed_time(evs[n + 1]) for n in range(len(ids))]
    return state, [x.item() for x in losses], ms


def _expect_launches(tag, launches, want):
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError("%s launches %s, want %s" % (tag, launches,
                                                          want))


def train(ptt):
    """`bench.py:_run`'s flagship step on the port: BERT-base at full
    width, dropout 0.1, AdamW(1e-4, wd 0.01), ShardedTrainStep(zero_stage
    0, amp bf16), B=60, S=512, P=80, four batches.  Two warm-up steps,
    then TRAIN_STEPS timed; REPEAT_STEPS on one repeated batch (the loss
    must fall); PAIR_STEPS again from the initial state under
    PADDLE_TPU_FLASH_FUSED_BWD=0 (the dQ + dK/dV pair), whose losses
    must equal the fused run's at the bf16 policy; one step profiled."""
    models, ops = ptt.models, ptt.ops
    cfg = models.BertConfig(**BERT_BASE, hidden_dropout_prob=0.1,
                            attention_probs_dropout_prob=0.1)
    b, s, p = TRAIN_B, TRAIN_S, TRAIN_P
    t0 = time.perf_counter()
    model = models.BertForPretraining(cfg, device="cuda")
    model.load_state_dict(models.from_jax_state_dict(
        models.init_bert_params(cfg, 17)))
    step = ptt.distributed.ShardedTrainStep(
        model, ptt.optimizer.AdamWOptimizer(learning_rate=1e-4,
                                            weight_decay=0.01),
        bert_loss_fn, mesh=None, zero_stage=0, amp="bf16")
    state0 = step.init()
    rng = np.random.RandomState(0)
    batches = [step.place_batch(make_bert_batch(rng, cfg, b, s, p))
               for _ in range(4)]
    flops = flops_per_step(cfg, state0["params"], b, s, p)
    setup_s = time.perf_counter() - t0
    L = cfg.num_hidden_layers

    state, warm_losses, _ = _run_steps(step, state0, batches, [0, 1])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ids = [(2 + n) % 4 for n in range(TRAIN_STEPS)]
    state, losses, step_ms = _run_steps(step, state, batches, ids)
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    _expect_launches("fused train run", launches, {
        "flash_fwd": L * TRAIN_STEPS, "flash_bwd_fused": L * TRAIN_STEPS,
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "matmul_bias_act": 0,
        "matmul_bwd_dx": 0, "matmul_bwd_dw": 0})
    peak_mem = torch.cuda.max_memory_allocated()
    fused_losses = warm_losses + losses
    if not np.isfinite(fused_losses).all():
        raise AssertionError("non-finite training loss: %s" % fused_losses)

    state, repeat_losses, _ = _run_steps(step, state, batches,
                                         [0] * REPEAT_STEPS)
    if not (np.isfinite(repeat_losses).all()
            and repeat_losses[-1] < repeat_losses[0]):
        raise AssertionError("the loss did not fall on one repeated batch: "
                             "%s" % repeat_losses)

    prof = device_profile(lambda: step(state, batches[0]))
    del state

    with _env("PADDLE_TPU_FLASH_FUSED_BWD", "0"):
        ops.reset_launch_counts()
        _, pair_losses, pair_ms = _run_steps(step, state0, batches,
                                             list(range(PAIR_STEPS)))
        pair_launches = ops.launch_counts()
        pair_first, _ = step(state0, batches[0])
    _expect_launches("pair train run", pair_launches, {
        "flash_fwd": L * PAIR_STEPS, "flash_bwd_fused": 0,
        "flash_bwd_dq": L * PAIR_STEPS, "flash_bwd_dkv": L * PAIR_STEPS,
        "matmul_bias_act": 0, "matmul_bwd_dx": 0, "matmul_bwd_dw": 0})
    pair_loss_err = float(np.max(np.abs(
        np.subtract(pair_losses, fused_losses[:PAIR_STEPS]))))
    if not pair_loss_err <= PAIR_LOSS_ATOL:
        raise AssertionError("pair run losses %s against the fused run's %s"
                             % (pair_losses, fused_losses[:PAIR_STEPS]))
    # one step's gradients, fused against pair: the first step from zero
    # moments leaves Moment1 = (1 - beta1) * grad, the f32 master grads
    fused_first, _ = step(state0, batches[0])
    grad_errs = _grad_rel(fused_first, pair_first, _grad_names(L),
                          PAIR_GRAD_REL, "fused vs pair")
    del pair_first

    # the fused-epilogue FFN: the same step from state0 with
    # PADDLE_TPU_FUSED_FFN=1, its first FFN_STEPS losses held against the
    # default run's on the same batches
    with _env("PADDLE_TPU_FUSED_FFN", "1"):
        ops.reset_launch_counts()
        ffn_state, ffn_losses, ffn_ms = _run_steps(
            step, state0, batches, list(range(FFN_STEPS)))
        ffn_launches = ops.launch_counts()
        ffn_prof = device_profile(lambda: step(ffn_state, batches[0]))
        ffn_first, _ = step(state0, batches[0])
    del ffn_state
    _expect_launches("fused-FFN train run", ffn_launches, {
        "flash_fwd": L * FFN_STEPS, "flash_bwd_fused": L * FFN_STEPS,
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "matmul_bias_act": L * FFN_STEPS, "matmul_bwd_dx": L * FFN_STEPS,
        "matmul_bwd_dw": L * FFN_STEPS})
    if not np.isfinite(ffn_losses).all():
        raise AssertionError("non-finite fused-FFN loss: %s" % ffn_losses)
    ffn_loss_errs = np.abs(np.subtract(ffn_losses, fused_losses[:FFN_STEPS]))
    ffn_loss_err = float(np.max(ffn_loss_errs))
    if not (ffn_loss_errs[0] <= FFN_LOSS1_ATOL
            and ffn_loss_err <= FFN_LOSS_ATOL):
        raise AssertionError("fused-FFN run losses %s against the default "
                             "run's %s" % (ffn_losses,
                                           fused_losses[:FFN_STEPS]))
    names = _ffn_grad_names(L)
    ffn_grad_errs = _grad_rel(ffn_first, fused_first, names, FFN_GRAD_REL,
                              "fused FFN vs default")
    # the yardstick of both bf16 steps: the same first step in f32, from
    # which the fused FFN's step may stand at most FFN_VS_F32 times as far
    # as the default FFN's
    f32_first, _ = ptt.distributed.ShardedTrainStep(
        model, ptt.optimizer.AdamWOptimizer(learning_rate=1e-4,
                                            weight_decay=0.01),
        bert_loss_fn, mesh=None, zero_stage=0, amp=None)(state0, batches[0])
    default_vs_f32 = _grad_rel(fused_first, f32_first, names, 1.0,
                               "default bf16 vs f32")
    ffn_vs_f32 = _grad_rel(ffn_first, f32_first, names, 1.0,
                           "fused-FFN bf16 vs f32")
    for name in names:
        if not ffn_vs_f32[name] <= FFN_VS_F32 * default_vs_f32[name]:
            raise AssertionError(
                "step-1 grad %s: the fused-FFN bf16 step is %g from the f32 "
                "step, the default's %g (limit %g times)"
                % (name, ffn_vs_f32[name], default_vs_f32[name], FFN_VS_F32))
    del fused_first, ffn_first, f32_first
    ffn_timed = ffn_ms[1:]
    ffn_mean_s = float(np.mean(ffn_timed)) / 1e3

    mean_s = float(np.mean(step_ms)) / 1e3
    emit({"phase": "train", "B": b, "S": s, "P": p, "amp": "bf16",
          "setup_s": setup_s, "steps": TRAIN_STEPS,
          "step_ms": step_ms,
          "step_ms_p50": float(np.percentile(step_ms, 50)),
          "step_ms_p99": float(np.percentile(step_ms, 99)),
          "tokens_per_s": b * s / mean_s,
          "host_wall_tokens_per_s": b * s * TRAIN_STEPS / wall_s,
          "flops_per_step": flops,
          "model_flops_share_of_989tf": flops / mean_s / PEAK_FLOPS[
              torch.bfloat16],
          "peak_memory_bytes": peak_mem,
          "losses": fused_losses, "repeat_batch_losses": repeat_losses,
          "launches": launches,
          "pair_losses": pair_losses, "pair_step_ms": pair_ms,
          "pair_vs_fused_max_abs": pair_loss_err,
          "pair_loss_atol": PAIR_LOSS_ATOL,
          "pair_vs_fused_step1_grad_rel": grad_errs,
          "pair_grad_rel_limit": PAIR_GRAD_REL,
          "pair_launches": pair_launches})
    emit({"phase": "train_profile", "steps": 1,
          "flash_ms": sum(v[0] for k, v in prof["by_category_ms"].items()
                          if k.startswith("flash")), **prof})
    emit({"phase": "train_fused_ffn", "B": b, "S": s, "P": p, "amp": "bf16",
          "steps": FFN_STEPS, "step_ms": ffn_ms,
          "step_ms_p50": float(np.percentile(ffn_timed, 50)),
          "step_ms_p99": float(np.percentile(ffn_timed, 99)),
          "tokens_per_s": b * s / ffn_mean_s,
          "model_flops_share_of_989tf": flops / ffn_mean_s / PEAK_FLOPS[
              torch.bfloat16],
          "default_step_ms_p50": float(np.percentile(step_ms, 50)),
          "default_tokens_per_s": b * s / mean_s,
          "losses": ffn_losses,
          "default_losses": fused_losses[:FFN_STEPS],
          "vs_default_abs": ffn_loss_errs.tolist(),
          "loss_atol": [FFN_LOSS1_ATOL, FFN_LOSS_ATOL],
          "vs_default_step1_grad_rel": ffn_grad_errs,
          "grad_rel_limit": FFN_GRAD_REL,
          "step1_grad_rel_to_f32": {"fused_ffn": ffn_vs_f32,
                                    "default": default_vs_f32},
          "vs_f32_ratio_limit": FFN_VS_F32, "launches": ffn_launches})
    emit({"phase": "train_profile_fused_ffn", "steps": 1, **ffn_prof})
    return launches, pair_launches, ffn_launches


# ---------------------------------------------------------------------------
# phase 4: the engine at full width
# ---------------------------------------------------------------------------


def make_requests(gen, cfg, n=16, seed=11):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.randint(16, 701))
        prompt = rng.randint(0, cfg.vocab_size, plen)
        max_new = int(rng.randint(32, 65))
        sp = (gen.SamplingParams.greedy() if i % 2 == 0 else
              gen.SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                                 seed=1000 + i))
        reqs.append(gen.GenerationRequest(
            prompt, max_new_tokens=max_new, sampling=sp,
            request_id="smoke%d" % i))
    return reqs


def serve(gen, model, reqs, **kw):
    eng = gen.GenerationEngine(model, slots=8, max_len=1024, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(r) for r in reqs]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [h.result(timeout=0) for h in handles]
    for r, h, s in zip(reqs, handles, streams):
        if len(s) != r.max_new_tokens or h.finish_reason != "max_new_tokens":
            raise AssertionError("%s: %d of %d tokens (%s)"
                                 % (r.request_id, len(s), r.max_new_tokens,
                                    h.finish_reason))
    if eng.paged and eng.cache.pool.used_blocks != 0:
        raise AssertionError("%d blocks never returned to the pool"
                             % eng.cache.pool.used_blocks)
    return eng, handles, streams, wall


KERNEL_CATEGORIES = (
    ("conv_bn_relu", "conv_bn_relu"), ("conv_bn_stats", "conv_bn_stats"),
    ("matmul_fwd_", "matmul_bias_act"), ("matmul_dx_", "matmul_bwd_dx"),
    ("matmul_dw_", "matmul_bwd_dw"),
    ("flash_fwd", "flash_fwd"),
    ("flash_bwd_fused", "flash_bwd_fused"),
    ("flash_bwd_dq", "flash_bwd_dq"),
    ("flash_bwd_dkv", "flash_bwd_dkv"),
    ("decode_paged", "paged_attention"),
    ("decode_dense", "decode_attention"),
    ("bn_fw", "bn_affine"), ("batch_norm", "bn_affine"),
    ("fprop", "conv_cudnn"), ("dgrad", "conv_cudnn"),
    ("wgrad", "conv_cudnn"), ("convolve", "conv_cudnn"),
    ("conv2d", "conv_cudnn"), ("winograd", "conv_cudnn"),
    ("nchwToNhwc", "layout_copy"), ("nhwcToNchw", "layout_copy"),
    ("max_pool", "pool"),
    ("gemm", "matmul"), ("gemv", "matmul"), ("sm90_", "matmul"),
    ("cutlass", "matmul"), ("cublas", "matmul"), ("nvjet", "matmul"),
    ("sort", "sampling_sort"), ("Sort", "sampling_sort"),
    ("layer_norm", "layer_norm"), ("GammaBeta", "layer_norm"),
    ("embedding", "embedding"),
    ("Memcpy", "copy"), ("Memset", "copy"), ("CatArray", "copy"),
    ("direct_copy", "copy"), ("bfloat16_copy", "copy"),
    ("index", "kv_scatter_gather"), ("scatter", "kv_scatter_gather"),
    ("gather", "kv_scatter_gather"),
    ("distribution", "dropout_rng"),
    ("foreach", "optimizer"), ("multi_tensor", "optimizer"),
    ("softmax", "softmax_xent"), ("SoftMax", "softmax_xent"),
    ("nll", "softmax_xent"),
    ("GeluCUDA", "gelu"),
    ("reduce", "reduce"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
)


def kernel_category(name):
    for key, cat in KERNEL_CATEGORIES:
        if key in name:
            return cat
    return "other"


def device_profile(run):
    """Device time by kernel category over one call of ``run`` (which
    ends in a synchronize), from torch.profiler's CUDA activity.  The
    profiler slows the host, so the idle share here is an upper bound on
    the unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_cat, by_name = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        for table, key in ((by_cat, kernel_category(e.name)),
                           (by_name, e.name[:90])):
            row = table.setdefault(key, [0.0, 0])
            row[0] += us
            row[1] += 1
    busy_us = sum(v[0] for v in by_cat.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"profiled_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if by_cat else None,
            "device_idle_share": (1 - busy_us / wall_us) if by_cat else None,
            "by_category_ms": {k: [v[0] / 1e3, v[1]] for k, v in sorted(
                by_cat.items(), key=lambda kv: -kv[1][0])},
            "top_kernels_ms": [[k, v[0] / 1e3, v[1]] for k, v in top]}


def device_ms(fn, category, iters=20, warmup=3):
    """One launch's device time of the kernel of ``category`` in ``fn``:
    its time summed over ``iters`` calls from torch.profiler's CUDA
    activity, over its launches.  Back-to-back CUDA events around a
    short kernel's wrapper read the host's time to enqueue it instead."""
    for _ in range(warmup):
        fn()
    prof = device_profile(lambda: [fn() for _ in range(iters)])
    ms, n = prof["by_category_ms"].get(category, (0.0, 0))
    if n < iters:
        raise AssertionError("device_ms: %d %s launches in %d calls"
                             % (n, category, iters))
    return ms / n


def profile_engine(gen, model, reqs):
    """`device_profile` of one engine run of ``reqs``."""
    eng = gen.GenerationEngine(model, slots=8, max_len=1024)
    for r in reqs:
        eng.submit(r)
    prof = device_profile(eng.run_until_idle)
    emit({"phase": "engine_profile", "requests": len(reqs),
          "decode_steps": eng.stats()["decode_steps"], **prof})


def run_engine(ptt):
    gen, models, ops = ptt.generation, ptt.models, ptt.ops
    cfg = models.TransformerLMConfig(
        vocab_size=32000, hidden_size=768, num_layers=12, num_heads=12,
        intermediate_size=3072, max_position_embeddings=1024, dropout=0.0)
    t0 = time.perf_counter()
    model = models.TransformerLM(cfg, device="cuda")
    model.load_state_dict(models.from_jax_state_dict(
        models.init_params(cfg, seed=7)))
    model.eval()
    setup_s = time.perf_counter() - t0

    # the prefill forward on the card (flash kernel) against the same
    # weights on the CPU (plain versions), 64-token prompt
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, 64)))
    pos = torch.arange(64)[None]
    with torch.inference_mode():
        got = model(ids.cuda(), pos.cuda()).cpu()
        cpu_model = models.TransformerLM(cfg, device="cpu")
        cpu_model.load_state_dict(model.state_dict())
        want = cpu_model.eval()(ids, pos)
    del cpu_model
    if got.shape != (1, 64, cfg.vocab_size) or not torch.isfinite(got).all():
        raise AssertionError("bad logits %s" % (tuple(got.shape),))
    logit_err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    emit({"phase": "model_check", "logits_shape": list(got.shape),
          "card_vs_cpu_max_abs_err": logit_err, "atol": 1e-4,
          "setup_s": setup_s})

    reqs = make_requests(gen, cfg)
    serve(gen, model, reqs[:2])                  # warm-up (cuBLAS, caches)
    ops.reset_launch_counts()
    eng, handles, streams, wall = serve(gen, model, reqs)
    launches = ops.launch_counts()
    for name in ("flash_fwd", "paged_attention"):
        if launches[name] <= 0:
            raise AssertionError("kernel %s never launched on the paged "
                                 "engine run" % name)
    n_tok = sum(len(s) for s in streams)
    ttft = [(h.t_first_token - h.t_submit) * 1e3 for h in handles]
    # inter-token latency as a client sees it: every gap between two
    # tokens of one stream, prefills of other requests included
    itl = np.concatenate([np.diff(h.t_tokens) * 1e3 for h in handles])
    step = eng._m_itl.summary()
    emit({"phase": "engine", "paged": True, "requests": len(reqs),
          "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
          "ttft_ms_p50": float(np.percentile(ttft, 50)),
          "ttft_ms_p99": float(np.percentile(ttft, 99)),
          "itl_ms_p50": float(np.percentile(itl, 50)),
          "itl_ms_p99": float(np.percentile(itl, 99)),
          "decode_step_ms_p50": step["p50"],
          "decode_step_ms_p99": step["p99"],
          "decode_steps": eng.stats()["decode_steps"],
          "prompt_lens": [len(r.prompt_ids) for r in reqs],
          "launches": launches})

    profile_engine(gen, model, reqs)

    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    sampled = [i for i in range(len(reqs)) if i not in greedy][:4]
    picked = greedy + sampled
    oracle = gen.sequential_oracle(
        lambda: gen.GenerationEngine(model, slots=8, max_len=1024),
        [reqs[i] for i in picked])
    bad = [reqs[i].request_id for i, o in zip(picked, oracle)
           if o != streams[i]]
    if bad:
        raise AssertionError("streams differ from sequential_oracle: %s"
                             % bad)

    # the dense (paged=False) path: its own run, counts from 0
    ops.reset_launch_counts()
    _, _, dense_streams, dense_wall = serve(gen, model, reqs, paged=False)
    dense_launches = ops.launch_counts()
    for name in ("flash_fwd", "decode_attention"):
        if dense_launches[name] <= 0:
            raise AssertionError("kernel %s never launched on the dense "
                                 "engine run" % name)
    launches["decode_attention"] = dense_launches["decode_attention"]
    bad = [reqs[i].request_id for i in greedy
           if dense_streams[i] != streams[i]]
    if bad:
        raise AssertionError("dense engine's greedy streams differ from "
                             "the paged engine's: %s" % bad)
    emit({"phase": "engine_checks", "oracle_requests": len(picked),
          "oracle_equal": True, "dense_greedy_equal": True,
          "dense_sampled_equal": all(dense_streams[i] == streams[i]
                                     for i in range(len(reqs))),
          "dense_tokens_per_s": n_tok / dense_wall,
          "dense_launches": dense_launches, "blocks_returned": True})
    return launches


# ---------------------------------------------------------------------------
# phase 5: the 1x1 conv + BN + relu kernel and ResNet-50 eval
# ---------------------------------------------------------------------------

RESNET_B, RESNET_HW, RESNET_CLASSES = 128, 224, 1000
RESNET_BATCHES, RESNET_WARMUP = 10, 2
# bench.py:645's FLOP model: 4.089e9 an image forward, the published
# ResNet-50 count (multiply-accumulates; `counted_flops_per_image`
# counts 2 a multiply-add from the model's own shapes)
RESNET_BENCH_FLOPS = 4.089e9
# kernel 10's shapes at B = 128, 224: (batch, H = W, K = Cin, N = Cout,
# launches a forward).  The experiment's own shape
# (fused_conv_bn_relu_experiment.py:27), then every bottleneck conv0 of
# ResNet-50 (stages at 56, 28, 14, 7; the first block of a stage sees the
# previous stage's width at its own resolution)
CONV_EXPERIMENT = (128, 56, 64, 256, 0)
CONV_PATH = ((128, 56, 64, 64, 1), (128, 56, 256, 64, 2),
             (128, 56, 256, 128, 1), (128, 28, 512, 128, 3),
             (128, 28, 512, 256, 1), (128, 14, 1024, 256, 5),
             (128, 14, 1024, 512, 1), (128, 7, 2048, 512, 2))
CONV_RAGGED = (777, 200, 264)    # M, K, N: every edge of the tile masked
# the bf16 kernels 10 and 11 at every tile width (`conv_bn.TILE_WIDTHS`):
# the ragged shape, an M below one 128-row tile, and a shape with fewer
# tiles than the card has SMs at every width
CONV_GRID_SHAPES = (CONV_RAGGED, (100, 64, 64), (2048, 256, 512))
# bf16 logits against the f32 model's, in relative norm: the repo's bf16
# forward policy (2e-2); the CPU measured 5e-3 at B = 2 with the same
# seeded weights
RESNET_BF16_REL = 2e-2
# card f32 logits against the CPU's, atol against their scale: cuDNN may
# take Winograd or FFT algorithms for f32 convs, which round otherwise
# than a direct sum, over 53 conv + BN layers; a wrong tile, fold or
# edge is off by a whole term (>= 1e-2 of the scale)
RESNET_CARD_VS_CPU = 1e-3


def _bn_vectors(gen, n):
    """Seeded BN gamma, beta, mean and var [n] f32 on the card."""
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        n, device="cuda", generator=gen)
    return (u(0.5, 1.5),
            torch.randn(n, device="cuda", generator=gen) * 0.1,
            torch.randn(n, device="cuda", generator=gen) * 0.1,
            u(0.5, 2.0))


def _sms():
    from paddle_tpu_torch.ops.matmul import _sm_count

    return _sm_count(torch.device("cuda"))


def conv_grids(kernel, t, bn=None):
    """Kernel 10's (y,) or kernel 11's (y, mean, var) in bf16 at tile
    width ``bn`` (`conv_schedule`'s when None), launched twice on one CTA
    an SM and once on one CTA a tile (none counted): raises unless the
    three are bitwise equal.  Returns (outputs, bn, ctas, tiles)."""
    from paddle_tpu_torch.ops import conv_bn as cb, matmul as mm

    x, w = t["x"], t["w"]
    m, n = x.shape[0], w.shape[0]
    bn = bn or cb.conv_schedule(m, n, _sms())[0]
    tiles = mm.fwd_tiles(m, n, bn)
    ctas = min(tiles, _sms())

    def run(c):
        if kernel == "conv_bn_stats":
            return cb._launch_conv_bn_stats(x, w, bn, c)
        y = torch.empty(m, n, dtype=x.dtype, device=x.device)
        cb._launch_conv_bn_relu(x, w, t["scale"], t["shift"], y, bn, c)
        return (y,)

    outs = [run(ctas), run(ctas), run(tiles)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for o in outs[1:]
               for a, b in zip(outs[0], o)):
        raise AssertionError(
            "%s M=%d N=%d width %d: two launches on %d CTAs and one on %d "
            "differ" % (kernel, m, n, bn, ctas, tiles))
    return outs[0], bn, ctas, tiles


def _conv_operands(ops, gen, m, k, n, dt):
    x = torch.randn(m, k, device="cuda", generator=gen).to(dt)
    w = (torch.randn(n, k, device="cuda", generator=gen)
         * (2.0 / k) ** 0.5).to(dt)
    gamma, beta, mean, var = _bn_vectors(gen, n)
    scale, shift = ops.fold_bn(gamma, beta, mean, var, 1e-5)
    return dict(x=x, w=w, scale=scale, shift=shift,
                bn_vectors=(gamma, beta, mean, var))


def conv_bn_case(ops, gen, m, k, n, dt):
    """Kernel 10 on one shape against its plain version on the same
    inputs (bf16 upcast exactly); in bf16 also the wrapper's y bitwise
    equal to `conv_grids`' at the scheduled width.  Returns (error, limit
    share, tensors; in bf16 with "bn" and "ctas")."""
    t = _conv_operands(ops, gen, m, k, n, dt)
    y = ops.conv1x1_bn_relu(t["x"], t["w"], t["scale"], t["shift"])
    torch.cuda.synchronize()
    tag = "conv_bn_relu M=%d K=%d N=%d %s" % (m, k, n,
                                             str(dt).replace("torch.", ""))
    if dt == torch.bfloat16:
        (y2,), t["bn"], t["ctas"], _ = conv_grids("conv_bn_relu", t)
        if not torch.equal(y, y2):
            raise AssertionError("%s: the wrapper's y and the scheduled "
                                 "grid's differ" % tag)
    xf, wf = upcast(t["x"], t["w"])
    want = ops.conv1x1_bn_relu_reference(xf, wf, t["scale"], t["shift"])
    err, share = compare(tag, y, want, gemm_tol(dt, want))
    return err, share, t


def conv_bn_width_case(ops, gen, m, k, n, bn):
    """Kernel 10 in bf16 at tile width ``bn`` on both grids
    (`conv_grids`) against its plain version."""
    t = _conv_operands(ops, gen, m, k, n, torch.bfloat16)
    (y,), _, ctas, tiles = conv_grids("conv_bn_relu", t, bn)
    xf, wf = upcast(t["x"], t["w"])
    want = ops.conv1x1_bn_relu_reference(xf, wf, t["scale"], t["shift"])
    err, share = compare("conv_bn_relu M=%d K=%d N=%d width %d" % (
        m, k, n, bn), y, want, gemm_tol(torch.bfloat16, want))
    return {"M": m, "K": k, "N": n, "dtype": "bfloat16", "bn": bn,
            "ctas": ctas, "tiles": tiles, "max_abs_err": err,
            "limit_share": share, "bitwise_grids_and_launches": True}


def check_conv_bn(ops):
    """Kernel 10 against its plain version, f32 and bf16, at the
    experiment's shape, the eight conv0 shapes of the path and a ragged
    shape (bf16: at the scheduled width, on both grids, bitwise); then
    in bf16 every tile width at CONV_GRID_SHAPES."""
    from paddle_tpu_torch.ops import conv_bn as cb

    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = []
    shapes = [(b * hw * hw, k, n) for b, hw, k, n, _ in
              (CONV_EXPERIMENT,) + CONV_PATH] + [CONV_RAGGED]
    for dt in (torch.float32, torch.bfloat16):
        for m, k, n in shapes:
            err, share, t = conv_bn_case(ops, gen, m, k, n, dt)
            rows.append({"M": m, "K": k, "N": n,
                         "dtype": str(dt).replace("torch.", ""),
                         "bn": t.get("bn"), "ctas": t.get("ctas"),
                         "max_abs_err": err, "limit_share": share})
    for m, k, n in CONV_GRID_SHAPES:
        for bn in cb.TILE_WIDTHS:
            rows.append(conv_bn_width_case(ops, gen, m, k, n, bn))
    emit({"phase": "conv_bn_check", "cases": len(rows),
          "worst_limit_share": max(r["limit_share"] for r in rows),
          "rows": rows})
    return rows


def conv_bn_work(m, k, n, dt):
    """(bytes, flops) of kernel 10 at one shape: x, w, scale and shift
    read once, y written once; 2 flops a multiply-add."""
    elt = torch.tensor([], dtype=dt).element_size()
    return (m * k + n * k + m * n) * elt + 2 * n * 4, 2 * m * n * k


def check_conv_bn_main_shape(ops):
    """Kernel 10 timed at the experiment's shape and at every conv0 shape
    of the path, f32 and bf16, beside its plain version, the library's
    same function (channels-last cuDNN F.conv2d, then F.batch_norm eval
    and relu) and cuBLAS's bare GEMM of the same operands."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for b, hw, k, n, per_fwd in (CONV_EXPERIMENT,) + CONV_PATH:
            m = b * hw * hw
            err, share, t = conv_bn_case(ops, gen, m, k, n, dt)
            x, w, scale, shift = t["x"], t["w"], t["scale"], t["shift"]
            gamma, beta, mean, var = t["bn_vectors"]
            x4 = x.view(b, hw, hw, k).permute(0, 3, 1, 2)   # channels-last
            w4 = w.view(n, k, 1, 1)
            bms, by = bound(*conv_bn_work(m, k, n, dt), dt)
            rows.append({
                "M": m, "K": k, "N": n, "dtype": str(dt).replace("torch.", ""),
                "per_forward": per_fwd, "bn": t.get("bn"),
                "ctas": t.get("ctas"), "max_abs_err": err,
                "limit_share": share,
                "ms": time_ms(lambda: ops.conv1x1_bn_relu(x, w, scale,
                                                          shift)),
                "queued_ms": queued_ms(lambda: ops.conv1x1_bn_relu(
                    x, w, scale, shift)),
                "plain_ms": time_ms(lambda: ops.conv1x1_bn_relu_reference(
                    x, w, scale, shift)),
                "library_ms": time_ms(lambda: F.relu_(F.batch_norm(
                    F.conv2d(x4, w4), mean, var, gamma, beta, False, 0.0,
                    1e-5))),
                "cublas_gemm_ms": time_ms(lambda: torch.matmul(x, w.t())),
                "bound_ms": bms, "bound_by": by})
            del x, w, x4, w4, t
    emit({"phase": "conv_bn_main_shape", "rows": rows})
    return rows


def _resnet(ptt, dt, params):
    model = ptt.models.resnet50(num_classes=RESNET_CLASSES, device="cuda",
                                dtype=dt)
    model.load_state_dict(ptt.models.from_jax_state_dict(params))
    return model.eval()


def resnet_model_check(ptt, params):
    """Full-width ResNet-50 in f32 on the card against the same weights
    on the CPU (plain versions), B = 2 at 224."""
    x = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (2, 3, RESNET_HW, RESNET_HW)).astype(np.float32))
    model = _resnet(ptt, torch.float32, params)
    with torch.inference_mode():
        got = model(x.cuda()).cpu()
        cpu_model = ptt.models.resnet50(num_classes=RESNET_CLASSES,
                                        device="cpu")
        cpu_model.load_state_dict(model.state_dict())
        want = cpu_model.eval()(x)
    del model, cpu_model
    if got.shape != (2, RESNET_CLASSES) or not torch.isfinite(got).all():
        raise AssertionError("bad ResNet logits %s" % (tuple(got.shape),))
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, atol=RESNET_CARD_VS_CPU * scale,
                               rtol=RESNET_CARD_VS_CPU)
    emit({"phase": "resnet_model_check", "logits_shape": list(got.shape),
          "card_vs_cpu_max_abs_err": err, "logit_scale": scale,
          "atol": RESNET_CARD_VS_CPU * scale, "rtol": RESNET_CARD_VS_CPU})


def _counted_flops(ptt, model, images):
    """2 flops a multiply-add of every conv and the fc, from the shapes
    one forward of ``images`` gives each layer."""
    counted = [2 * model.fc.in_features * model.fc.out_features
               * images.shape[0]]

    def hook(mod, inp, out):
        cout, cin, kh, kw = mod._conv.weight.shape
        counted.append(2 * out.numel() * cin * kh * kw)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, ptt.models.ConvBNLayer)]
    model(images)
    for h in hooks:
        h.remove()
    return sum(counted)


def resnet_eval(ptt, params):
    """The serving path: ResNet-50 eval at B = 128, 224, f32 and bf16,
    RESNET_WARMUP batches then RESNET_BATCHES timed (host clock around
    each forward, ending in a synchronize).  Kernel 10 must launch 16
    times a forward.  Returns ({dtype: launch counts}, {dtype: model},
    the images)."""
    ops = ptt.ops
    gen = torch.Generator(device="cuda").manual_seed(12)
    images = torch.randn(RESNET_B, 3, RESNET_HW, RESNET_HW, device="cuda",
                         generator=gen)
    rows, launches, logits, models_ = {}, {}, {}, {}
    n_conv0 = sum(p for *_, p in CONV_PATH)
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).replace("torch.", "")
        t0 = time.perf_counter()
        model = _resnet(ptt, dt, params)
        setup_s = time.perf_counter() - t0
        with torch.inference_mode():
            flops_img = _counted_flops(ptt, model, images) / RESNET_B
            for _ in range(RESNET_WARMUP):
                logits[tag] = model(images)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            lat_ms = []
            for _ in range(RESNET_BATCHES):
                t0 = time.perf_counter()
                out = model(images)
                torch.cuda.synchronize()
                lat_ms.append((time.perf_counter() - t0) * 1e3)
            launches[tag] = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
        _expect_launches("ResNet-50 %s eval" % tag, launches[tag], {
            "conv_bn_relu": n_conv0 * RESNET_BATCHES, "conv_bn_stats": 0,
            "matmul_bias_act": 0, "flash_fwd": 0})
        if out.shape != (RESNET_B, RESNET_CLASSES) \
                or not torch.isfinite(out).all():
            raise AssertionError("bad %s logits" % tag)
        mean_s = float(np.mean(lat_ms)) / 1e3
        rows[tag] = {
            "setup_s": setup_s, "batch_ms": lat_ms,
            "batch_ms_p50": float(np.percentile(lat_ms, 50)),
            "batch_ms_p99": float(np.percentile(lat_ms, 99)),
            "images_per_s": RESNET_B / mean_s,
            "bench_flops_per_image": RESNET_BENCH_FLOPS,
            "counted_flops_per_image": flops_img,
            "bench_flops_share_of_peak": RESNET_BENCH_FLOPS * RESNET_B
            / mean_s / PEAK_FLOPS[dt],
            "counted_flops_share_of_peak": flops_img * RESNET_B / mean_s
            / PEAK_FLOPS[dt],
            "peak_tflops": PEAK_FLOPS[dt] / 1e12,
            "peak_memory_bytes": peak,
            "conv_bn_relu_launches_per_forward":
                launches[tag]["conv_bn_relu"] / RESNET_BATCHES}
        models_[tag] = model
    hi, lo = logits["float32"], logits["bfloat16"].float()
    rel = ((lo - hi).norm() / hi.norm()).item()
    if not rel <= RESNET_BF16_REL:
        raise AssertionError("bf16 logits %g from the f32 logits in "
                             "relative norm (limit %g)" % (rel,
                                                           RESNET_BF16_REL))
    emit({"phase": "resnet_eval", "B": RESNET_B, "HW": RESNET_HW,
          "classes": RESNET_CLASSES, "batches": RESNET_BATCHES,
          "bf16_vs_f32_logits_rel": rel, "bf16_rel_limit": RESNET_BF16_REL,
          **rows})
    return launches, models_, images


def resnet_profile(models_, images):
    """`device_profile` of one forward of each dtype at B = 128."""
    out = {}
    with torch.inference_mode():
        for tag, model in models_.items():
            out[tag] = device_profile(lambda: model(images))
    emit({"phase": "resnet_profile", "B": RESNET_B, **out})


def run_resnet(ptt):
    params = ptt.models.init_resnet_params(50, RESNET_CLASSES, seed=23,
                                           bn_stats="random")
    check_conv_bn(ptt.ops)
    conv_rows = check_conv_bn_main_shape(ptt.ops)
    resnet_model_check(ptt, params)
    launches, models_, images = resnet_eval(ptt, params)
    resnet_profile(models_, images)
    del models_, images
    return conv_rows, launches, params


# ---------------------------------------------------------------------------
# phase 6: the 1x1 conv + BN-statistics kernel and ResNet-50 training
# ---------------------------------------------------------------------------

# kernel 11's shapes in one ResNet-50 train step at B = 128, 224: (M, K,
# N, launches a step).  Every 1x1 stride-1 conv: each bottleneck's conv0
# (the first block of a stage sees the previous stage's width at the
# previous resolution) and conv2, and the first block's stride-1 short.
CONV_STATS_PATH = ((401408, 64, 64, 1), (401408, 64, 256, 4),
                   (401408, 256, 64, 2), (401408, 256, 128, 1),
                   (100352, 128, 512, 4), (100352, 512, 128, 3),
                   (100352, 512, 256, 1), (25088, 256, 1024, 6),
                   (25088, 1024, 256, 5), (25088, 1024, 512, 1),
                   (6272, 512, 2048, 3), (6272, 2048, 512, 2))
CONV_STATS_PER_STEP = sum(n for *_, n in CONV_STATS_PATH)     # 33
CONV_STATS_EXPERIMENT = (401408, 64, 256, 0)   # the experiment's shape
CONV_STATS_CANCEL = (100352, 64, 256)  # column 0: |mean| ~ 90 std
# the statistics against the plain version's (float64 sums of the f32
# product): mean within rtol of (|mean| + std), var within rtol of var.
# Both sides take them from an f32 product of the same operands (bf16
# upcast exactly); they differ by the order of its sums over K and M.  In
# f32 (FMA) that is ~1e-7 of the scale.  In bf16 the kernel's product
# comes from the tensor cores, whose f32 sums round differently again,
# ~2^-24 of the column mean an element: at |mean| ~ 90 std that moves
# var by up to 6.4e-6 (the worst of all cases on an H100).  The limits,
# 1e-5 in f32 and 5e-5 in bf16, sit far below the one-pass form's error
# in the cancellation case (8.3e-4 and 4.3e-3), which the check requires.
STATS_RTOL = {torch.float32: 1e-5, torch.bfloat16: 5e-5}
RESNET_TRAIN_STEPS, RESNET_TRAIN_WARMUP, RESNET_REPEAT_STEPS = 10, 2, 6
# bench.py:_bench_resnet's FLOP model: 3 x 4.089e9 an image, a train step
RESNET_TRAIN_FLOPS = 3 * RESNET_BENCH_FLOPS
RESNET_TRAIN_LR, RESNET_TRAIN_MU = 0.1, 0.9
# eval gradients through kernel 10 against its plain version on the
# card: the repo's f32 gradient policy; only conv0's forward sums differ
EVAL_GRAD_REL = 1e-4


def stats_errors(mean, var, mean_ref, var_ref):
    """(max |Δmean| / (|mean| + std), max |Δvar| / var) over the columns,
    against the reference statistics."""
    tiny = torch.finfo(torch.float32).tiny
    std = var_ref.clamp_min(0).sqrt()
    em = ((mean - mean_ref).abs() / (mean_ref.abs() + std + tiny)).max()
    ev = ((var - var_ref).abs() / (var_ref + tiny)).max()
    return em.item(), ev.item()


def conv_stats_case(ops, gen, m, k, n, dt, cancel=False):
    """Kernel 11 on one shape against its plain version on the same
    inputs (bf16 upcast exactly): y to `gemm_tol`, the statistics to
    STATS_RTOL, and a second launch's statistics bitwise equal to the
    first's.  ``cancel``: x's column 0 is 1 and w[0, 0] is 128, so y's
    column 0 has mean 128 and std ~1.4."""
    x = torch.randn(m, k, device="cuda", generator=gen)
    w = torch.randn(n, k, device="cuda", generator=gen) * (2.0 / k) ** 0.5
    if cancel:
        x[:, 0] = 1.0
        w[0, 0] = 128.0
    x, w = x.to(dt), w.to(dt)
    y, mean, var = ops.conv1x1_bn_stats(x, w)
    _, mean2, var2 = ops.conv1x1_bn_stats(x, w)
    torch.cuda.synchronize()
    tag = "conv_bn_stats M=%d K=%d N=%d %s%s" % (
        m, k, n, str(dt).replace("torch.", ""), " cancel" if cancel else "")
    if not (torch.equal(mean, mean2) and torch.equal(var, var2)):
        raise AssertionError("%s: two launches' statistics differ" % tag)
    sched = {}
    if dt == torch.bfloat16:
        outs, sched["bn"], sched["ctas"], _ = conv_grids(
            "conv_bn_stats", dict(x=x, w=w))
        if not all(torch.equal(a, b) for a, b in zip((y, mean, var), outs)):
            raise AssertionError("%s: the wrapper's outputs and the "
                                 "scheduled grid's differ" % tag)
    xf, wf = upcast(x, w)
    y_ref, mean_ref, var_ref = ops.conv1x1_bn_stats_reference(xf, wf)
    err, share = compare(tag + " y", y, y_ref, gemm_tol(dt, y_ref))
    em, ev = stats_errors(mean, var, mean_ref, var_ref)
    if not (em <= STATS_RTOL[dt] and ev <= STATS_RTOL[dt]
            and torch.isfinite(mean).all() and torch.isfinite(var).all()):
        raise AssertionError("%s: mean %g, var %g relative error (limit %g)"
                             % (tag, em, ev, STATS_RTOL[dt]))
    row = {"M": m, "K": k, "N": n, "dtype": str(dt).replace("torch.", ""),
           "cancel": cancel, **sched, "max_abs_err": err,
           "limit_share": share,
           "mean_rel_err": em, "var_rel_err": ev,
           "stats_rtol": STATS_RTOL[dt], "stats_bitwise_repeat": True}
    if cancel:   # what the one-pass form would give on the same product
        acc = torch.matmul(xf, wf.t())
        naive = acc.square().mean(0) - acc.mean(0).square()
        row["col0_mean_over_std"] = (mean_ref[0] / var_ref[0].sqrt()).item()
        row["naive_f32_var_rel_err_col0"] = (
            (naive[0] - var_ref[0]).abs() / var_ref[0]).item()
        del acc, naive
        if not row["naive_f32_var_rel_err_col0"] > STATS_RTOL[dt]:
            raise AssertionError(
                "%s: the one-pass form is off by only %g, inside the limit "
                "%g: the case cannot tell it from a right kernel"
                % (tag, row["naive_f32_var_rel_err_col0"], STATS_RTOL[dt]))
    return row, dict(x=x, w=w)


def conv_stats_width_case(ops, gen, m, k, n, bn):
    """Kernel 11 in bf16 at tile width ``bn`` on both grids
    (`conv_grids`) against its plain version; the partials' row tiles the
    library reports must be ceil(M / 128)."""
    from paddle_tpu_torch.ops import _build, matmul as mm

    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn(n, k, device="cuda", generator=gen)
         * (2.0 / k) ** 0.5).to(torch.bfloat16)
    (y, mean, var), _, ctas, tiles = conv_grids("conv_bn_stats",
                                                dict(x=x, w=w), bn)
    tag = "conv_bn_stats M=%d K=%d N=%d width %d" % (m, k, n, bn)
    part_tiles = _build.query("conv_bn_stats", "conv_bn_stats_part_tiles",
                              [ctypes.c_int] * 2, m,
                              _build.dtype_code(x))
    if part_tiles != -(-m // mm.FWD_ROWS):
        raise AssertionError("%s: %d row tiles of partials, not ceil(M / "
                             "%d)" % (tag, part_tiles, mm.FWD_ROWS))
    xf, wf = upcast(x, w)
    y_ref, mean_ref, var_ref = ops.conv1x1_bn_stats_reference(xf, wf)
    err, share = compare(tag + " y", y, y_ref,
                         gemm_tol(torch.bfloat16, y_ref))
    em, ev = stats_errors(mean, var, mean_ref, var_ref)
    if not (em <= STATS_RTOL[torch.bfloat16]
            and ev <= STATS_RTOL[torch.bfloat16]):
        raise AssertionError("%s: mean %g, var %g relative error (limit %g)"
                             % (tag, em, ev, STATS_RTOL[torch.bfloat16]))
    return {"M": m, "K": k, "N": n, "dtype": "bfloat16", "cancel": False,
            "bn": bn, "ctas": ctas, "tiles": tiles, "part_tiles": part_tiles,
            "max_abs_err": err, "limit_share": share, "mean_rel_err": em,
            "var_rel_err": ev, "stats_rtol": STATS_RTOL[torch.bfloat16],
            "bitwise_grids_and_launches": True}


def check_conv_bn_stats(ops):
    """Kernel 11 against its plain version, f32 and bf16, at the
    experiment's shape, the twelve shapes of the train path, a ragged
    shape and the cancellation case (bf16: at the scheduled width, on
    both grids, bitwise); then in bf16 every tile width at
    CONV_GRID_SHAPES."""
    from paddle_tpu_torch.ops import conv_bn as cb

    gen = torch.Generator(device="cuda").manual_seed(13)
    shapes = [(m, k, n) for m, k, n, _ in
              (CONV_STATS_EXPERIMENT,) + CONV_STATS_PATH] + [CONV_RAGGED]
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for m, k, n in shapes:
            rows.append(conv_stats_case(ops, gen, m, k, n, dt)[0])
        rows.append(conv_stats_case(ops, gen, *CONV_STATS_CANCEL, dt,
                                    cancel=True)[0])
    for m, k, n in CONV_GRID_SHAPES:
        for bn in cb.TILE_WIDTHS:
            rows.append(conv_stats_width_case(ops, gen, m, k, n, bn))
    emit({"phase": "conv_bn_stats_check", "cases": len(rows),
          "worst_limit_share": max(r["limit_share"] for r in rows),
          "worst_mean_rel_err": max(r["mean_rel_err"] for r in rows),
          "worst_var_rel_err": max(r["var_rel_err"] for r in rows),
          "rows": rows})
    return rows


def conv_stats_work(m, k, n, dt):
    """(bytes, flops) of kernel 11 at one shape: x and w read once, y
    written once, the f32 mean and var [N] written once; 2 flops a
    multiply-add."""
    elt = torch.tensor([], dtype=dt).element_size()
    return (m * k + n * k + m * n) * elt + 2 * n * 4, 2 * m * n * k


def check_conv_bn_stats_main_shape(ops):
    """Kernel 11 timed at the experiment's shape and at each shape of the
    train path, bf16 (the step's dtype), beside its plain version and
    the library's same function (torch.matmul, then torch.var_mean of
    the f32 upcast)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    dt = torch.bfloat16
    rows = []
    for m, k, n, per_step in (CONV_STATS_EXPERIMENT,) + CONV_STATS_PATH:
        row, t = conv_stats_case(ops, gen, m, k, n, dt)
        x, w = t["x"], t["w"]

        def library():
            y = torch.matmul(x, w.t())
            return y, torch.var_mean(y.float(), dim=0, unbiased=False)

        bms, by = bound(*conv_stats_work(m, k, n, dt), dt)
        row.update({
            "per_step": per_step,
            "ms": time_ms(lambda: ops.conv1x1_bn_stats(x, w)),
            "queued_ms": queued_ms(lambda: ops.conv1x1_bn_stats(x, w)),
            "plain_ms": time_ms(
                lambda: ops.conv1x1_bn_stats_reference(x, w)),
            "library_ms": time_ms(library),
            "cublas_gemm_ms": time_ms(lambda: torch.matmul(x, w.t())),
            "bound_ms": bms, "bound_by": by})
        rows.append(row)
        del x, w, t
    emit({"phase": "conv_bn_stats_main_shape", "dtype": "bfloat16",
          "rows": rows})
    return rows


def resnet_loss_fn(model, batch):
    """`bench.py:_bench_resnet`'s loss: the mean softmax cross entropy of
    the logits against int32 labels [B, 1]."""
    from paddle_tpu_torch.ops import nn_ops

    return nn_ops.softmax_with_cross_entropy(model(batch["image"]),
                                             batch["label"]).mean()


def _rel_errs(got, want):
    """{name: max |got - want| / max |want|} over two dicts of tensors."""
    out = {}
    for name, w in want.items():
        w = w.float().cpu()
        out[name] = ((got[name].float().cpu() - w).abs().max()
                     / w.abs().max().clamp_min(1e-30)).item()
    return out


def _check_rel(tag, errs, limit):
    worst = max(errs, key=errs.get)
    if not errs[worst] <= limit:
        raise AssertionError("%s: %s off by %g of its scale (limit %g)"
                             % (tag, worst, errs[worst], limit))
    return {"worst": worst, "worst_rel": errs[worst], "tensors": len(errs)}


class _relu_decisions:
    """Record the mask (x > 0) of every `Tensor.relu_` in call order, or,
    given the masks of another run, multiply by them instead, so that two
    runs of the same model take the same branch at every relu.  A relu
    whose input lies within rounding of zero otherwise takes one branch in
    one run and the other in the other, and in train-mode ResNet-50 a
    few such units move the gradients by up to a fifth of their scale
    (`tools/resnet_grad_resolution.py`)."""

    def __init__(self, force=None):
        self.force, self.masks = force, []

    def __enter__(self):
        self.real = torch.Tensor.relu_
        it = iter(self.force or ())

        def relu_(t):
            if self.force is not None:
                return t.mul_(next(it).to(t.device, t.dtype))
            self.masks.append(t > 0)
            return self.real(t)

        torch.Tensor.relu_ = relu_
        return self

    def __exit__(self, *exc):
        torch.Tensor.relu_ = self.real
        return False


def resnet_eval_grad(ptt, params):
    """The eval model under grad (ROADMAP Queue C 1): full-width
    ResNet-50, f32, B = 2 at 224, the forward and a backward of the
    logits against a fixed random projection on the card, once through
    kernel 10 (16 launches, its autograd backward) and once with its
    plain version in its place, on the kernel run's relu decisions
    (`_relu_decisions`; conv0's from kernel 10's own output); every
    parameter's gradient within EVAL_GRAD_REL of its scale."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.standard_normal(
        (2, 3, RESNET_HW, RESNET_HW)).astype(np.float32)).cuda()
    proj = torch.from_numpy(rng.standard_normal(
        (2, RESNET_CLASSES)).astype(np.float32)).cuda()
    model = _resnet(ptt, torch.float32, params)
    kernel, conv0 = ptt.ops.conv1x1_bn_relu, []

    def recording(x2d, w2d, scale, shift):
        y = kernel(x2d, w2d, scale, shift)
        conv0.append(y > 0)
        return y

    def plain(x2d, w2d, scale, shift):   # kernel 10's plain version
        acc = torch.matmul(x2d.float(), w2d.float().t())
        return ((acc * scale + shift) * conv0.pop(0)).to(x2d.dtype)

    grads, launches, relus = {}, {}, _relu_decisions()
    for tag, fn, dec in (("kernel", recording, relus),
                         ("plain", plain, None)):
        dec = dec or _relu_decisions(force=relus.masks)
        model.zero_grad(set_to_none=True)
        ptt.ops.reset_launch_counts()
        with patch.object(ptt.ops, "conv1x1_bn_relu", fn), dec:
            (model(x) * proj).sum().backward()
        torch.cuda.synchronize()
        launches[tag] = ptt.ops.launch_counts()
        grads[tag] = {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()}
    del model
    _expect_launches("ResNet-50 eval under grad", launches["kernel"], {
        "conv_bn_relu": sum(p for *_, p in CONV_PATH), "conv_bn_stats": 0})
    _expect_launches("ResNet-50 eval under grad, plain", launches["plain"],
                     {"conv_bn_relu": 0})
    worst = _check_rel("eval grads, kernel 10 vs its plain version",
                       _rel_errs(grads["kernel"], grads["plain"]),
                       EVAL_GRAD_REL)
    emit({"phase": "resnet_eval_grad", "B": 2, "HW": RESNET_HW,
          "grads": worst, "rel_limit": EVAL_GRAD_REL,
          "launches": launches["kernel"]})


def _resnet_train_step(ptt, model, amp=None, lr=None):
    return ptt.distributed.ShardedTrainStep(
        model, ptt.optimizer.MomentumOptimizer(
            learning_rate=RESNET_TRAIN_LR if lr is None else lr,
            momentum=RESNET_TRAIN_MU),
        resnet_loss_fn, mesh=None, zero_stage=0, amp=amp)


def resnet_train_model_check(ptt):
    """Full-width ResNet-50 (1000 classes), f32, B = 4 at 64x64, one
    Momentum(0.01, 0.9) step on the card (kernel 11 on the 33 1x1
    stride-1 convs) and on the CPU with the same weights: the loss, every
    gradient (the step's first Velocity), every new parameter and every
    running statistic within RESNET_CARD_VS_CPU of its scale.  The same
    step on the card with kernel 11's plain version in its place is held
    to the kernel's step at the same limit.  Both other runs take the
    card run's relu decisions (`_relu_decisions`): train-mode ResNet-50
    at initialization amplifies rounding over its 16 blocks.  The
    numbers are emitted before the limits are applied."""
    params = ptt.models.init_resnet_params(50, RESNET_CLASSES, seed=29,
                                           bn_stats="random")
    rng = np.random.RandomState(7)
    batch = {
        "image": rng.standard_normal((4, 3, 64, 64)).astype(np.float32),
        "label": rng.randint(0, RESNET_CLASSES, (4, 1)).astype(np.int32)}
    runs, relus = {}, _relu_decisions()
    for tag, dev, fn in (
            ("card", "cuda", ptt.ops.conv1x1_bn_stats),
            ("card_plain", "cuda", ptt.ops.conv1x1_bn_stats_reference),
            ("cpu", "cpu", ptt.ops.conv1x1_bn_stats)):
        model = ptt.models.resnet50(num_classes=RESNET_CLASSES, device=dev)
        model.load_state_dict(ptt.models.from_jax_state_dict(params))
        step = _resnet_train_step(ptt, model, lr=0.01)
        ptt.ops.reset_launch_counts()
        dec = relus if tag == "card" else _relu_decisions(force=relus.masks)
        with patch.object(ptt.ops, "conv1x1_bn_stats", fn), dec:
            state, loss = step(step.init(), batch)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[tag] = (loss.item(), {
            "grads": {n: st["Velocity"] for n, st in state["opt"].items()},
            "params": state["params"], "running_stats": state["buffers"]},
            ptt.ops.launch_counts())
        del model, step, state

    def errs(a, b):
        out = {"loss_abs_err": abs(runs[a][0] - runs[b][0])}
        for kind in ("grads", "params", "running_stats"):
            e = _rel_errs(runs[a][1][kind], runs[b][1][kind])
            worst = max(e, key=e.get)
            out[kind] = {"worst": worst, "worst_rel": e[worst]}
            if kind == "grads":
                out["bn_grads_worst_rel"] = max(
                    v for n, v in e.items() if "._bn." in n)
        return out

    vs_cpu, vs_plain = errs("card", "cpu"), errs("card", "card_plain")
    loss_c, loss_h = runs["card"][0], runs["cpu"][0]
    launches = runs["card"][2]
    emit({"phase": "resnet_train_model_check", "B": 4, "HW": 64,
          "classes": RESNET_CLASSES, "loss_card": loss_c,
          "loss_cpu": loss_h,
          "card_vs_cpu": vs_cpu, "card_vs_card_plain": vs_plain,
          "rel_limit": RESNET_CARD_VS_CPU,
          "launches": launches})
    _expect_launches("ResNet-50 train step (B=4, 64x64)", launches, {
        "conv_bn_stats": CONV_STATS_PER_STEP, "conv_bn_relu": 0})
    _expect_launches("ResNet-50 train step, plain", runs["card_plain"][2],
                     {"conv_bn_stats": 0})
    if not (np.isfinite(loss_c) and vs_cpu["loss_abs_err"]
            <= RESNET_CARD_VS_CPU * abs(loss_h)):
        raise AssertionError("ResNet-50 train loss: card %r, CPU %r"
                             % (loss_c, loss_h))
    for tag, res in (("card vs CPU", vs_cpu),
                     ("kernel 11 vs its plain version", vs_plain)):
        for kind in ("grads", "params", "running_stats"):
            if not res[kind]["worst_rel"] <= RESNET_CARD_VS_CPU:
                raise AssertionError(
                    "ResNet-50 train step %s: %s %s off by %g of its scale "
                    "(limit %g)" % (tag, kind, res[kind]["worst"],
                                    res[kind]["worst_rel"],
                                    RESNET_CARD_VS_CPU))


def resnet_train(ptt):
    """`bench.py:_bench_resnet`'s step on the port: ResNet-50, 1000
    classes, B = 128, 224x224 f32 images and int32 labels [B, 1] (two
    batches from RandomState(0), as bench.py:651-656 makes them),
    Momentum(0.1, 0.9), ShardedTrainStep(zero_stage=0, amp="bf16").
    RESNET_TRAIN_WARMUP steps, then RESNET_TRAIN_STEPS timed with CUDA
    events; kernel 11 must launch 33 times a step; the losses must be
    finite and fall over RESNET_REPEAT_STEPS on one repeated batch.
    Returns (launches, the step, a state, the batches)."""
    models, ops = ptt.models, ptt.ops
    t0 = time.perf_counter()
    model = models.resnet50(num_classes=RESNET_CLASSES, device="cuda")
    model.load_state_dict(models.from_jax_state_dict(
        models.init_resnet_params(50, RESNET_CLASSES, seed=31)))
    step = _resnet_train_step(ptt, model, amp="bf16")
    state0 = step.init()
    rng = np.random.RandomState(0)
    batches = [step.place_batch({
        "image": rng.randn(RESNET_B, 3, RESNET_HW, RESNET_HW).astype(
            np.float32),
        "label": rng.randint(0, RESNET_CLASSES, (RESNET_B, 1)).astype(
            np.int32)}) for _ in range(2)]
    setup_s = time.perf_counter() - t0

    state, warm_losses, _ = _run_steps(step, state0, batches,
                                       list(range(RESNET_TRAIN_WARMUP)))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses, step_ms = _run_steps(
        step, state, batches, [n % 2 for n in range(RESNET_TRAIN_STEPS)])
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    _expect_launches("ResNet-50 train run", launches, {
        "conv_bn_stats": CONV_STATS_PER_STEP * RESNET_TRAIN_STEPS,
        "conv_bn_relu": 0, "matmul_bias_act": 0, "flash_fwd": 0})
    all_losses = warm_losses + losses
    if not np.isfinite(all_losses).all():
        raise AssertionError("non-finite ResNet training loss: %s"
                             % all_losses)
    _, repeat_losses, _ = _run_steps(step, state0, batches,
                                     [0] * RESNET_REPEAT_STEPS)
    if not (np.isfinite(repeat_losses).all()
            and repeat_losses[-1] < repeat_losses[0]):
        raise AssertionError("the ResNet loss did not fall on one repeated "
                             "batch: %s" % repeat_losses)
    moved = max((state["buffers"][k] - state0["buffers"][k]).abs().max()
                .item() for k in state0["buffers"])
    if not moved > 0:
        raise AssertionError("the running statistics never moved")
    mean_s = float(np.mean(step_ms)) / 1e3
    emit({"phase": "resnet_train", "B": RESNET_B, "HW": RESNET_HW,
          "classes": RESNET_CLASSES, "amp": "bf16",
          "optimizer": "Momentum(%g, %g)" % (RESNET_TRAIN_LR,
                                             RESNET_TRAIN_MU),
          "setup_s": setup_s, "steps": RESNET_TRAIN_STEPS,
          "step_ms": step_ms,
          "step_ms_p50": float(np.percentile(step_ms, 50)),
          "step_ms_p99": float(np.percentile(step_ms, 99)),
          "images_per_s": RESNET_B / mean_s,
          "host_wall_images_per_s": RESNET_B * RESNET_TRAIN_STEPS / wall_s,
          "bench_flops_per_image": RESNET_TRAIN_FLOPS,
          "bench_flops_share_of_989tf": RESNET_TRAIN_FLOPS * RESNET_B
          / mean_s / PEAK_FLOPS[torch.bfloat16],
          "peak_memory_bytes": peak_mem, "losses": all_losses,
          "repeat_batch_losses": repeat_losses,
          "running_stats_max_move": moved,
          "conv_bn_stats_launches_per_step":
              launches["conv_bn_stats"] / RESNET_TRAIN_STEPS,
          "launches": launches})
    return launches, step, state, batches


def run_resnet_train(ptt, params):
    stats_rows = check_conv_bn_stats(ptt.ops)
    main_rows = check_conv_bn_stats_main_shape(ptt.ops)
    resnet_eval_grad(ptt, params)
    resnet_train_model_check(ptt)
    launches, step, state, batches = resnet_train(ptt)
    emit({"phase": "resnet_train_profile", "B": RESNET_B, "steps": 1,
          **device_profile(lambda: step(state, batches[0]))})
    return stats_rows, main_rows, launches


# the kernels on gemm_tc.cuh's forward body and the split decode, whose
# ptxas report the build phase lists on its own (none may spill)
REDESIGNED_KERNELS = ("matmul_fwd_tc", "conv_bn_relu_tc", "conv_bn_stats_tc",
                      "decode_dense_kernel", "decode_paged_kernel")


def ptxas_summary(logs, names):
    """{function: {"registers": n, "spill_bytes": n}} from nvcc's
    -Xptxas -v output, for the functions whose mangled name holds one
    of ``names``."""
    import re

    out, fn = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                fn = m.group(1) if any(k in m.group(1) for k in names) \
                    else None
            elif fn and "spill stores" in ln:
                out.setdefault(fn, {})["spill_bytes"] = int(re.search(
                    r"(\d+) bytes spill stores", ln).group(1))
            elif fn and "Used" in ln and "registers" in ln:
                out.setdefault(fn, {})["registers"] = int(re.search(
                    r"Used (\d+) registers", ln).group(1))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "settings",
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "bound_hbm_tb_per_s": HBM_BYTES_PER_S / 1e12,
          "bound_peak_tflops": {str(k).replace("torch.", ""): v / 1e12
                                for k, v in PEAK_FLOPS.items()}})

    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Function properties" in ln]
             for name, log in _build.build_logs.items()}
    redesigned = ptxas_summary(_build.build_logs, REDESIGNED_KERNELS)
    emit({"phase": "build", "seconds": build_s,
          "libraries": {k: str(v) for k, v in paths.items()},
          "redesigned_kernels_ptxas": redesigned, "ptxas": ptxas})
    spilled = [f for f, r in redesigned.items() if r["spill_bytes"] and any(
        k in f for k in ("matmul_fwd_tc", "conv_bn_relu_tc",
                         "conv_bn_stats_tc"))]
    if spilled:
        raise AssertionError("the forward body spills: %s" % spilled)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "card", "nvidia_smi": smi})

    ops = ptt.ops
    flash_rows = check_flash(ops)
    d128_rows = check_flash_d128(ops)
    check_flash_train(ops)
    bwd_d128_rows = check_flash_bwd_d128(ops)
    main = check_flash_main_shape(ops)
    check_bwd_crossover(ops)
    dense_row, paged_row = check_decode(ops)
    check_matmul(ops)
    mm_main = check_matmul_main_shape(ops)
    train_model_check(ptt)
    train_launches, pair_launches, ffn_launches = train(ptt)
    launches = run_engine(ptt)
    conv_rows, resnet_launches, resnet_params = run_resnet(ptt)
    stats_rows, stats_main, train_launches11 = run_resnet_train(
        ptt, resnet_params)

    prefill = next(r for r in flash_rows
                   if r["S"] == 1024 and r["dtype"] == "float32"
                   and not r["strided_qkv"])
    err, bounds = main["max_abs_err"], main["bounds"]
    src = "paddle_tpu_torch/ops/csrc/"
    pallas = "paddle_tpu/ops/pallas/attention.py:"

    def flash_entry(name, source, line, n, max_abs_err, ms, plain_ms,
                    library_ms):
        return dict(name=name, route="cuda", source=src + source,
                    replaces=pallas + line, launches=n,
                    max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bounds[name][0], bound_by=bounds[name][1],
                    library_ms=library_ms)

    def d128_bwd(ms, tags):
        """A pair kernel's bf16 cases at D = 128: ms, the largest error
        of ``tags``, and SDPA's whole backward beside them."""
        return [dict(S=r["S"], causal=r["causal"], ms=r[ms],
                     library_bwd_ms=r["library_bwd_ms"],
                     max_abs_err=max(r["max_abs_err"][t] for t in tags))
                for r in bwd_d128_rows if r["dtype"] == "bfloat16"]

    # the flash kernels at the training step's shape (B=60, S=512, bf16),
    # launches over the timed train run (the pair's over its own run);
    # the backward kernels' library yardstick is SDPA's whole backward
    kernels = [
        dict(flash_entry("flash_fwd", "flash_fwd.cu", "196",
                         train_launches["flash_fwd"], err["o"],
                         main["fwd_ms"], main["plain_fwd_ms"],
                         main["library_fwd_ms"]),
             d128=[{k: r[k] for k in ("S", "causal", "masked", "ms",
                                      "library_ms", "bound_ms",
                                      "max_abs_err")} for r in d128_rows],
             engine_prefill={"launches": launches["flash_fwd"],
                             **{k: prefill[k] for k in (
                                 "S", "dtype", "max_abs_err", "ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}}),
        dict(flash_entry("flash_bwd_dq", "flash_bwd.cu", "343",
                         pair_launches["flash_bwd_dq"], err["pair_dq"],
                         main["dq_ms"], main["plain_bwd_ms"],
                         main["library_bwd_ms"]),
             d128=d128_bwd("dq_ms", ("pair_dq", "pair_delta"))),
        dict(flash_entry("flash_bwd_dkv", "flash_bwd.cu", "399",
                         pair_launches["flash_bwd_dkv"],
                         max(err["pair_dk"], err["pair_dv"]), main["dkv_ms"],
                         main["plain_bwd_ms"], main["library_bwd_ms"]),
             d128=d128_bwd("dkv_ms", ("pair_dk", "pair_dv"))),
        flash_entry("flash_bwd_fused", "flash_bwd_fused.cu", "490",
                    train_launches["flash_bwd_fused"],
                    max(err["fused_dq"], err["fused_dk"], err["fused_dv"]),
                    main["fused_ms"], main["plain_bwd_ms"],
                    main["library_bwd_ms"]),
        dict(name="decode_attention", route="cuda",
             source=src + "decode_attention.cu",
             replaces="paddle_tpu/ops/pallas/decode_attention.py:73",
             launches=launches["decode_attention"], **dense_row),
        dict(name="paged_attention", route="cuda",
             source=src + "paged_attention.cu",
             replaces="paddle_tpu/ops/pallas/paged_attention.py:153",
             launches=launches["paged_attention"], **paged_row),
    ]

    # the fused-epilogue GEMM kernels at the FFN's shape (M = 30720, K =
    # 768, N = 3072, bf16, gelu), launches over the fused-FFN train run
    mm_err, mm_bounds = mm_main["max_abs_err"], mm_main["bounds"]

    def mm_entry(name, source, line, max_abs_err, tag):
        return dict(name=name, route="cuda", source=src + source,
                    replaces="paddle_tpu/ops/pallas/matmul.py:" + line,
                    launches=ffn_launches[name], max_abs_err=max_abs_err,
                    ms=mm_main[tag + "_ms"],
                    plain_ms=mm_main["plain_%s_ms" % tag],
                    bound_ms=mm_bounds[name][0], bound_by=mm_bounds[name][1],
                    library_ms=mm_main["library_%s_ms" % tag])

    kernels += [
        dict(mm_entry("matmul_bias_act", "matmul_bias_act.cu", "200",
                      max(mm_err["y"], mm_err["z"]), "fwd"),
             tile=mm_main["fwd_tile"],
             schedule="%d CTAs over %d tiles" % (mm_main["fwd_ctas"],
                                                 mm_main["fwd_tiles"]),
             cublas_gemm_ms=mm_main["cublas_gemm_ms"]["fwd"]),
        dict(mm_entry("matmul_bwd_dx", "matmul_bwd.cu", "272", mm_err["dx"],
                      "dx"), tile=mm_main["bwd_tile"], splits=1),
        dict(mm_entry("matmul_bwd_dw", "matmul_bwd.cu", "296",
                      max(mm_err["dw"], mm_err["dbias"]), "dw"),
             tile=mm_main["bwd_tile"], splits=mm_main["dw_splits"]),
    ]

    # the 1x1 conv + BN + relu kernel over one bf16 ResNet-50 forward at
    # B = 128: each conv0 shape's time weighted by its launches a forward
    # (16 in all); launches over the timed 10-batch bf16 eval run
    path = [r for r in conv_rows if r["dtype"] == "bfloat16"
            and r["per_forward"]]

    def fwd_sum(key):
        return sum(r[key] * r["per_forward"] for r in path)

    work = [(conv_bn_work(r["M"], r["K"], r["N"], torch.bfloat16),
             r["per_forward"]) for r in path]
    t_bytes = sum(w[0] * n for w, n in work) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(w[1] * n for w, n in work) / PEAK_FLOPS[torch.bfloat16] * 1e3
    keep = ("M", "K", "N", "dtype", "per_forward", "bn", "ctas",
            "max_abs_err", "ms", "queued_ms", "plain_ms", "library_ms",
            "cublas_gemm_ms", "bound_ms", "bound_by")
    kernels.append(dict(
        name="conv_bn_relu", route="cuda", source=src + "conv_bn_relu.cu",
        replaces="benchmarks/fused_conv_bn_relu_experiment.py:32",
        launches=resnet_launches["bfloat16"]["conv_bn_relu"],
        max_abs_err=max(r["max_abs_err"] for r in path),
        ms=fwd_sum("ms"), queued_ms=fwd_sum("queued_ms"),
        plain_ms=fwd_sum("plain_ms"), bound_ms=fwd_sum("bound_ms"),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=fwd_sum("library_ms"), cublas_gemm_ms=fwd_sum(
            "cublas_gemm_ms"),
        f32_launches=resnet_launches["float32"]["conv_bn_relu"],
        per_shape=[{k: r[k] for k in keep} for r in conv_rows]))

    # the 1x1 conv + BN-statistics kernel over one bf16 ResNet-50 train
    # step at B = 128: each shape's time weighted by its launches a step
    # (33 in all); launches over the 10 timed steps
    path11 = [r for r in stats_main if r["per_step"]]

    def step_sum(key):
        return sum(r[key] * r["per_step"] for r in path11)

    work = [(conv_stats_work(r["M"], r["K"], r["N"], torch.bfloat16),
             r["per_step"]) for r in path11]
    t_bytes = sum(w[0] * n for w, n in work) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(w[1] * n for w, n in work) / PEAK_FLOPS[torch.bfloat16] * 1e3
    keep11 = ("M", "K", "N", "per_step", "bn", "ctas", "max_abs_err",
              "mean_rel_err", "var_rel_err", "ms", "queued_ms", "plain_ms",
              "library_ms", "cublas_gemm_ms", "bound_ms", "bound_by")
    kernels.append(dict(
        name="conv_bn_stats", route="cuda", source=src + "conv_bn_stats.cu",
        replaces="benchmarks/fused_conv_bn_relu_experiment.py:141",
        launches=train_launches11["conv_bn_stats"],
        max_abs_err=max(r["max_abs_err"] for r in path11),
        ms=step_sum("ms"), queued_ms=step_sum("queued_ms"),
        plain_ms=step_sum("plain_ms"), bound_ms=step_sum("bound_ms"),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=step_sum("library_ms"),
        cublas_gemm_ms=step_sum("cublas_gemm_ms"),
        stats_max_rel_err=max(max(r["mean_rel_err"], r["var_rel_err"])
                              for r in stats_rows),
        per_shape=[{k: r[k] for k in keep11} for r in stats_main]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
