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
63, a bf16 shape whose M splits raggedly, an f32 one with odd K and N,
and the BERT FFN's own shape,
each backward launched twice for bitwise-equal outputs); times the fused against the pair backward over
B*H around the SM count; runs full-width BERT-base once on the card and
on the CPU with the same weights, with the default FFN and with
PADDLE_TPU_FUSED_FFN=1; trains it as `bench.py`'s flagship step does
(B=60, S=512, bf16, ShardedTrainStep + AdamW), fused and pair flash
backward and the fused-epilogue FFN, with a profile of one step of each
FFN; holds the train step's knobs at BERT-base's widths over 2 layers
(remat, accumulate_steps, donation, the FLOP count against the CPU's)
and trains BERT-base under LAMB with remat over two micro-batches,
reading cost_analysis's FLOPs; then serves a full-width TransformerLM through the paged generation
engine and checks the streams against the port's sequential oracle and
the dense engine; holds the engine's chunk path (more than one query
row over the paged cache: 128-token chunks, and a prefix hit whose
padded suffix runs past max_len) against the whole-prompt flash
prefill, and serves shared-system-prompt traffic through the prefix
cache with logprobs (greedy tokens and logprobs against a full causal
forward) and phase 4's traffic through 128-token chunks (every stream
against the sequential oracle with the same knob), through an int8 KV
pool and with a draft model; then serves phase 4's traffic through the
serving tier: a two-replica GenerationFleet, a canary weight swap, the
HTTP front driven by tools/generation_ctl.py, a replica-death requeue
drill, and a disaggregated prefill / decode pair in f32 and int8 whose
decode engine launches no flash kernel (every stream phase 4's, or the
int8 engine's); last, holds the 1x1 conv + BN + relu kernel against
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
kernel-11 launches a step), with a profile of one step; then trains
ResNet-50 in f32 through the eager ``minimize`` path (LarsMomentum,
L2Decay, a global-norm clip, a piecewise learning rate) and holds an
eager Momentum step against the train step's; last, builds BERT-base as
a static program (`models.bert_program`), saves it with the static
core's `save_inference_model` and serves it through `create_predictor`
with `matmul_bias_act_fuse` at B = 1, 4 and 8 (12 kernel-1 and 13
kernel-5 launches a forward, the kernels on the path's arguments and
one batch against the plain versions, p50 and a profile a batch size);
then builds BERT-base pretraining as a static program
(`models.bert_pretraining_program`: MLM over 20 masked positions, NSP,
AdamW) and trains it through the Executor (B = 32, S = 128, f32,
dropout 0.1, the fused FFN): kernels 1, 4 (or 2 and 3), 5, 6 and 7
once a layer a step, falling losses, one dropout-0 step against the
plain versions, the inference clone against the training forward, p50
/ p99, tokens/s, model TFLOP/s, peak memory, a profiled step and the
path's kernels at its shapes; last, builds the Fluid book's
recognize_digits (LeNet-5) and image_classification (VGG-16 with batch
norm) programs with the static core's layers, trains them through the
Executor on the book's datasets (B = 64 and 128, f32, Adam: falling
losses, the test clone's accuracy, moving running statistics, one step
against the CPU's), saves them and serves them through
`create_predictor` (LeNet-5 with `matmul_bias_act_fuse`: 2 kernel-5
launches a forward, kernel 5 at its two fc shapes against its plain
version; VGG-16-BN with `batch_norm_act_fuse`: no kernel launch), with
p50 / p99, images/s, peak memory and a profiled VGG step; last, builds
the book's word2vec (four lookups of one shared table, concat, fc 256
sigmoid, fc softmax) and recommender_system (two embedding towers, fc
200 tanh each, cos_sim) programs with the static core's layers, trains
them through the Executor on `dataset.imikolov` and `dataset.movielens`
(B = 32 and 256, f32, SGD: falling losses, one step against the CPU's
with every gradient), serves them through `create_predictor` with
`matmul_bias_act_fuse` (word2vec: no kernel launch; the recommender: 2
kernel-5 launches a forward, tanh, kernel 5 at both tower shapes
against its plain version), and runs every op of `fluid.layers.ops`
and its gradient on the card against the CPU; last, builds the WMT
Transformer-base (512 / 8 / 6 + 6 / 2048 / 32000) as a static program
(`models.transformer_program`) and trains it through the Executor by
"Attention Is All You Need"'s recipe (Adam(0.9, 0.98, 1e-9) on
noam_decay(512, 4000), label smoothing 0.1, dropout 0.1; B = 32 pairs
of 128 padded source and 120 target tokens, f32): 18 kernel-1 and 18
backward launches a step (kernel 4, or 2 and 3, as the dispatch picks
for each of the encoder self, decoder causal self and cross
attentions), the step counter and the noam rate against float64, one
dropout-0 step against the plain versions on one run's relu
decisions, a short-warmup program whose loss falls, kernels 1 and 4 at
the three attention shapes, the trained logits served with
`matmul_bias_act_fuse` (18 kernel-1 and 12 kernel-5 launches a
forward, fused = unfused) with p50 and kernel 5 at its fc1 shapes, and
every op of the rest of `fluid.layers.tensor` and its gradient on the
card against the CPU.  The static BERT is served BHSD too (the
reference's transposes around kernel 1), equal to BSHD.  Then the same
Transformer-base as the eager `models.Transformer` (`eager_transformer`):
the repaired index ops at bad ids, card against CPU; the reference's
eager f32 recipe (18 kernel-1 launches a step and the dispatch's
backward), one dropout-0 step against the plain versions, the eager
forward against the static program; 10 bf16 `ShardedTrainStep` steps,
the first one's loss and gradients against the plain versions at the
bf16 policy; served at B = 1 and 32.  Last the eager vision zoo
(`eager_vision`): MobileNetV1 served in f32 (13 kernel-10 launches) and
trained in bf16 (13 kernel-11 launches a step), VGG-16-BN and LeNet-5.

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
The f32 GEMM backward (kernels 6 and 7, a 3xTF32 split on the tensor
cores) is also held, at the static step's shape, to at most 4 times the
plain version's distance from a float64 product.
Bounds: the larger of bytes / 3.35 TB/s and flops / the least time the
card could take for them, from the H100 SXM data sheet: 989 TFLOP/s
bf16 (the tensor cores); f32 as three TF32 products at 495 TFLOP/s,
165 TFLOP/s (the fastest f32-accurate product the card has; its FMA
rate, 67 TFLOP/s, is no floor).  `bound_by` names the larger term,
"bytes" or "operations"; the settings line names the rates.
"""

import contextlib
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
# the rates bound() takes: f32 as 3xTF32 (three TF32 products at 495)
BOUND_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
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
    t_ops = flops / BOUND_FLOPS[dtype] * 1e3
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
    retained graph) and forward+backward at the same shapes (Sq and Sk
    may differ), with the bias and masks as one float mask: the
    yardstick, timed only."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    mask = None
    if bias is not None or segs is not None:
        b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
        mask = torch.zeros(b, 1, sq, sk, device=q.device)
        if bias is not None:
            mask = mask + bias
        if segs is not None:
            same = segs[0][:, None, :, None] == segs[1][:, None, None, :]
            mask = torch.where(same, mask, -1e30)
        if causal:
            vis = torch.ones(sq, sk, dtype=torch.bool,
                             device=q.device).tril(sk - sq)
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
    50 calls queued behind a sleep (`queued_ms`): at small B*H a call's
    host time exceeds the card's, and back-to-back events would read
    the host's jitter.  Times only; the kernels' values are checked
    above."""
    from paddle_tpu_torch.ops.attention import _use_fused_bwd

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for b, s in ((1, 512), (2, 512), (10, 512), (11, 512), (12, 512),
                 (22, 512), (60, 512), (1, 448), (2, 128), (60, 128)):
        q, k, v, do = (torch.randn(b, s, H, D, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = ops.flash_fwd(q, k, v, with_lse=True)

        fused_ms = queued_ms(
            lambda: ops.flash_bwd_fused(q, k, v, o, do, lse), iters=50)
        with _env("PADDLE_TPU_FLASH_FUSED_BWD", "0"):
            pair_ms = queued_ms(lambda: ops.flash_attention_bwd(
                q, k, v, o, do, lse), iters=50)
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
                  bs=DECODE_BS, stale=False, h=H):
    """One decode step's operands: q [N, h, d], K and V pools [N * t / bs
    + 1, bs, h, d] shuffled so that slot n's live blocks are scattered
    pool blocks, tables whose entries past ceil(len / bs) are 0 (the
    garbage block) or, with ``stale``, other slots' live blocks, the
    gathered dense caches and the int32 lengths."""
    n, mb = len(lengths_l), t // bs
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device="cuda")
    q = torch.randn(n, h, d, device="cuda", generator=gen).to(dt)
    nb = n * mb + 1
    k_pool = torch.randn(nb, bs, h, d, device="cuda", generator=gen).to(dt)
    v_pool = torch.randn(nb, bs, h, d, device="cuda", generator=gen).to(dt)
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


def decode_bytes(lengths_l, d, dt, bs=DECODE_BS, h=H):
    """(bytes, flops) of one decode step: q and the output, each live K
    and V row once, the lengths (the paged kernel adds its live table
    entries: 4 bytes a live block)."""
    elt = torch.finfo(dt).bits // 8
    live = sum(lengths_l)
    nbytes = 2 * len(lengths_l) * h * d * elt + 2 * live * h * d * elt \
        + 4 * len(lengths_l)
    return nbytes, 4 * live * h * d


def decode_case(ops, gen, lengths_l, d=D, dt=torch.float32, stale=False,
                h=H):
    """The dense and paged kernels on one step, each launched twice:
    raises unless the four outputs are bitwise equal, an empty slot
    emits zeros and both lie within TOL of their plain versions (f32,
    on the same inputs upcast).  Returns (error, limit share, operands)."""
    q, k_pool, v_pool, tables, k_dense, v_dense, lengths = decode_inputs(
        ops, gen, lengths_l, d, dt, stale=stale, h=h)
    scale = d ** -0.5
    name = "decode N=%d H=%d D=%d %s%s" % (len(lengths_l), h, d,
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


# the speculative engine's draft model (`generation_bench.py:254-263`):
# hidden 256 in 4 heads of 64, 2 layers; its prefill runs kernel 1 and
# its decode kernel 8 at 4 heads, where every other phase runs 12
DRAFT_H, DRAFT_LAYERS, DRAFT_LEN = 4, 2, 3


def check_draft_kernels(ops):
    """Kernel 8 at the draft's decode shape (8 slots of a 1024-position
    dense cache, 4 heads, f32, phase 2's lengths) and kernel 1 at its
    prefill shape (B=1, S=1024, 4 heads, f32, causal), each against its
    plain version within TOL, timed beside its bound and its library
    call."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.decode_attention import decode_head_groups

    gen = torch.Generator(device="cuda").manual_seed(4)
    lengths_l = list(DECODE_LENGTHS)
    t, dt = DECODE_T, torch.float32
    err, share, ins = decode_case(ops, gen, lengths_l, h=DRAFT_H)
    q, _, _, _, k_dense, v_dense, lengths, scale = ins
    mask = (torch.arange(t, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    qs = q[:, :, None]
    kt, vt = k_dense.transpose(1, 2), v_dense.transpose(1, 2)
    call = lambda: ops.decode_attention(  # noqa: E731
        q, k_dense, v_dense, lengths, scale=scale)
    plain = lambda: ops.decode_attention_reference(  # noqa: E731
        q, k_dense, v_dense, lengths, scale)
    bms, by = bound(*decode_bytes(lengths_l, D, dt, h=DRAFT_H), dt)
    decode_row = {
        "N": len(lengths_l), "T": t, "H": DRAFT_H, "D": D,
        "dtype": "float32", "lengths": lengths_l,
        "heads_a_cta": decode_head_groups(DRAFT_H),
        "max_abs_err": err, "limit_share": share,
        "ms": queued_ms(call), "call_ms": time_ms(call),
        "plain_ms": queued_ms(plain),
        "library_ms": queued_ms(lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, scale=scale)),
        "bound_ms": bms, "bound_by": by}

    s = 1024
    qf, kf, vf = (torch.randn(1, s, DRAFT_H, D, device="cuda", generator=gen)
                  for _ in range(3))
    out = ops.flash_attention(qf, kf, vf, scale=scale, causal=True)
    want = ops.flash_attention_reference(qf, kf, vf, scale=scale,
                                         causal=True)[0]
    torch.cuda.synchronize()
    ferr, fshare = compare("draft flash S=%d H=%d" % (s, DRAFT_H), out, want,
                           TOL[dt])
    fcall = lambda: ops.flash_attention(  # noqa: E731
        qf, kf, vf, scale=scale, causal=True)
    qt, kt2, vt2 = (x.transpose(1, 2) for x in (qf, kf, vf))
    fbms, fby = bound(4 * s * DRAFT_H * D * 4,
                      4 * DRAFT_H * D * s * (s + 1) // 2, dt)
    flash_row = {
        "B": 1, "S": s, "H": DRAFT_H, "D": D, "dtype": "float32",
        "causal": True, "max_abs_err": ferr, "limit_share": fshare,
        "ms": time_ms(fcall), "queued_ms": queued_ms(fcall),
        "plain_ms": time_ms(lambda: ops.flash_attention_reference(
            qf, kf, vf, scale=scale, causal=True)[0]),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt2, vt2, is_causal=True, scale=scale)),
        "bound_ms": fbms, "bound_by": fby}
    emit({"phase": "draft_kernels", "tol": {"atol": TOL[dt]["atol"],
                                            "rtol": TOL[dt]["rtol"]},
          "decode_attention": decode_row, "flash_fwd": flash_row})
    return decode_row, flash_row


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
# sees only zero rows); bf16 only, one whose M is not a multiple of its
# dW split's chunk (`dw_split_plan`: 9 chunks of 448 rows); f32 only,
# one whose K and N are odd (the f32 backward's 4-byte copies)
MM_SHAPES = ((256, 128, 384), (777, 264, 200), (1, 768, 3072),
             (63, 264, 200))
MM_SPLIT_SHAPE = (4000, 256, 512)
MM_F32_ODD_SHAPE = (129, 263, 201)


def check_matmul(ops):
    """Kernels 5-7 against their plain versions at small shapes
    (MM_SHAPES, f32 and bf16; MM_SPLIT_SHAPE, bf16; MM_F32_ODD_SHAPE,
    f32): the five activations, with and without a bias, z emitted and
    not, each backward twice for bitwise-equal outputs."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        shapes = MM_SHAPES + ((MM_SPLIT_SHAPE,) if dt == torch.bfloat16
                              else (MM_F32_ODD_SHAPE,))
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
    # runs that chain their states donate them (each from its own
    # init(), equal to state0); the single steps from state0 reuse it
    step, keep = (ptt.distributed.ShardedTrainStep(
        model, ptt.optimizer.AdamWOptimizer(learning_rate=1e-4,
                                            weight_decay=0.01),
        bert_loss_fn, mesh=None, zero_stage=0, amp="bf16", donate=donate)
        for donate in (True, False))
    state0 = keep.init()
    rng = np.random.RandomState(0)
    batches = [step.place_batch(make_bert_batch(rng, cfg, b, s, p))
               for _ in range(4)]
    flops = flops_per_step(cfg, state0["params"], b, s, p)
    setup_s = time.perf_counter() - t0
    L = cfg.num_hidden_layers

    state, warm_losses, _ = _run_steps(step, step.init(), batches, [0, 1])
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
        _, pair_losses, pair_ms = _run_steps(step, step.init(), batches,
                                             list(range(PAIR_STEPS)))
        pair_launches = ops.launch_counts()
        pair_first, _ = keep(state0, batches[0])
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
    fused_first, _ = keep(state0, batches[0])
    grad_errs = _grad_rel(fused_first, pair_first, _grad_names(L),
                          PAIR_GRAD_REL, "fused vs pair")
    del pair_first

    # the fused-epilogue FFN: the same step from state0 with
    # PADDLE_TPU_FUSED_FFN=1, its first FFN_STEPS losses held against the
    # default run's on the same batches
    with _env("PADDLE_TPU_FUSED_FFN", "1"):
        ops.reset_launch_counts()
        ffn_state, ffn_losses, ffn_ms = _run_steps(
            step, step.init(), batches, list(range(FFN_STEPS)))
        ffn_launches = ops.launch_counts()
        ffn_prof = device_profile(lambda: step(ffn_state, batches[0]))
        ffn_first, _ = keep(state0, batches[0])
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
        bert_loss_fn, mesh=None, zero_stage=0, amp=None,
        donate=False)(state0, batches[0])
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
# phase 3b: the rest of the train step (LAMB, remat, accumulation,
# donation, cost_analysis)
# ---------------------------------------------------------------------------

LAMB_ACCUM = 2
# train_knobs_check: BERT-base's widths at 2 layers, f32, B=8, S=512,
# P=80.  Runs that take the same arithmetic are held bitwise (losses
# with and without remat, donated and copied states); the new
# parameters and LAMB moments with and without remat, and the k=2
# against k=1 step, within 1e-5 of each tensor's largest entry (the
# gradient's summation order moves f32 results by ~1e-7 of their
# scale; a wrong micro-batch mean or a lost recompute term moves them
# by 1e-2 and more); donation's memory within 2% of the slots' bytes.
# The k=2 step's updates (SGD at lr 1: the gradients) within 1e-4 of
# each tensor's largest entry: the two halves' f32 sums against the
# whole batch's put a LayerNorm weight's gradient 6.8e-6 of its scale
# apart already at the CPU rehearsal's tiny size.
KNOBS_LAYERS, KNOBS_B = 2, 8
KNOBS_REL, KNOBS_UPDATE_REL, DONATE_MEM_REL = 1e-5, 1e-4, 2e-2


class _deterministic:
    """Deterministic algorithms, cuDNN's included, for a block, so that
    two runs of one computation are bitwise equal.  By default some
    backward sums take atomics: on the H100 two identical BERT steps put
    the token-type embedding's moments 9.8e-7 of their scale apart (its
    one id repeats 4096 times; `embedding_dense_backward`), and ResNet-50's
    eager and train-step gradients of the stem's BN bias 2.3e-5."""

    def __enter__(self):
        self.old = (torch.are_deterministic_algorithms_enabled(),
                    torch.backends.cudnn.deterministic)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.old[0])
        torch.backends.cudnn.deterministic = self.old[1]
        return False


def _lamb(ptt):
    return ptt.optimizer.LambOptimizer(learning_rate=1e-4,
                                       lamb_weight_decay=0.01)


def _bwd_launches(ops, heads, s, n):
    """The backward kernels' launches for ``n`` flash backwards of
    ``heads`` = B*H bf16 heads at S = ``s``, as the dispatch picks."""
    fused = ops.attention._use_fused_bwd(
        heads, s, s, D,
        torch.cuda.get_device_properties(0).multi_processor_count,
        torch.bfloat16)
    return {"flash_bwd_fused": n if fused else 0,
            "flash_bwd_dq": 0 if fused else n,
            "flash_bwd_dkv": 0 if fused else n}, fused


def train_lamb(ptt):
    """BERT-base pretraining as the large-batch recipe runs it: full
    width, dropout 0.1, LAMB(1e-4, wd 0.01), ShardedTrainStep(amp bf16,
    accumulate_steps=2, remat=True, donate=True), B=60 (two micro-batches
    of 30), S=512, P=80, four batches from RandomState(0).  Two warm-up
    steps, TRAIN_STEPS timed, REPEAT_STEPS on one batch (the loss must
    fall); kernel 1 launches 48 a step (12 layers x 2 micro-batches x
    forward and recompute), the backward 24.  cost_analysis's FLOPs
    with remat and, from one more step, without; the MFU from them at
    989 TFLOP/s beside `flops_per_step`'s hand model."""
    models, ops = ptt.models, ptt.ops
    cfg = models.BertConfig(**BERT_BASE, hidden_dropout_prob=0.1,
                            attention_probs_dropout_prob=0.1)
    b, s, p = TRAIN_B, TRAIN_S, TRAIN_P
    t0 = time.perf_counter()
    model = models.BertForPretraining(cfg, device="cuda")
    model.load_state_dict(models.from_jax_state_dict(
        models.init_bert_params(cfg, 17)))
    step = ptt.distributed.ShardedTrainStep(
        model, _lamb(ptt), bert_loss_fn, amp="bf16",
        accumulate_steps=LAMB_ACCUM, remat=True, donate=True)
    state = step.init()
    rng = np.random.RandomState(0)
    batches = [step.place_batch(make_bert_batch(rng, cfg, b, s, p))
               for _ in range(4)]
    hand_flops = flops_per_step(cfg, state["params"], b, s, p)
    setup_s = time.perf_counter() - t0
    L = cfg.num_hidden_layers

    state, warm_losses, warm_ms = _run_steps(step, state, batches, [0, 1])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ids = [(2 + n) % 4 for n in range(TRAIN_STEPS)]
    state, losses, step_ms = _run_steps(step, state, batches, ids)
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    n_bwd = L * LAMB_ACCUM * TRAIN_STEPS
    bwd, fused = _bwd_launches(ops, b // LAMB_ACCUM * cfg.num_attention_heads,
                               s, n_bwd)
    _expect_launches("LAMB remat accumulate run", launches, dict(
        bwd, flash_fwd=2 * n_bwd, matmul_bias_act=0, matmul_bwd_dx=0,
        matmul_bwd_dw=0, conv_bn_stats=0))
    all_losses = warm_losses + losses
    if not np.isfinite(all_losses).all():
        raise AssertionError("non-finite LAMB training loss: %s"
                             % all_losses)
    state, repeat_losses, _ = _run_steps(step, state, batches,
                                         [0] * REPEAT_STEPS)
    if not (np.isfinite(repeat_losses).all()
            and repeat_losses[-1] < repeat_losses[0]):
        raise AssertionError("the LAMB loss did not fall on one repeated "
                             "batch: %s" % repeat_losses)
    flops = step.cost_analysis(state, batches[0])["flops"]
    # a donating step updates ``state`` in place: profile one more
    prof = device_profile(lambda: step(state, batches[0]))
    # the same step without remat, for its count (it takes the state)
    plain = ptt.distributed.ShardedTrainStep(
        model, _lamb(ptt), bert_loss_fn, amp="bf16",
        accumulate_steps=LAMB_ACCUM, remat=False, donate=True)
    plain(state, batches[0])
    flops_plain = plain.cost_analysis(state, batches[0])["flops"]
    del state
    mean_s = float(np.mean(step_ms)) / 1e3
    peak = PEAK_FLOPS[torch.bfloat16]
    from paddle_tpu_torch.observability import cost

    mfu = cost.record_mfu("train_lamb", flops_plain, mean_s)
    emit({"phase": "train_lamb", "B": b, "S": s, "P": p, "amp": "bf16",
          "optimizer": "Lamb(1e-4, wd 0.01)", "accumulate_steps": LAMB_ACCUM,
          "remat": True, "donate": True, "setup_s": setup_s,
          "warmup_step_ms": warm_ms, "steps": TRAIN_STEPS, "step_ms": step_ms,
          "step_ms_p50": float(np.percentile(step_ms, 50)),
          "step_ms_p99": float(np.percentile(step_ms, 99)),
          "tokens_per_s": b * s / mean_s,
          "host_wall_tokens_per_s": b * s * TRAIN_STEPS / wall_s,
          "peak_memory_bytes": peak_mem,
          "cost_analysis_flops": flops,
          "cost_analysis_flops_remat_off": flops_plain,
          "recompute_share": flops / flops_plain - 1,
          "mfu_model_flops": flops_plain / mean_s / peak,
          "mfu_counted_with_recompute": flops / mean_s / peak,
          "record_mfu": mfu,
          "hand_flops_per_step": hand_flops,
          "hand_mfu": hand_flops / mean_s / peak,
          "backward": "fused" if fused else "pair",
          "losses": all_losses, "repeat_batch_losses": repeat_losses,
          "launches": launches,
          "launches_per_step": {k: v / TRAIN_STEPS for k, v in
                                launches.items() if v}})
    emit({"phase": "train_lamb_profile", "steps": 1, **prof})
    return launches


def _flat_state(state, kinds):
    out = {}
    for kind in kinds:
        for name, v in state[kind].items():
            if isinstance(v, dict):
                out.update({name + "/" + slot: t for slot, t in v.items()})
            else:
                out[name] = v
    return out


def _state_rel(a, b, kinds=("params", "opt")):
    """{name[/slot]: max |a - b| / max |b|} over two train states."""
    return _rel_errs(_flat_state(a, kinds), _flat_state(b, kinds))


def _state_bytes(state):
    n = sum(t.numel() * t.element_size() for t in state["params"].values())
    n += sum(t.numel() * t.element_size() for st in state["opt"].values()
             for t in st.values())
    return n + sum(t.numel() * t.element_size()
                   for t in state["buffers"].values())


def train_knobs_check(ptt):
    """BERT-base's widths at 2 layers in f32 (hidden 768, 12 heads, FFN
    3072, vocab 30528), B=8, S=512, P=80, LAMB(1e-4), all from one
    state: remat against none at dropout 0.1 (bitwise losses, the same
    masks); accumulate_steps=2 against 1 at dropout 0 (the micro-batches
    draw their own masks by design), with equal mlm_weights sums a
    micro-batch, through SGD(1.0) so that each parameter's update is its
    gradient; donate against copy (bitwise states, the input's tensors
    returned, memory_allocated lower by the state's bytes); and
    cost_analysis on the card against the same step's count on the CPU
    (the plain versions).  The runs held bitwise run under
    `_deterministic`."""
    models, ops = ptt.models, ptt.ops
    step_cls = ptt.distributed.ShardedTrainStep
    dims = dict(BERT_BASE, num_hidden_layers=KNOBS_LAYERS)
    cfg = models.BertConfig(**dims, hidden_dropout_prob=0.1,
                            attention_probs_dropout_prob=0.1)
    weights = models.from_jax_state_dict(models.init_bert_params(cfg, 19))
    b, s, p = KNOBS_B, TRAIN_S, TRAIN_P
    batch = make_bert_batch(np.random.RandomState(2), cfg, b, s, p)
    model = models.BertForPretraining(cfg, device="cuda")
    model.load_state_dict(weights)
    L = cfg.num_hidden_layers
    out = {"layers": L, "B": b, "S": s, "P": p, "rel_limit": KNOBS_REL}

    # remat, dropout 0.1
    runs = {}
    for remat in (False, True):
        step = step_cls(model, _lamb(ptt), bert_loss_fn, remat=remat,
                        donate=False)
        state0 = step.init()
        ops.reset_launch_counts()
        with _deterministic():
            new, loss = step(state0, batch)
            torch.cuda.synchronize()
        runs[remat] = (new, loss, ops.launch_counts(), step)
    if not torch.equal(runs[False][1], runs[True][1]):
        raise AssertionError("remat changed the loss: %r vs %r" % (
            runs[True][1].item(), runs[False][1].item()))
    remat_rel = _state_rel(runs[True][0], runs[False][0])
    bwd, _ = _bwd_launches(ops, b * cfg.num_attention_heads, s, L)
    bwd = {k: v for k, v in bwd.items() if v}
    _expect_launches("remat off", runs[False][2], dict(bwd, flash_fwd=L))
    _expect_launches("remat on", runs[True][2], dict(bwd, flash_fwd=2 * L))
    out["remat"] = dict(_check_rel("remat vs none", remat_rel, KNOBS_REL),
                        loss=runs[True][1].item(), loss_bitwise=True,
                        launches={"off": runs[False][2],
                                  "on": runs[True][2]})
    flops = {r: runs[r][3].cost_analysis(runs[r][0], batch)["flops"]
             for r in (False, True)}
    if not 3 * flops[True] == 4 * flops[False]:
        raise AssertionError("cost_analysis: remat %r is not 4/3 of %r"
                             % (flops[True], flops[False]))
    del runs

    # accumulation, dropout 0, SGD at lr 1: the updates are the
    # gradients (LAMB's per-element normalization would turn a bias's
    # rounding-level gradient into a step of +-lr)
    cfg0 = models.BertConfig(**dims, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    model0 = models.BertForPretraining(cfg0, device="cuda")
    model0.load_state_dict(weights)
    acc = {}
    for k in (1, 2):
        step = step_cls(model0, ptt.optimizer.SGDOptimizer(1.0),
                        bert_loss_fn, accumulate_steps=k, donate=False)
        state0 = step.init()
        new, loss = step(state0, batch)
        acc[k] = (loss.item(), {n: new["params"][n] - v
                                for n, v in state0["params"].items()},
                  new, step.cost_analysis(new, batch)["flops"])
    loss_err = abs(acc[2][0] - acc[1][0])
    if not loss_err <= KNOBS_REL * abs(acc[1][0]):
        raise AssertionError("accumulate_steps=2 loss %r vs %r" % (
            acc[2][0], acc[1][0]))
    upd = _check_rel("k=2 vs k=1 update", _rel_errs(acc[2][1], acc[1][1]),
                     KNOBS_UPDATE_REL)
    par = _check_rel("k=2 vs k=1 parameters",
                     _state_rel(acc[2][2], acc[1][2], ("params",)),
                     KNOBS_REL)
    if acc[2][3] != acc[1][3]:
        raise AssertionError("cost_analysis: k=2 %r, k=1 %r"
                             % (acc[2][3], acc[1][3]))
    out["accumulate"] = {"loss_k1": acc[1][0], "loss_k2": acc[2][0],
                         "loss_abs_err": loss_err, "update": upd,
                         "params": par, "flops": acc[1][3]}
    del acc, model0

    # donation: the same step donating and copying, from equal states
    steps = {d: step_cls(model, _lamb(ptt), bert_loss_fn, donate=d)
             for d in (True, False)}
    s_copy = steps[False].init()
    s_don = steps[True].init()
    ptrs = {n: t.data_ptr() for n, t in s_don["params"].items()}
    state_bytes = _state_bytes(s_don)
    with _deterministic():
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        new_d, loss_d = steps[True](s_don, batch)
        torch.cuda.synchronize()
        m_don = torch.cuda.memory_allocated() - m0
        m1 = torch.cuda.memory_allocated()
        new_c, loss_c = steps[False](s_copy, batch)
        torch.cuda.synchronize()
        m_copy = torch.cuda.memory_allocated() - m1
    if not torch.equal(loss_d, loss_c):
        raise AssertionError("donation changed the loss")
    diff = [k for k, v in _state_rel(new_d, new_c).items() if v != 0]
    if diff:
        raise AssertionError("donated state differs from the copied one "
                             "at %s" % diff[:4])
    moved = [n for n, t in new_d["params"].items()
             if t.data_ptr() != ptrs[n]]
    if moved:
        raise AssertionError("donated params not written in place: %s"
                             % moved[:4])
    saved = m_copy - m_don
    if not abs(saved - state_bytes) <= DONATE_MEM_REL * state_bytes:
        raise AssertionError("donation saved %d B of memory_allocated, the "
                             "state holds %d B" % (saved, state_bytes))
    out["donate"] = {"bitwise": True, "same_data_ptr": True,
                     "allocated_after_donating": m_don,
                     "allocated_after_copying": m_copy,
                     "saved_bytes": saved, "state_bytes": state_bytes,
                     "saved_over_state": saved / state_bytes}
    card_flops = steps[True].cost_analysis(new_d, batch)["flops"]
    del new_d, new_c, s_copy, s_don, steps, model

    # the FLOP count: card against the CPU's plain versions
    cpu_model = models.BertForPretraining(cfg, device="cpu")
    cpu_model.load_state_dict(weights)
    cpu_step = step_cls(cpu_model, _lamb(ptt), bert_loss_fn)
    t0 = time.perf_counter()
    cpu_state, _ = cpu_step(cpu_step.init(), batch)
    cpu_flops = cpu_step.cost_analysis(cpu_state, batch)["flops"]
    cpu_s = time.perf_counter() - t0
    if card_flops != cpu_flops or card_flops != flops[False]:
        raise AssertionError("cost_analysis: card %r, CPU %r" % (
            card_flops, cpu_flops))
    out["cost_analysis"] = {"card_flops": card_flops,
                            "cpu_flops": cpu_flops,
                            "remat_flops": flops[True],
                            "cpu_step_s": cpu_s}
    emit(dict(phase="train_knobs_check", **out))


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
    if eng.paged and eng._prefix is not None:
        eng._prefix.evict(eng.cache.num_blocks - 1)  # the registry's refs
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
    short kernel's wrapper read the host's time to enqueue it instead.
    A profile that shows fewer launches than calls (CUPTI can drop an
    activity record) is taken once more; a second short one raises."""
    for _ in range(warmup):
        fn()
    for _ in range(2):
        prof = device_profile(lambda: [fn() for _ in range(iters)])
        ms, n = prof["by_category_ms"].get(category, (0.0, 0))
        if n >= iters:
            return ms / n
    raise AssertionError("device_ms: %d %s launches in %d calls"
                         % (n, category, iters))


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

    chunk_check(ptt, model)
    launches["engine_prefix"] = engine_prefix(ptt, model, cfg)
    launches["engine_chunked"] = engine_chunked(
        ptt, model, reqs, itl_unchunked=(float(np.percentile(itl, 50)),
                                         float(np.percentile(itl, 99))))
    int8_check(ptt, model)
    launches["engine_int8"], int8_streams = engine_int8(ptt, model, reqs,
                                                        streams)
    launches["engine_speculative"] = engine_speculative(ptt, model, cfg, reqs,
                                                        streams)
    launches.update(run_serving(
        ptt, model, cfg, reqs, streams, int8_streams,
        {"tokens_per_s": n_tok / wall, "ttft_ms": _pcts(ttft),
         "itl_ms": _pcts(itl)}))
    return launches


# ---------------------------------------------------------------------------
# phase 4b: the engine's chunk path (C > 1 query rows over the paged
# cache), prefix caching and chunked prefill
# ---------------------------------------------------------------------------

CHUNK_PROMPTS = (64, 700, 1000)
CHUNK_WIDTH = 128
# the 1000-token prompt's cached prefix: its 552-token suffix pads to the
# 1024 bucket, so rows reach position 1471, past max_len and the model's
# positions (their ids clamped, their K/V in the garbage block)
PREFIX_CACHED = 448
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)          # as model_check
KV_TOL = dict(atol=1e-5, rtol=1e-5)
SYSTEM_PROMPT = 512


class ChunkRecorder:
    """Stands in for an engine's model: calls it, and keeps the start and
    the logits of its last call with at least ``min_rows`` rows over the
    cache (a chunk, by default)."""

    def __init__(self, model, min_rows=2):
        self.model = model
        self.min_rows = min_rows
        self.last = None

    def __call__(self, ids, pos, **kw):
        out = self.model(ids, pos, **kw)
        if kw.get("caches") is not None and ids.shape[1] >= self.min_rows:
            self.last = (int(kw["cache_positions"][0]), out[0][0].clone())
        return out


def _slot_rows(ops, eng, handle, n):
    """K and V [L, n, H, D] of ``handle``'s first n positions, read
    through its slot's block table (dequantized from an int8 pool)."""
    slot = next(s for s, st in enumerate(eng._slot_state)
                if st is not None and st.handle is handle)
    table = torch.from_numpy(eng.cache.table_row(slot)[None]).cuda()
    c = eng.cache
    scales = (c.k_scale, c.v_scale) if c.quantized else (None, None)
    return [torch.stack([ops.paged_gather_kv(
        p[li], table, None if sc is None else sc[li])[0, :n]
        for li in range(p.shape[0])]) for p, sc in zip((c.k, c.v), scales)]


def _prefill_via_engine(ptt, model, prompt, cached=None, **kw):
    """One request through an engine until its prompt is in the cache:
    the last chunk's logits row of the prompt's last token, and the K/V
    rows the engine wrote.  ``cached``: a prompt served first, whose
    full blocks the request then hits."""
    gen = ptt.generation
    eng = gen.GenerationEngine(model, slots=8, max_len=1024, **kw)
    if cached is not None:
        eng.submit(gen.GenerationRequest(cached, max_new_tokens=1))
        eng.run_until_idle()
    rec = eng.model = ChunkRecorder(eng.model)
    h = eng.submit(gen.GenerationRequest(prompt, max_new_tokens=8))
    while not any(st is not None and st.handle is h
                  for st in eng._slot_state):
        if h.done or not eng.step():
            raise AssertionError("request of %d tokens never reached decode"
                                 " (%s)" % (len(prompt), h.error))
    k, v = _slot_rows(ptt.ops, eng, h, len(prompt))
    start, logits = rec.last
    row = logits[len(prompt) - 1 - start]
    stats = eng.stats().get("prefix_cache")
    eng.run_until_idle()
    return row, k, v, stats


def chunk_check(ptt, model):
    """The chunk path's last-row logits and cache rows against the
    whole-prompt flash prefill's, 128-token chunks and a prefix-hit
    suffix; then the chunk path's device time beside kernel 1's at the
    1000-token prompt."""
    gen, ops = ptt.generation, ptt.ops
    rng = np.random.RandomState(17)
    buckets = gen.default_prefill_buckets(1024)
    cases = []
    for n in CHUNK_PROMPTS:
        prompt = [int(t) for t in rng.randint(0, model.cfg.vocab_size, n)]
        bucket = next(b for b in buckets if n <= b)
        ids = torch.zeros((1, bucket), dtype=torch.long)
        ids[0, :n] = torch.tensor(prompt)
        with torch.inference_mode():
            logits, kvs = model(ids.cuda(), torch.arange(bucket).cuda()[None],
                                use_cache=True)
            want = logits[0, n - 1]
            want_k = torch.stack([k[0, :n] for k, _ in kvs])
            want_v = torch.stack([v[0, :n] for _, v in kvs])
            del logits, kvs
            runs = [("chunk%d" % CHUNK_WIDTH, None,
                     dict(prefill_chunk=CHUNK_WIDTH))]
            if n == 1000:
                runs.append(("prefix_hit", prompt[:PREFIX_CACHED] + [0],
                             dict(prefix_cache=True)))
            for tag, cached, kw in runs:
                row, k, v, stats = _prefill_via_engine(ptt, model, prompt,
                                                       cached, **kw)
                if stats is not None and stats["hit_tokens"] != PREFIX_CACHED:
                    raise AssertionError("prefix hit %s, wanted %d tokens"
                                         % (stats, PREFIX_CACHED))
                lerr, lshare = compare("%s n=%d logits" % (tag, n), row,
                                       want, LOGIT_TOL)
                kerr, kshare = compare("%s n=%d K" % (tag, n), k, want_k,
                                       KV_TOL)
                verr, vshare = compare("%s n=%d V" % (tag, n), v, want_v,
                                       KV_TOL)
                cases.append({"prompt": n, "path": tag,
                              "logits_max_abs_err": lerr,
                              "logits_limit_share": lshare,
                              "kv_max_abs_err": max(kerr, verr),
                              "kv_limit_share": max(kshare, vshare),
                              "prefix_cache": stats})
    emit({"phase": "chunk_check", "logits_tol": LOGIT_TOL, "kv_tol": KV_TOL,
          "cases": cases})

    # device time: one chunked prefill (8 chunks of 128) of the
    # 1000-token prompt beside its whole-prompt flash prefill, and the
    # card's time for the chunk attention alone (its last chunk over the
    # gathered view, one layer) beside kernel 1 at S = 1024
    prompt = [int(t) for t in rng.randint(0, model.cfg.vocab_size, 1000)]
    prof = {}
    for tag, kw in (("flash", {}), ("chunked", dict(
            prefill_chunk=CHUNK_WIDTH))):
        eng = gen.GenerationEngine(model, slots=8, max_len=1024, **kw)
        eng.submit(gen.GenerationRequest(prompt, max_new_tokens=1))
        eng.run_until_idle()          # warm-up
        eng.submit(gen.GenerationRequest(prompt, max_new_tokens=1))
        p = device_profile(eng.run_until_idle)
        prof[tag] = {"device_busy_ms": p["device_busy_ms"],
                     "by_category_ms": p["by_category_ms"]}
    n_chunks = -(-1000 // CHUNK_WIDTH)
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(1, CHUNK_WIDTH, H, D, device="cuda", generator=g)
    kd, vd = (torch.randn(1, 1024, H, D, device="cuda", generator=g)
              for _ in range(2))
    pool = torch.randn(65, 16, H, D, device="cuda", generator=g)
    table = torch.arange(1, 65, dtype=torch.int32, device="cuda")[None]
    start = torch.tensor([1000 - CHUNK_WIDTH], dtype=torch.int32,
                         device="cuda")
    q1, k1, v1 = (torch.randn(1, 1024, H, D, device="cuda", generator=g)
                  for _ in range(3))
    emit({"phase": "chunk_profile", "prompt": 1000, "chunks": n_chunks,
          "chunk_width": CHUNK_WIDTH,
          "flash_prefill": prof["flash"],
          "chunked_prefill": prof["chunked"],
          "chunked_device_ms_per_chunk":
              prof["chunked"]["device_busy_ms"] / n_chunks,
          "chunk_attention_queued_ms": queued_ms(
              lambda: ops.chunked_attention_reference(q, kd, vd, start)),
          "chunk_gather_queued_ms": queued_ms(
              lambda: ops.paged_gather_kv(pool, table)),
          "flash_fwd_s1024_queued_ms": queued_ms(
              lambda: ops.flash_attention(q1, k1, v1, causal=True))})


def _ttft_ms(handles):
    return [(h.t_first_token - h.t_submit) * 1e3 for h in handles]


def _pcts(xs):
    return ({"p50": float(np.percentile(xs, 50)),
             "p99": float(np.percentile(xs, 99))} if len(xs) else None)


def prefix_requests(gen, cfg, n=16, seed=13):
    """A shared system prompt of 512 tokens, a private suffix of 16-192
    and 32-64 new tokens a request; greedy and sampled alternate."""
    rng = np.random.RandomState(seed)
    sysp = list(rng.randint(0, cfg.vocab_size, SYSTEM_PROMPT))
    reqs = []
    for i in range(n):
        suffix = list(rng.randint(0, cfg.vocab_size, int(rng.randint(16,
                                                                     193))))
        sp = (gen.SamplingParams.greedy() if i % 2 == 0 else
              gen.SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                                 seed=2000 + i))
        reqs.append(gen.GenerationRequest(
            sysp + suffix, max_new_tokens=int(rng.randint(32, 65)),
            sampling=sp, request_id="prefix%d" % i))
    return reqs


def _forward_check(model, reqs, streams, handles=None):
    """Each stream against a full causal forward of prompt + stream: the
    largest gap of a greedy token below its row's maximum, over max(1,
    max |logit|), and (given a logprob engine's ``handles``) the largest
    logprob error."""
    lp_err, greedy_gap = 0.0, 0.0
    with torch.inference_mode():
        for i, (r, s) in enumerate(zip(reqs, streams)):
            seq = r.prompt_ids + s[:-1]
            n = len(r.prompt_ids)
            lg = model(torch.tensor([seq]).cuda(),
                       torch.arange(len(seq)).cuda()[None])[0, n - 1:]
            toks = torch.tensor(s).cuda()
            if handles is not None:
                lp = torch.log_softmax(lg.float(), -1).gather(
                    1, toks[:, None])[:, 0]
                lp_err = max(lp_err, (lp.cpu() - torch.tensor(
                    handles[i].logprobs(0))).abs().max().item())
            if r.sampling.temperature <= 0:
                picked = lg.gather(1, toks[:, None])[:, 0]
                gap = (lg.amax(-1) - picked) / torch.clamp(
                    lg.abs().amax(-1), min=1.0)
                greedy_gap = max(greedy_gap, gap.max().item())
    return lp_err, greedy_gap


def engine_prefix(ptt, model, cfg):
    """Shared-system-prompt traffic through ``prefix_cache=True,
    logprobs=True``: one miss (the flash prefill), the rest served from
    the cache (the chunk path); every greedy token the argmax of a full
    causal forward of prompt + stream, every logprob that forward's."""
    gen, ops = ptt.generation, ptt.ops
    reqs = prefix_requests(gen, cfg)
    serve(gen, model, reqs[:3], prefix_cache=True, logprobs=True)  # warm-up
    ops.reset_launch_counts()
    eng, handles, streams, wall = serve(gen, model, reqs, prefix_cache=True,
                                        logprobs=True)
    launches = ops.launch_counts()
    st = eng.stats()["prefix_cache"]
    if st["hits"] < len(reqs) - 1 or \
            st["hit_tokens"] < (len(reqs) - 1) * SYSTEM_PROMPT:
        raise AssertionError("prefix cache %s" % st)
    for name in ("flash_fwd", "paged_attention"):
        if launches[name] <= 0:
            raise AssertionError("kernel %s never launched on the prefix "
                                 "engine run" % name)
    # the miss: the one request served before any block was cached
    ttft = _ttft_ms(handles)
    miss = [0] if st["misses"] == 1 else []
    lp_err, greedy_gap = _forward_check(model, reqs, streams, handles)
    if lp_err > 1e-4 or greedy_gap > 1e-4:
        raise AssertionError("prefix run: logprob error %g, greedy gap %g "
                             "(limits 1e-4)" % (lp_err, greedy_gap))
    _, _, plain, _ = serve(gen, model, reqs)
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    n_tok = sum(len(s) for s in streams)
    emit({"phase": "engine_prefix", "requests": len(reqs),
          "system_prompt": SYSTEM_PROMPT, "tokens": n_tok, "wall_s": wall,
          "tokens_per_s": n_tok / wall, "prefix_cache": st,
          "ttft_ms_miss": _pcts([ttft[i] for i in miss]),
          "ttft_ms_hit": _pcts([t for i, t in enumerate(ttft)
                                if i not in miss]),
          "logprob_max_abs_err": lp_err, "greedy_max_gap": greedy_gap,
          "greedy_equal_plain_engine": sum(plain[i] == streams[i]
                                           for i in greedy),
          "greedy_streams": len(greedy), "blocks_returned": True,
          "prompt_lens": [len(r.prompt_ids) for r in reqs],
          "launches": launches})
    return launches


def engine_chunked(ptt, model, reqs, itl_unchunked):
    """Phase 4's traffic through ``prefill_chunk=128``: every stream, greedy
    and sampled, equals the sequential oracle built with the same knob."""
    gen, ops = ptt.generation, ptt.ops
    ops.reset_launch_counts()
    eng, handles, streams, wall = serve(gen, model, reqs,
                                        prefill_chunk=CHUNK_WIDTH)
    launches = ops.launch_counts()
    if launches["paged_attention"] <= 0:
        raise AssertionError("paged_attention never launched on the chunked "
                             "engine run")
    oracle = gen.sequential_oracle(
        lambda: gen.GenerationEngine(model, slots=8, max_len=1024,
                                     prefill_chunk=CHUNK_WIDTH), reqs)
    bad = [r.request_id for r, o, s in zip(reqs, oracle, streams) if o != s]
    if bad:
        raise AssertionError("chunked streams differ from sequential_oracle: "
                             "%s" % bad)
    itl = np.concatenate([np.diff(h.t_tokens) * 1e3 for h in handles])
    n_tok = sum(len(s) for s in streams)
    emit({"phase": "engine_chunked", "requests": len(reqs),
          "chunk": CHUNK_WIDTH, "tokens": n_tok, "wall_s": wall,
          "tokens_per_s": n_tok / wall, "ttft_ms": _pcts(_ttft_ms(handles)),
          "itl_ms": _pcts(itl),
          "itl_ms_unchunked": {"p50": itl_unchunked[0],
                               "p99": itl_unchunked[1]},
          "oracle_requests": len(reqs), "oracle_equal": True,
          "blocks_returned": True, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# phase 4c: the int8 KV cache and speculative decoding
# ---------------------------------------------------------------------------

INT8_BYTES_SHARE = 0.27          # (D + 4) / 4D = 0.266 at D = 64
# half an int8 step, amax / 254, widened by the f32 rounding of x / scale,
# of the scale and of q * scale: at most 4.6e-5 of it for |q| <= 127
KV_ROUNDING = 1 + 1e-4


def _chunk_prompt(cfg):
    """chunk_check's 1000-token prompt (its generator's third draw)."""
    rng = np.random.RandomState(17)
    for n in CHUNK_PROMPTS:
        prompt = [int(t) for t in rng.randint(0, cfg.vocab_size, n)]
    return prompt


def _slot_int8(eng, handle, n):
    """The int8 K and V [L, n, H, D] of ``handle``'s first n positions
    and their scales [L, n, H], as stored, through its slot's table."""
    slot = next(s for s, st in enumerate(eng._slot_state)
                if st is not None and st.handle is handle)
    blocks = torch.from_numpy(eng.cache.table_row(slot)).cuda().long()
    c = eng.cache
    return [p[:, blocks].flatten(1, 2)[:, :n]
            for p in (c.k, c.v, c.k_scale, c.v_scale)]


def int8_check(ptt, model):
    """The 1000-token prompt through an int8 and an f32 engine: every
    dequantized K/V row of the whole-prompt prefill within amax|row| / 254
    (half an int8 step: the error of a quantizer that rounds to nearest,
    `KV_ROUNDING`) + 1e-6 of the f32 engine's row, a head at a time, the
    stored int8 rows
    and scales bitwise equal to `quantize_kv` of the f32 engine's rows,
    and the int8 cache at most 0.27 of the f32 cache's bytes.  Reported,
    not gated: the logits' drift from f32, max |delta| / max |logit|, of
    the first decode step and of the last row of a 128-token chunked
    prefill (the reference's int8 is opt-in under a documented
    tolerance)."""
    gen, ops = ptt.generation, ptt.ops
    prompt = _chunk_prompt(model.cfg)
    n = len(prompt)
    rows, decode_row, chunk_row, nbytes = {}, {}, {}, {}
    for tag, kw in (("f32", {}), ("int8", {"kv_dtype": "int8"})):
        eng = gen.GenerationEngine(model, slots=8, max_len=1024, **kw)
        rec = eng.model = ChunkRecorder(eng.model, min_rows=1)
        h = eng.submit(gen.GenerationRequest(prompt, max_new_tokens=3))
        eng.step()                    # the prefill and one decode step
        rows[tag] = _slot_rows(ops, eng, h, n)
        if kw:
            stored = _slot_int8(eng, h, n)
        decode_row[tag] = rec.last[1][0]
        nbytes[tag] = eng.cache.nbytes
        eng.run_until_idle()
        chunk_row[tag] = _prefill_via_engine(ptt, model, prompt,
                                             prefill_chunk=CHUNK_WIDTH,
                                             **kw)[0]
        del eng, rec
    worst = 0.0
    for got, want in zip(rows["int8"], rows["f32"]):
        limit = want.abs().amax(-1, keepdim=True) / 254 * KV_ROUNDING + 1e-6
        share = ((got - want).abs() / limit).max().item()
        worst = max(worst, share)
    if not worst <= 1.0:
        raise AssertionError("int8 K/V rows use %.6g of the amax / 254 "
                             "bound" % worst)
    (kq, ks), (vq, vs) = (ops.quantize_kv(r) for r in rows["f32"])
    mismatched = [int((a != b).sum()) for a, b in zip(stored,
                                                      (kq, vq, ks, vs))]
    if any(mismatched):
        raise AssertionError("stored int8 K, V, K scales, V scales differ "
                             "from quantize_kv of the f32 rows in %s "
                             "entries" % mismatched)
    share = nbytes["int8"] / nbytes["f32"]
    if share > INT8_BYTES_SHARE:
        raise AssertionError("int8 cache %d bytes, %.4f of f32's"
                             % (nbytes["int8"], share))

    def drift(rows_):
        return ((rows_["int8"] - rows_["f32"]).abs().max()
                / rows_["f32"].abs().max()).item()

    emit({"phase": "int8_check", "prompt": n, "kv_bound_share": worst,
          "kv_bound": "amax / 254 * %r + 1e-6" % KV_ROUNDING, "stored_equal_quantize_kv": True,
          "bytes": nbytes, "bytes_share": share,
          "bytes_share_limit": INT8_BYTES_SHARE,
          "decode_logit_drift": drift(decode_row),
          "chunk_last_row_logit_drift": drift(chunk_row)})


def _step_profile(gen, model, reqs, **kw):
    """Device time of one engine iteration over eight decoding slots,
    after their prefills and a first iteration."""
    eng = gen.GenerationEngine(model, slots=8, max_len=1024, **kw)
    for r in reqs[:8]:
        eng.submit(r)
    eng.step()                        # eight prefills and an iteration
    eng.step()
    p = device_profile(eng.step)
    return eng, {"device_busy_ms": p["device_busy_ms"],
                 "by_category_ms": dict(list(p["by_category_ms"].items())[:8])}


def engine_int8(ptt, model, reqs, f32_streams):
    """Phase 4's traffic with ``kv_dtype="int8"``: every stream, sampled
    ones too, equals the sequential oracle built with the same knob; the
    paged decode kernel (9) never launches, since the reference dispatches
    an int8 pool to its gather-dequantize plain path."""
    gen, ops = ptt.generation, ptt.ops
    kw = {"kv_dtype": "int8"}
    serve(gen, model, reqs[:2], **kw)            # warm-up
    ops.reset_launch_counts()
    eng, handles, streams, wall = serve(gen, model, reqs, **kw)
    launches = ops.launch_counts()
    if launches["paged_attention"] != 0 or launches["flash_fwd"] <= 0:
        raise AssertionError("int8 engine launches %s: want flash_fwd > 0, "
                             "paged_attention 0" % launches)
    oracle = gen.sequential_oracle(
        lambda: gen.GenerationEngine(model, slots=8, max_len=1024, **kw),
        reqs)
    bad = [r.request_id for r, o, s in zip(reqs, oracle, streams) if o != s]
    if bad:
        raise AssertionError("int8 streams differ from sequential_oracle: %s"
                             % bad)
    itl = np.concatenate([np.diff(h.t_tokens) * 1e3 for h in handles])
    n_tok = sum(len(s) for s in streams)
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    prof = {}
    for tag, pkw in (("f32", {}), ("int8", kw)):
        _, prof[tag] = _step_profile(gen, model, reqs, **pkw)
    emit({"phase": "engine_int8", "requests": len(reqs), "tokens": n_tok,
          "wall_s": wall, "tokens_per_s": n_tok / wall,
          "ttft_ms": _pcts(_ttft_ms(handles)), "itl_ms": _pcts(itl),
          "oracle_requests": len(reqs), "oracle_equal": True,
          "greedy_equal_f32_engine": sum(streams[i] == f32_streams[i]
                                         for i in greedy),
          "greedy_streams": len(greedy),
          "cache_bytes": eng.cache.nbytes,
          "paged_attention_launches_why": "0: an int8 pool takes the "
          "gather-dequantize plain path, as the reference dispatches it",
          "decode_step_profile": prof, "blocks_returned": True,
          "launches": launches})
    return launches, streams


def _spec_profile(gen, model, reqs, draft):
    """Device time of one speculative iteration over eight decoding slots,
    split into the draft's k proposals and the verify call, and whole."""
    eng, whole = _step_profile(gen, model, reqs, draft_model=draft,
                               draft_len=DRAFT_LEN)
    tok_in = np.concatenate([eng._last_tokens[:, None], eng._draft_propose()],
                            axis=1)
    out = {"iteration": whole}
    for tag, run in (("draft", eng._draft_propose),
                     ("verify", lambda: eng._verify(tok_in))):
        run()                                    # warm-up
        p = device_profile(run)
        out[tag] = {"device_busy_ms": p["device_busy_ms"],
                    "by_category_ms": dict(
                        list(p["by_category_ms"].items())[:6])}
    return out


def engine_speculative(ptt, model, cfg, reqs, plain_streams):
    """Phase 4's traffic with the reference bench's draft model
    (`generation_bench.py:254-263`: hidden 256, 2 layers, 4 heads, FFN
    1024, seed 23) and ``draft_len=3``: every stream equals the
    speculative sequential oracle, every greedy token is the argmax of a
    full causal forward (within 1e-4 of the row's scale), kernel 1 runs
    the target's and the draft's prefills (16 x (12 + 2) launches) and
    kernel 8 the draft's decode: 2 layers x (3 + 1) steps an iteration,
    every iteration speculative (the last step writes the row of the
    third proposal, `GenerationEngine._draft_propose`).  Then the
    target as its own draft: greedy acceptance >= 0.9 and the greedy
    streams phase 4's."""
    gen, models, ops = ptt.generation, ptt.models, ptt.ops
    dcfg = models.TransformerLMConfig(
        vocab_size=cfg.vocab_size, hidden_size=256, num_layers=DRAFT_LAYERS,
        num_heads=DRAFT_H, intermediate_size=1024,
        max_position_embeddings=cfg.max_position_embeddings, dropout=0.0)
    draft = models.TransformerLM(dcfg, device="cuda")
    draft.load_state_dict(models.from_jax_state_dict(
        models.init_params(dcfg, seed=23)))
    draft.eval()
    kw = {"draft_model": draft, "draft_len": DRAFT_LEN}
    serve(gen, model, reqs[:2], **kw)            # warm-up
    ops.reset_launch_counts()
    eng, handles, streams, wall = serve(gen, model, reqs, **kw)
    launches = ops.launch_counts()
    spec = eng.stats()["speculative"]
    want_flash = len(reqs) * (cfg.num_layers + dcfg.num_layers)
    want8 = eng.stats()["decode_steps"] * DRAFT_LAYERS * (DRAFT_LEN + 1)
    if launches["flash_fwd"] != want_flash or \
            launches["decode_attention"] != want8 or want8 <= 0:
        raise AssertionError("speculative launches %s: want flash_fwd %d, "
                             "decode_attention %d" % (launches, want_flash,
                                                      want8))
    if not (spec["proposed"] > 0 and 0 <= spec["acceptance_rate"] <= 1):
        raise AssertionError("speculative stats %s" % spec)
    oracle = gen.sequential_oracle(
        lambda: gen.GenerationEngine(model, slots=8, max_len=1024, **kw),
        reqs)
    bad = [r.request_id for r, o, s in zip(reqs, oracle, streams) if o != s]
    if bad:
        raise AssertionError("speculative streams differ from "
                             "sequential_oracle: %s" % bad)
    _, greedy_gap = _forward_check(model, reqs, streams)
    if greedy_gap > 1e-4:
        raise AssertionError("speculative greedy gap %g (limit 1e-4)"
                             % greedy_gap)
    itl = np.concatenate([np.diff(h.t_tokens) * 1e3 for h in handles])
    n_tok = sum(len(s) for s in streams)
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    sampled = [i for i in range(len(reqs)) if i not in greedy]
    prof = _spec_profile(gen, model, reqs, draft)

    twin = models.TransformerLM(cfg, device="cuda")
    twin.load_state_dict(model.state_dict())
    twin.eval()
    seng, _, sstreams, swall = serve(gen, model, reqs, draft_model=twin,
                                     draft_len=DRAFT_LEN)
    sspec = seng.stats()["speculative"]
    bad = [reqs[i].request_id for i in greedy
           if sstreams[i] != plain_streams[i]]
    if sspec["acceptance_rate"] < 0.9 or bad:
        raise AssertionError("self-draft: %s, greedy streams off phase 4's: "
                             "%s" % (sspec, bad))
    emit({"phase": "engine_speculative", "requests": len(reqs),
          "draft": {"hidden": 256, "layers": DRAFT_LAYERS, "heads": DRAFT_H,
                    "ffn": 1024, "seed": 23}, "draft_len": DRAFT_LEN,
          "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
          "ttft_ms": _pcts(_ttft_ms(handles)), "itl_ms": _pcts(itl),
          "iteration_ms": eng._m_itl.summary(), "speculative": spec,
          "decode_steps": eng.stats()["decode_steps"],
          "oracle_requests": len(reqs), "oracle_equal": True,
          "greedy_max_gap": greedy_gap,
          "sampled_equal_plain_engine": sum(streams[i] == plain_streams[i]
                                            for i in sampled),
          "sampled_streams": len(sampled), "profile": prof,
          "self_draft": {"speculative": sspec, "tokens_per_s": sum(
              len(x) for x in sstreams) / swall,
                         "decode_steps": seng.stats()["decode_steps"],
                         "greedy_equal_plain_engine": len(greedy)},
          "blocks_returned": True, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# phase 4d: the serving tier over the engine (the generation fleet, its
# death drill, weight swap and HTTP front) and the disaggregated prefill /
# decode pair, all on phase 4's model and traffic
# ---------------------------------------------------------------------------

SERVE_TIMEOUT = 300.0        # s a handle may wait for its next event
SWAP_SEED = 8                # the second model's weights, init_params


def _fleet(ptt, model, replicas=2, **kw):
    return ptt.serving.GenerationFleet(model, replicas=replicas, slots=8,
                                       max_len=1024, **kw)


def _results(handles):
    return [h.result(timeout=SERVE_TIMEOUT) for h in handles]


def _same_streams(tag, reqs, got, want):
    bad = [r.request_id for r, g, w in zip(reqs, got, want) if g != w]
    if bad:
        raise AssertionError("%s: streams differ: %s" % (tag, bad))


def _client_latency(handles, wall):
    """tokens/s over ``wall`` and TTFT / ITL percentiles as the clients
    saw them (after a restart, a stream's tokens since it)."""
    n_tok = sum(len(h._tokens) for h in handles)
    itl = np.concatenate([np.diff(h.t_tokens) * 1e3 for h in handles])
    return {"tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "ttft_ms": _pcts(_ttft_ms(handles)), "itl_ms": _pcts(itl)}


def serving_fleet(ptt, model, reqs, streams, phase4):
    """Phase 4's 16 requests through a 2-replica `GenerationFleet` on the
    card: every stream (sampled ones too) phase 4's, both replicas
    decoding, kernels 1 and 9 launched.  The replicas' scheduler threads
    share one interpreter, so whether the fleet beats one engine is a
    measurement, not a given."""
    ops = ptt.ops
    fleet = _fleet(ptt, model).start()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [fleet.submit(r) for r in reqs]
    got = _results(handles)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if launches["flash_fwd"] <= 0 or launches["paged_attention"] <= 0:
        raise AssertionError("fleet run launches %s: want flash_fwd and "
                             "paged_attention > 0" % launches)
    _same_streams("serving_fleet vs phase 4", reqs, got, streams)
    steps = [r.engine.stats()["decode_steps"] for r in fleet.replicas]
    if min(steps) <= 0:
        raise AssertionError("a replica took no decode step: %s" % steps)
    lat = _client_latency(handles, wall)
    emit({"phase": "serving_fleet", "replicas": 2, "requests": len(reqs),
          **lat, "streams_equal_phase4": len(reqs),
          "decode_steps_by_replica": steps,
          "requests_by_replica": [r.engine._m_requests.value
                                  for r in fleet.replicas],
          "phase4": phase4,
          "fleet_beats_one_engine": lat["tokens_per_s"]
          > phase4["tokens_per_s"],
          "live_summary": fleet.live_summary(), "launches": launches})
    return fleet, launches


def serving_swap(ptt, model, cfg, fleet, reqs, streams):
    """A canary swap on the running fleet: `init_params(cfg, seed=8)`
    through `from_jax_state_dict` onto replica 1 only.  Its greedy
    streams are then a single seed-8 engine's, replica 0's and the
    caller's model stay phase 4's; a swap back from `snapshot_params`
    restores phase 4's streams on replica 1, and a swap with one wrong
    shape raises ValueError and moves no stream.  The first swap costs
    about one copy of the weights on the card (copy-on-swap)."""
    gen, models = ptt.generation, ptt.models
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature <= 0]
    greq = [reqs[i] for i in greedy]
    gwant = [streams[i] for i in greedy]

    def served(*replicas):
        hs = [[fleet.replicas[i].engine.submit(r) for r in greq]
              for i in replicas]
        return [_results(h) for h in hs]

    snap = fleet.snapshot_params()
    p8 = models.from_jax_state_dict(models.init_params(cfg, seed=SWAP_SEED))
    r1 = fleet.replicas[1].replica_id
    param_bytes = sum(v.numel() * v.element_size() for v in snap.values())
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    swapped = fleet.swap_params(p8, replica_ids=[r1])
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    mem1 = torch.cuda.memory_allocated()
    if swapped != [r1]:
        raise AssertionError("swap reached %s, want [%s]" % (swapped, r1))
    model8 = models.TransformerLM(cfg, device="cuda")
    model8.load_state_dict(p8)
    want8 = serve(gen, model8.eval(), greq)[2]
    del model8
    got0, got1 = served(0, 1)
    _same_streams("replica 0 after the canary swap", greq, got0, gwant)
    _same_streams("replica 1 vs a seed-8 engine", greq, got1, want8)
    moved = sum(a != b for a, b in zip(want8, gwant))
    if moved == 0:
        raise AssertionError("the seed-8 model's greedy streams equal the "
                             "seed-7 model's: the swap check sees nothing")
    caller = {k: v.cpu() for k, v in model.state_dict().items()}
    if not all(torch.equal(caller[k], v) for k, v in snap.items()):
        raise AssertionError("the canary swap changed the caller's model")
    t0 = time.perf_counter()
    fleet.swap_params(snap, replica_ids=[r1])
    torch.cuda.synchronize()
    back_ms = (time.perf_counter() - t0) * 1e3
    mem2 = torch.cuda.memory_allocated()
    _same_streams("replica 1 after the swap back", greq, served(1)[0], gwant)
    bad = dict(snap, **{"ln_f.weight": torch.zeros(cfg.hidden_size + 1)})
    try:
        fleet.swap_params(bad, replica_ids=[r1])
    except ValueError as e:
        bad_error = str(e)
    else:
        raise AssertionError("a swap with a wrong shape was taken")
    _same_streams("replica 1 after the refused swap", greq, served(1)[0],
                  gwant)
    emit({"phase": "serving_swap", "replica": r1, "seed": SWAP_SEED,
          "greedy_requests": len(greq), "seed8_streams_differ": int(moved),
          "swap_ms": swap_ms, "swap_back_ms": back_ms,
          "param_bytes": param_bytes,
          "memory_allocated_delta_bytes": mem1 - mem0,
          "memory_after_swap_back_delta_bytes": mem2 - mem0,
          "replica0_equal_phase4": True, "replica1_equal_seed8": True,
          "caller_model_unchanged": True, "swap_back_equal_phase4": True,
          "wrong_shape_error": bad_error[:120]})


def _ctl(port, *args):
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "generation_ctl.py")
    out = subprocess.run(
        [sys.executable, tool, "--endpoint", "http://127.0.0.1:%d" % port,
         "--json", *args], capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError("generation_ctl %s: rc %d %s %s"
                             % (args[0], out.returncode, out.stdout[-500:],
                                out.stderr[-500:]))
    return json.loads(out.stdout)


def serving_http(ptt, fleet, reqs, streams):
    """`serve_generation_http` on the fleet, bound to 127.0.0.1: a
    streamed POST /generate equals the in-process stream,
    `tools/generation_ctl.py` ``smoke`` and ``kv`` exit 0, GET /slo
    answers and the fleet's SLO engine holds phase 4's 16 records."""
    import http.client
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = ptt.serving.serve_generation_http(fleet, port=port, block=False)
    try:
        r = reqs[0]
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=SERVE_TIMEOUT)
        t0 = time.perf_counter()
        conn.request("POST", "/generate", json.dumps({
            "prompt": r.prompt_ids, "max_new_tokens": r.max_new_tokens,
            "stream": True, "request_id": "http0"}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        records = [json.loads(ln) for ln in resp.read().splitlines() if ln]
        http_ms = (time.perf_counter() - t0) * 1e3
        conn.close()
        tokens = [x["token"] for x in records if "token" in x]
        if resp.status != 200 or tokens != streams[0] or \
                records[-1].get("reason") != "max_new_tokens":
            raise AssertionError("POST /generate: HTTP %d, %d tokens, last "
                                 "record %s" % (resp.status, len(tokens),
                                                records[-1]))
        smoke = _ctl(port, "smoke", "--requests", "8", "--max-new", "8")
        kv = _ctl(port, "kv")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/slo")
        resp = conn.getresponse()
        report = json.loads(resp.read())
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
    held = {rec["request_id"] for rec in fleet.slo._records}
    missing = [q.request_id for q in reqs if q.request_id not in held]
    if not smoke["ok"] or len(kv["replicas"]) != 2 or resp.status != 200 \
            or missing:
        raise AssertionError("smoke %s, kv %s, /slo HTTP %d, records "
                             "missing %s" % (smoke, kv, resp.status,
                                             missing))
    emit({"phase": "serving_http", "stream_tokens": len(tokens),
          "stream_equal_in_process": True, "stream_ms": http_ms,
          "ctl_smoke": smoke, "ctl_kv": kv,
          "slo": {k: report[k] for k in ("window", "goodput", "alerts",
                                         "objectives")},
          "slo_holds_phase4_records": len(reqs)})


def serving_kill(ptt, model, reqs, streams):
    """The fleet under `FaultPlan` ``kill_replica`` (replica 0 before its
    decode step 5): one death, every affected request requeued once on
    replica 1, every stream phase 4's.  Then a 1-replica fleet's death
    fails every request with "no alive replicas" inside SERVE_TIMEOUT."""
    FaultPlan = ptt.incubate.fault.FaultPlan
    ops = ptt.ops
    fleet = _fleet(ptt, model, fault_plan=FaultPlan([], rank=0).add(
        "kill_replica", replica=0, request=5)).start()
    try:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = [fleet.submit(r) for r in reqs]
        got = _results(handles)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        fleet.stop()
    requeued = [h for h in handles if h.requeued]
    affected = fleet.replicas[0].engine.affected_on_death
    if int(fleet._m_deaths.value) != 1 or not requeued or \
            int(fleet._m_requeued.value) != len(requeued) or \
            set(requeued) != set(affected):
        raise AssertionError("deaths %d, requeued %d (counter %d), "
                             "affected %d" % (fleet._m_deaths.value,
                                              len(requeued),
                                              fleet._m_requeued.value,
                                              len(affected)))
    _same_streams("serving_kill vs phase 4", reqs, got, streams)

    lone = _fleet(ptt, model, replicas=1, fault_plan=FaultPlan(
        [], rank=0).add("kill_replica", replica=0, request=2)).start()
    try:
        t1 = time.perf_counter()
        lost = [lone.submit(r) for r in reqs[:3]]
        errors = []
        for h in lost:
            try:
                h.result(timeout=SERVE_TIMEOUT)
                errors.append("finished")
            except RuntimeError as e:
                errors.append(str(e))
        fail_s = time.perf_counter() - t1
    finally:
        lone.stop()
    if not all("no alive replicas" in e for e in errors):
        raise AssertionError("1-replica death: %s" % errors)
    emit({"phase": "serving_kill", "requests": len(reqs),
          **_client_latency(handles, wall), "deaths": 1,
          "requeued": len(requeued), "streams_equal_phase4": len(reqs),
          "requeued_ttft_ms": _pcts(_ttft_ms(requeued)),
          "survivor_decode_steps": fleet.replicas[1].engine.stats()[
              "decode_steps"],
          "lone_fleet_failed": len(errors), "lone_fleet_fail_s": fail_s,
          "launches": launches})
    return launches


def disagg(ptt, model, reqs, want, kv_dtype=None):
    """A `DisaggPair` of two engines on the card: `prefill_extract` of all
    16 requests first (kernel 1, 16 x 12 launches), then their injection
    and decode on the decode engine, which launches kernel 1 zero times
    and runs no prefill (its executables["prefill"] all 0); every stream
    ``want``'s.  An int8 pair's handoff carries int8 pages and their f32
    scales, and its decode takes the plain path (kernel 9 unlaunched, as
    engine_int8)."""
    gen, ops = ptt.generation, ptt.ops
    cfg = model.cfg
    pair = ptt.tp_serving.DisaggPair(*[
        gen.GenerationEngine(model, slots=8, max_len=1024, kv_dtype=kv_dtype)
        for _ in range(2)])
    ops.reset_launch_counts()
    handles, extract_ms = [], []
    for r in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles.append(pair.submit(r))
        torch.cuda.synchronize()
        extract_ms.append((time.perf_counter() - t0) * 1e3)
    prefill_launches = ops.launch_counts()
    handoffs = [e for e, _ in pair.decode._pending]
    dtypes = sorted({str(p.dtype) for h in handoffs for p in h.pages})
    want_dtypes = (["torch.float32", "torch.int8"] if kv_dtype
                   else ["torch.float32"])
    if len(handoffs) != len(reqs) or dtypes != want_dtypes or any(
            len(h.pages) != (4 if kv_dtype else 2) for h in handoffs):
        raise AssertionError("%d handoffs, page dtypes %s"
                             % (len(handoffs), dtypes))
    nbytes = [h.nbytes for h in handoffs]
    inject_ms = []
    inject = pair.decode._inject_into

    def timed_inject(slot, handoff, handle):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = inject(slot, handoff, handle)
        torch.cuda.synchronize()
        inject_ms.append((time.perf_counter() - t0) * 1e3)
        return ok

    pair.decode._inject_into = timed_inject
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pair.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode_launches = ops.launch_counts()
    got = [h.result(timeout=0) for h in handles]
    dex = pair.decode.stats()["executables"]
    want9 = 0 if kv_dtype else 1
    if prefill_launches["flash_fwd"] != len(reqs) * cfg.num_layers or \
            prefill_launches["paged_attention"] != 0 or \
            decode_launches["flash_fwd"] != 0 or \
            (decode_launches["paged_attention"] > 0) != bool(want9) or \
            any(dex["prefill"].values()) or dex["decode_step"] != 1:
        raise AssertionError("disagg launches: prefill %s, decode %s, "
                             "decode executables %s"
                             % (prefill_launches, decode_launches, dex))
    _same_streams("disagg (%s)" % (kv_dtype or "f32"), reqs, got, want)
    if pair.prefill.cache.pool.used_blocks or \
            pair.decode.cache.pool.used_blocks:
        raise AssertionError("disagg blocks never returned to the pools")
    emit({"phase": "disagg", "kv_dtype": kv_dtype or "float32",
          "requests": len(reqs), **_client_latency(handles, wall),
          "streams_equal": "phase 4's" if kv_dtype is None
          else "engine_int8's", "handoff_bytes_sum": sum(nbytes),
          "handoff_bytes_max": max(nbytes), "page_dtypes": dtypes,
          "pair_stats": pair.stats(), "extract_ms": _pcts(extract_ms),
          "extract_ms_sum": sum(extract_ms), "inject_ms": _pcts(inject_ms),
          "inject_ms_sum": sum(inject_ms),
          "decode_executables": dex, "prefill_launches": prefill_launches,
          "decode_launches": decode_launches})
    return prefill_launches, decode_launches


def run_serving(ptt, model, cfg, reqs, streams, int8_streams, phase4):
    """The serving phases; returns their launch counts by phase."""
    fleet, fleet_launches = serving_fleet(ptt, model, reqs, streams, phase4)
    try:
        serving_swap(ptt, model, cfg, fleet, reqs, streams)
        serving_http(ptt, fleet, reqs, streams)
    finally:
        fleet.stop()
    del fleet
    kill_launches = serving_kill(ptt, model, reqs, streams)
    pre, dec = disagg(ptt, model, reqs, streams)
    pre8, dec8 = disagg(ptt, model, reqs, int8_streams, kv_dtype="int8")
    return {"serving_fleet": fleet_launches, "serving_kill": kill_launches,
            "disagg_prefill": pre, "disagg_decode": dec,
            "disagg_int8_prefill": pre8, "disagg_int8_decode": dec8}


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
    rows = [conv_bn_row(ops, gen, b, hw, k, n, dt, per_fwd)
            for dt in (torch.float32, torch.bfloat16)
            for b, hw, k, n, per_fwd in (CONV_EXPERIMENT,) + CONV_PATH]
    emit({"phase": "conv_bn_main_shape", "rows": rows})
    return rows


def conv_bn_row(ops, gen, b, hw, k, n, dt, per_fwd):
    """Kernel 10 at one shape (B images of hw x hw, K -> N channels):
    `conv_bn_case`'s check, then its time (events and `queued_ms`)
    beside its plain version, the library's same function (channels-last
    cuDNN F.conv2d, then F.batch_norm eval and relu), cuBLAS's bare GEMM
    and the bound."""
    import torch.nn.functional as F

    m = b * hw * hw
    err, share, t = conv_bn_case(ops, gen, m, k, n, dt)
    x, w, scale, shift = t["x"], t["w"], t["scale"], t["shift"]
    gamma, beta, mean, var = t["bn_vectors"]
    x4 = x.view(b, hw, hw, k).permute(0, 3, 1, 2)   # channels-last
    w4 = w.view(n, k, 1, 1)
    bms, by = bound(*conv_bn_work(m, k, n, dt), dt)
    return {
        "M": m, "K": k, "N": n, "dtype": str(dt).replace("torch.", ""),
        "per_forward": per_fwd, "bn": t.get("bn"),
        "ctas": t.get("ctas"), "max_abs_err": err, "limit_share": share,
        "ms": time_ms(lambda: ops.conv1x1_bn_relu(x, w, scale, shift)),
        "queued_ms": queued_ms(lambda: ops.conv1x1_bn_relu(
            x, w, scale, shift)),
        "plain_ms": time_ms(lambda: ops.conv1x1_bn_relu_reference(
            x, w, scale, shift)),
        "library_ms": time_ms(lambda: F.relu_(F.batch_norm(
            F.conv2d(x4, w4), mean, var, gamma, beta, False, 0.0, 1e-5))),
        "cublas_gemm_ms": time_ms(lambda: torch.matmul(x, w.t())),
        "bound_ms": bms, "bound_by": by}


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
    rows = [conv_stats_row(ops, gen, m, k, n, dt, per_step)
            for m, k, n, per_step in (CONV_STATS_EXPERIMENT,)
            + CONV_STATS_PATH]
    emit({"phase": "conv_bn_stats_main_shape", "dtype": "bfloat16",
          "rows": rows})
    return rows


def conv_stats_row(ops, gen, m, k, n, dt, per_step):
    """Kernel 11 at one shape: `conv_stats_case`'s check, then its time
    (events and `queued_ms`) beside its plain version, the library's
    same function (torch.matmul, then torch.var_mean of the f32
    upcast), cuBLAS's bare GEMM and the bound."""
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
        "plain_ms": time_ms(lambda: ops.conv1x1_bn_stats_reference(x, w)),
        "library_ms": time_ms(library),
        "cublas_gemm_ms": time_ms(lambda: torch.matmul(x, w.t())),
        "bound_ms": bms, "bound_by": by})
    return row


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
    # each run starts from its own init() (state0's values) and donates
    # its states; state0 itself is never stepped
    step = _resnet_train_step(ptt, model, amp="bf16")
    state0 = step.init()
    rng = np.random.RandomState(0)
    batches = [step.place_batch({
        "image": rng.randn(RESNET_B, 3, RESNET_HW, RESNET_HW).astype(
            np.float32),
        "label": rng.randint(0, RESNET_CLASSES, (RESNET_B, 1)).astype(
            np.int32)}) for _ in range(2)]
    setup_s = time.perf_counter() - t0

    state, warm_losses, _ = _run_steps(step, step.init(), batches,
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
    _, repeat_losses, _ = _run_steps(step, step.init(), batches,
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


# train_eager: ResNet-50 (1000 classes) trained in f32 by the eager
# minimize path, B = 64 at 224x224, one repeated batch.  The eager
# Momentum step against ShardedTrainStep's: the same kernels on the same
# inputs, so the new parameters agree to f32 rounding; the limit is 1e-5
# of each tensor's largest entry.
EAGER_B, EAGER_STEPS, EAGER_PROFILED = 64, 5, 1
EAGER_VS_STEP_REL = 1e-5


def _eager_model(ptt, params):
    model = ptt.models.resnet50(num_classes=RESNET_CLASSES, device="cuda")
    model.load_state_dict(ptt.models.from_jax_state_dict(params))
    return model.train()


def _minimize_profile(opt, loss, params):
    """One ``minimize`` under torch.profiler: its wall ms, its device
    kernels, and every device-to-host copy or host read of a device
    value inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.minimize(loss, parameter_list=params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    reads = sorted({e.name for e in events if "DtoH" in e.name
                    or "Device -> Host" in e.name
                    or e.name in ("aten::_local_scalar_dense", "aten::item")})
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    return {"profiled_wall_ms": wall_ms, "device_events": len(dev),
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in dev) / 1e3,
            "device_to_host": reads}


def train_eager(ptt):
    """ResNet-50 trained by ``loss.backward(); opt.minimize(loss,
    parameter_list=model.parameters())`` under LarsMomentum(PiecewiseDecay
    ([3], [0.1, 0.01]), 0.9, coeff 0.001, wd 5e-4) with L2Decay(1e-4) and
    GradientClipByGlobalNorm(1.0), f32, EAGER_STEPS steps on one batch:
    33 kernel-11 launches a step, a falling finite loss, moving running
    statistics, no device-to-host copy inside a profiled minimize.  Then
    one eager Momentum(0.1, 0.9) step against ShardedTrainStep's from the
    same weights and batch."""
    models, ops, optim = ptt.models, ptt.ops, ptt.optimizer
    params = models.init_resnet_params(50, RESNET_CLASSES, seed=31)
    rng = np.random.RandomState(0)
    batch = {
        "image": torch.from_numpy(rng.randn(EAGER_B, 3, RESNET_HW, RESNET_HW)
                                  .astype(np.float32)).cuda(),
        "label": torch.from_numpy(rng.randint(
            0, RESNET_CLASSES, (EAGER_B, 1)).astype(np.int32)).cuda()}
    model = _eager_model(ptt, params)
    opt = optim.LarsMomentumOptimizer(
        learning_rate=ptt.learning_rate_scheduler.PiecewiseDecay(
            [3], [0.1, 0.01]),
        momentum=0.9, lars_coeff=0.001, lars_weight_decay=5e-4,
        regularization=ptt.regularizer.L2Decay(1e-4),
        grad_clip=ptt.clip.GradientClipByGlobalNorm(1.0))
    buffers0 = {k: v.clone() for k, v in model.named_buffers()}
    losses, evs, per_step, lrs, prof = [], [], [], [], None
    total = dict.fromkeys(ops.launch_counts(), 0)
    torch.cuda.synchronize()
    for i in range(EAGER_STEPS):
        ops.reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss = resnet_loss_fn(model, batch)
        loss.backward()
        if i == EAGER_PROFILED:
            prof = _minimize_profile(opt, loss, list(model.parameters()))
        else:
            opt.minimize(loss, parameter_list=model.parameters())
        model.zero_grad(set_to_none=True)
        ev[1].record()
        evs.append(ev)
        counts = ops.launch_counts()
        per_step.append(counts["conv_bn_stats"])
        total = {k: total[k] + v for k, v in counts.items()}
        losses.append(loss.detach())
        lrs.append(opt.current_step_lr())
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in evs]
    losses = [x.item() for x in losses]
    if per_step != [CONV_STATS_PER_STEP] * EAGER_STEPS:
        raise AssertionError("eager ResNet-50 kernel-11 launches a step: %s"
                             % per_step)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("the eager LARS loss did not fall: %s" % losses)
    moved = max((b - buffers0[k]).abs().max().item()
                for k, b in model.named_buffers())
    if not moved > 0:
        raise AssertionError("the eager running statistics never moved")
    if prof["device_to_host"]:
        raise AssertionError("minimize read the device: %s"
                             % prof["device_to_host"])
    del model, opt

    # one eager Momentum step against ShardedTrainStep's
    model = _eager_model(ptt, params)
    step = ptt.distributed.ShardedTrainStep(
        model, optim.MomentumOptimizer(0.1, 0.9), resnet_loss_fn,
        donate=False)
    with _deterministic():
        new, loss_s = step(step.init(), batch)
        loss_e = resnet_loss_fn(model.train(), batch)
        loss_e.backward()
        optim.MomentumOptimizer(0.1, 0.9).minimize(
            loss_e, parameter_list=model.parameters())
    vs_step = _check_rel("eager Momentum vs ShardedTrainStep", _rel_errs(
        {n: p.detach() for n, p in model.named_parameters()},
        new["params"]), EAGER_VS_STEP_REL)
    timed = [ms for i, ms in enumerate(step_ms) if i != EAGER_PROFILED]
    emit({"phase": "train_eager", "B": EAGER_B, "HW": RESNET_HW,
          "classes": RESNET_CLASSES, "dtype": "float32",
          "optimizer": "LarsMomentum(PiecewiseDecay([3], [0.1, 0.01]), 0.9, "
                       "coeff 0.001, wd 5e-4) + L2Decay(1e-4) + "
                       "GradientClipByGlobalNorm(1.0)",
          "steps": EAGER_STEPS, "step_ms": step_ms,
          "step_ms_p50_unprofiled": float(np.percentile(timed, 50)),
          "images_per_s": EAGER_B / (float(np.mean(timed)) / 1e3),
          "losses": losses, "learning_rates": lrs,
          "running_stats_max_move": moved,
          "conv_bn_stats_launches_per_step": per_step,
          "minimize_profile": prof,
          "momentum_vs_step": dict(vs_step, loss_step=loss_s.item(),
                                   loss_eager=loss_e.item(),
                                   rel_limit=EAGER_VS_STEP_REL),
          "launches": total})
    return total


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
# ---------------------------------------------------------------------------
# the static-graph inference path: a saved BERT-base program served by
# the Predictor through kernels 1 and 5
# ---------------------------------------------------------------------------

# BERT-base as published (vocab 30522), f32, the fused FFN off: the
# saved program's FFNs and pooler reach kernel 5 only through the
# matmul_bias_act_fuse pass the predictor applies at load
STATIC_BERT = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, intermediate_size=3072,
                   max_position_embeddings=512, type_vocab_size=2)
STATIC_S = 128
STATIC_BATCHES = (1, 4, 8)
STATIC_REQUESTS = 20          # timed requests a batch size
STATIC_PROFILED = 5           # profiled requests a batch size
STATIC_SEED = 23
STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "static_serve")


def static_feed(b, seed=0):
    """int64 feeds of ``b`` rows of STATIC_S tokens; row 0 pads its last
    quarter through ``attention_mask``, so the bias path runs."""
    rng = np.random.RandomState(seed)
    s = STATIC_S
    mask = np.ones((b, s), np.int64)
    mask[0, 3 * s // 4:] = 0
    return {"input_ids": rng.randint(0, STATIC_BERT["vocab_size"],
                                     (b, s)).astype(np.int64),
            "token_type_ids": rng.randint(0, 2, (b, s)).astype(np.int64),
            "position_ids": np.tile(np.arange(s, dtype=np.int64), (b, 1)),
            "attention_mask": mask}


def _recorded_calls(ops, run):
    """The arguments kernels 1 and 5 get from the static ops in one
    call of ``run`` (the ops call `ops.attention` / `ops.matmul` through
    their modules), each call still launching its kernel."""
    calls = {"flash": [], "mba": []}
    sdpa, mba = (ops.attention.scaled_dot_product_attention,
                 ops.matmul.matmul_bias_act)

    def rec_sdpa(q, k, v, **kw):
        calls["flash"].append((q, k, v, kw))
        return sdpa(q, k, v, **kw)

    def rec_mba(x, w, bias=None, **kw):
        calls["mba"].append((x, w, bias, kw))
        return mba(x, w, bias, **kw)

    with patch.object(ops.attention, "scaled_dot_product_attention",
                      rec_sdpa), \
            patch.object(ops.matmul, "matmul_bias_act", rec_mba):
        run()
    return calls


def plain_sdpa(ops):
    """`ops.scaled_dot_product_attention`'s plain version (autograd
    through plain PyTorch), for a patch in its place."""
    def sdpa(q, k, v, bias=None, segment_ids=None, scale=None,
             causal=False, layout="BHSD"):
        return ops.flash_attention_reference(q, k, v, bias, segment_ids,
                                             scale, causal, layout)[0]
    return sdpa


def plain_flash(ops):
    """Patches under which the flash op's autograd Function runs the
    kernels' plain versions on the card instead of the kernels: the
    forward's (o, LSE) of `flash_attention_reference` and the backward
    of `flash_attention_bwd_reference` from them (its delta from the
    stored o, as the kernels form it)."""
    att = ops.attention

    def fwd(q, k, v, bias=None, segment_ids=None, scale=None, causal=False,
            layout="BSHD", with_lse=False):
        return ops.flash_attention_reference(q, k, v, bias, segment_ids,
                                             scale, causal, layout)

    def bwd(q, k, v, o, do, lse, bias=None, segment_ids=None, scale=None,
            causal=False, layout="BSHD", bias_grad=False):
        return att._plain_bwd(q, k, v, o, do, lse, bias, segment_ids, scale,
                              causal, layout, bias_grad)

    return (patch.object(att, "flash_fwd", fwd),
            patch.object(att, "flash_attention_bwd", bwd))


def _plain_static(ops):
    """Patches under which the static ops reach the plain versions of
    kernels 1 and 5, on the card, instead of the kernels."""
    def mba(x, w, bias=None, activation="none", approximate=False):
        return ops.matmul_bias_act_reference(x, w, bias, activation,
                                             approximate)[0]

    return (patch.object(ops.attention, "scaled_dot_product_attention",
                         plain_sdpa(ops)),
            patch.object(ops.matmul, "matmul_bias_act", mba))


def static_kernel_rows(ops, calls):
    """Kernels 1 and 5 on the arguments the static path gave them (the
    first call of each shape): errors against the plain versions at
    check_flash's and check_matmul's f32 limits, times beside the plain
    version, the library call and the bound."""
    import torch.nn.functional as F

    rows = []
    q, k, v, kw = calls["flash"][0]
    b, s, h, d = q.shape
    want = ops.flash_attention_reference(
        q, k, v, kw.get("bias"), kw.get("segment_ids"), kw["scale"],
        kw["causal"], kw["layout"])[0]
    got = ops.attention.scaled_dot_product_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err, share = compare("static flash", got, want, TOL[torch.float32])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bias = kw.get("bias")
    bms, by = bound(4 * b * s * h * d * 4 + b * s * 4,
                    4 * b * h * s * s * d, torch.float32)
    rows.append({
        "kernel": "flash_fwd", "B": b, "S": s, "H": h, "D": d,
        "layout": kw["layout"], "bias": list(bias.shape),
        "qkv_strides": list(q.stride()), "per_forward": len(calls["flash"]),
        "max_abs_err": err, "limit_share": share,
        "ms": time_ms(lambda: ops.attention.scaled_dot_product_attention(
            q, k, v, **kw)),
        "plain_ms": time_ms(lambda: ops.flash_attention_reference(
            q, k, v, bias, None, kw["scale"], False, kw["layout"])),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias, scale=kw["scale"])),
        "bound_ms": bms, "bound_by": by})
    rows += mba_rows(ops, calls["mba"], "static")
    emit({"phase": "static_serve_kernels", "rows": rows})
    return rows


def mba_rows(ops, calls, tag):
    """Kernel 5 on the arguments a static path gave it (the first call of
    each shape and activation): the error against its plain version at
    check_matmul's f32 limit, its time beside the plain version's,
    F.linear + the activation (the library) and the bound; the kernel's
    and the library's ``queued_ms`` too (the card's time, where a small
    product's events read the host's enqueue rate)."""
    import torch.nn.functional as F

    library_act = {"gelu": F.gelu, "tanh": torch.tanh, "relu": torch.relu,
                   "none": lambda t: t}
    rows, seen = [], set()
    for x, w, bias, kw in calls:
        act = kw.get("activation", "none")
        m, kk = x.shape
        n = w.shape[0]
        if (m, kk, n, act) in seen:
            continue
        seen.add((m, kk, n, act))
        approx = kw.get("approximate", False)
        want = ops.matmul_bias_act_reference(x, w, bias, act, approx)[0]
        got = ops.matmul.matmul_bias_act(x, w, bias, **kw)
        torch.cuda.synchronize()
        tol = gemm_tol(torch.float32, want)
        err, share = compare("%s matmul_bias_act %s" % (tag, act), got, want,
                             tol)
        lib = library_act[act]
        bms, by = bound((m * kk + n * kk + n + m * n) * 4, 2 * m * n * kk,
                        torch.float32)
        rows.append({
            "kernel": "matmul_bias_act", "M": m, "K": kk, "N": n,
            "act": act, "per_forward": sum(
                c[0].shape[0] == m and c[1].shape[0] == n for c in calls),
            "max_abs_err": err, "limit_share": share,
            "ms": time_ms(lambda: ops.matmul.matmul_bias_act(
                x, w, bias, **kw)),
            "queued_ms": queued_ms(lambda: ops.matmul.matmul_bias_act(
                x, w, bias, **kw)),
            "plain_ms": time_ms(lambda: ops.matmul_bias_act_reference(
                x, w, bias, act, approx)),
            "library_ms": time_ms(lambda: lib(F.linear(x, w, bias))),
            "library_queued_ms": queued_ms(
                lambda: lib(F.linear(x, w, bias))),
            "bound_ms": bms, "bound_by": by})
    return rows


def static_serve(ptt):
    """BERT-base as a static program, from build to served requests: the
    port's `models.bert_program` builds it (12 layers, hidden 768, 12
    heads, FFN 3072, vocab 30522, S = 128, f32, the fused FFN off), the
    startup program initializes it on the card (seeded), the port's
    `save_inference_model` writes it under build/, and `create_predictor`
    loads it with ``matmul_bias_act_fuse`` and answers requests at
    B = 1, 4 and 8.  Checks: 12 launches of kernel 1 and 13 of kernel 5
    a forward and no other; kernels 1 and 5 on the path's own arguments
    against their plain versions; one B = 8 batch against the same
    saved model run through the plain versions on the card (TOL f32),
    and through the same weights built BHSD
    (``PADDLE_TPU_BERT_HEAD_LAYOUT=BHSD``: 48 ``transpose2``, 12 kernel-1
    launches; TOL f32); ``compile_count`` 3.  Then p50 latency a batch size over
    STATIC_REQUESTS requests and a profile of STATIC_PROFILED (device
    busy time and kernel launches a request)."""
    import shutil

    fluid, inference, models, ops = (ptt.fluid, ptt.inference, ptt.models,
                                     ptt.ops)
    cfg = models.BertConfig(**STATIC_BERT)
    t0 = time.perf_counter()
    with _env("PADDLE_TPU_FUSED_FFN", None):
        main, startup, feeds, fetches = models.bert_program.bert_program(
            cfg, STATIC_S)
        with _env("PADDLE_TPU_BERT_HEAD_LAYOUT", "BHSD"):
            bhsd_main, _, _, bhsd_fetches = \
                models.bert_program.bert_program(cfg, STATIC_S)
    startup.random_seed = STATIC_SEED
    t1 = time.perf_counter()
    exe = fluid.Executor()
    scope = fluid.Scope()
    shutil.rmtree(STATIC_DIR, ignore_errors=True)
    with fluid.scope_guard(scope):
        exe.run(startup)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fluid.io.save_inference_model(STATIC_DIR, feeds, list(fetches), exe,
                                      main)
        fluid.io.save_inference_model(STATIC_DIR + "_bhsd", feeds,
                                      list(bhsd_fetches), exe, bhsd_main)
    del scope
    t3 = time.perf_counter()
    pred = inference.create_predictor(inference.AnalysisConfig(STATIC_DIR))
    fluid.ir.apply_passes(pred._program, ["matmul_bias_act_fuse"])
    t4 = time.perf_counter()
    disk = sum(os.path.getsize(os.path.join(STATIC_DIR, f))
               for f in os.listdir(STATIC_DIR))
    types = [o.type for o in pred._program.global_block.ops]
    L = cfg.num_hidden_layers
    want_launches = {name: 0 for name in ops.KERNEL_WRAPPERS}
    want_launches.update(flash_fwd=L, matmul_bias_act=L + 1)
    if (types.count("flash_attention"), types.count("matmul_bias_act"),
            types.count("gelu"), types.count("tanh")) != (L, L + 1, 0, 0):
        raise AssertionError("static program after the pass: %s"
                             % sorted(set(types)))

    # one forward a batch size: the kernels it launches
    per_forward = {}
    for b in STATIC_BATCHES:
        feed = static_feed(b)
        ops.reset_launch_counts()
        out = pred.run(feed)
        launches = ops.launch_counts()
        _expect_launches("static forward B=%d" % b, launches, want_launches)
        per_forward[b] = launches
        if [o.shape for o in out] != [(b, STATIC_S, cfg.hidden_size),
                                      (b, cfg.hidden_size)] or not all(
                np.isfinite(o).all() for o in out):
            raise AssertionError("static outputs at B=%d: %s"
                                 % (b, [o.shape for o in out]))

    # the kernels on the path's own arguments, and one batch against the
    # same saved model through the plain versions on the card
    b = STATIC_BATCHES[-1]
    feed = static_feed(b, seed=1)
    calls = _recorded_calls(ops, lambda: pred.run_async(feed))
    kernel_rows = static_kernel_rows(ops, calls)
    del calls
    got = pred.run(feed)
    ops.reset_launch_counts()
    p1, p2 = _plain_static(ops)
    with p1, p2:
        want = pred.run(feed)
    if any(ops.launch_counts().values()):
        raise AssertionError("the plain run launched %s" % ops.launch_counts())
    e2e = {}
    for name, g, w in zip(pred.get_output_names(), got, want):
        e2e[name] = compare("static %s B=%d" % (name, b), torch.from_numpy(g),
                            torch.from_numpy(w), TOL[torch.float32])
    # the same weights built BHSD (the reference's q / k / v and context
    # transposes around kernel 1): a B = 8 forward equal to BSHD's
    bhsd = inference.create_predictor(inference.AnalysisConfig(
        STATIC_DIR + "_bhsd"))
    fluid.ir.apply_passes(bhsd._program, ["matmul_bias_act_fuse"])
    ops.reset_launch_counts()
    bhsd_out = bhsd.run(feed)
    bhsd_launches = ops.launch_counts()
    _expect_launches("static BHSD forward B=%d" % b, bhsd_launches,
                     want_launches)
    bhsd_types = [o.type for o in bhsd._program.global_block.ops]
    if bhsd_types.count("transpose2") != 4 * L:
        raise AssertionError("BHSD program: %d transpose2"
                             % bhsd_types.count("transpose2"))
    bhsd_err = {name: compare("static BHSD %s B=%d" % (name, b),
                              torch.from_numpy(g), torch.from_numpy(w),
                              TOL[torch.float32])
                for name, g, w in zip(pred.get_output_names(), bhsd_out,
                                      got)}
    del bhsd
    shutil.rmtree(STATIC_DIR + "_bhsd", ignore_errors=True)
    if pred.compile_count != len(STATIC_BATCHES):
        raise AssertionError("compile_count %d, want %d"
                             % (pred.compile_count, len(STATIC_BATCHES)))
    flops = {bb: pred.cost_analysis(static_feed(bb))["flops"]
             for bb in STATIC_BATCHES}

    # serving: p50 latency a batch size (host clock around run(), which
    # returns numpy: it waits for the card; the batch sizes in turn, so
    # a drift in the host's speed reaches all three), launches over the
    # run
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    latency, profiles = {}, {}
    feeds_b = {bb: static_feed(bb, seed=2) for bb in STATIC_BATCHES}
    for bb in STATIC_BATCHES:
        for _ in range(3):
            pred.run(feeds_b[bb])
    ops.reset_launch_counts()
    ts = {bb: [] for bb in STATIC_BATCHES}
    for _ in range(STATIC_REQUESTS):        # the batch sizes in turn
        for bb in STATIC_BATCHES:
            t = time.perf_counter()
            pred.run(feeds_b[bb])
            ts[bb].append((time.perf_counter() - t) * 1e3)
    run_launches = ops.launch_counts()
    for bb in STATIC_BATCHES:
        p50 = float(np.percentile(ts[bb], 50))
        latency[bb] = {"p50_ms": p50,
                       "p90_ms": float(np.percentile(ts[bb], 90)),
                       "min_ms": min(ts[bb]),
                       "model_tflops_at_p50": flops[bb] / p50 / 1e9}
    n_req = STATIC_REQUESTS * len(STATIC_BATCHES)
    _expect_launches("static serving run", run_launches,
                     {k: v * n_req for k, v in want_launches.items()})
    for bb in STATIC_BATCHES:
        prof = device_profile(lambda: [pred.run(feeds_b[bb])
                                       for _ in range(STATIC_PROFILED)])
        launches = sum(v[1] for v in prof["by_category_ms"].values())
        profiles[bb] = {
            "device_busy_ms_per_request": (
                prof["device_busy_ms"] / STATIC_PROFILED
                if prof["device_busy_ms"] is not None else None),
            "device_idle_share": prof["device_idle_share"],
            "launches_per_request": launches / STATIC_PROFILED,
            "by_category_ms": prof["by_category_ms"],
            "top_kernels_ms": prof.get("top_kernels_ms")}
    emit({"phase": "static_serve", "nvidia_smi": smi,
          "config": dict(STATIC_BERT, S=STATIC_S, dtype="float32",
                         fused_ffn=False, passes=["matmul_bias_act_fuse"]),
          "build_s": t1 - t0, "startup_s": t2 - t1, "save_s": t3 - t2,
          "load_s": t4 - t3, "saved_bytes": disk,
          "ops": len(types), "op_types": {t: types.count(t)
                                          for t in sorted(set(types))},
          "launches_per_forward": per_forward,
          "e2e_vs_plain": {k: {"max_abs_err": v[0], "limit_share": v[1]}
                           for k, v in e2e.items()},
          "bhsd_vs_bshd": {"B": b, "launches": bhsd_launches,
                           "transpose2": 4 * L, **{
                               k: {"max_abs_err": v[0], "limit_share": v[1]}
                               for k, v in bhsd_err.items()}},
          "compile_count": pred.compile_count, "flops": flops,
          "latency": latency, "run_launches": run_launches,
          "requests": n_req, "profile": profiles})
    del pred
    shutil.rmtree(STATIC_DIR, ignore_errors=True)
    return {"per_forward": {k: per_forward[STATIC_BATCHES[-1]][k]
                            for k in ("flash_fwd", "matmul_bias_act")},
            "run_launches": run_launches, "requests": n_req,
            "kernel_rows": kernel_rows}


# ---------------------------------------------------------------------------
# the static-graph training path: a BERT-base pretraining program built,
# differentiated and trained by the Executor through kernels 1, 4 (or 2
# and 3), 5, 6 and 7
# ---------------------------------------------------------------------------

# the google-research/bert README's phase-1 settings (max_seq_length 128,
# max_predictions_per_seq 20, train_batch_size 32), f32, dropout 0.1,
# the fused FFN, AdamW(1e-4, wd 0.01)
STATIC_TRAIN_B, STATIC_TRAIN_P = 32, 20
STATIC_TRAIN_WARMUP, STATIC_TRAIN_STEPS = 2, 10
STATIC_TRAIN_SEED = 29
STATIC_TRAIN_LR = 1e-4
STATIC_TRAIN_REL = 1e-4       # kernels vs plain: the loss, each parameter


def static_train_feed(cfg, seed, b=STATIC_TRAIN_B, s=STATIC_S,
                      p=STATIC_TRAIN_P):
    """One pretraining batch (int64, numpy, as a user feeds it): row 0
    pads its last quarter through ``attention_mask``; P sorted masked
    positions a row, row 1's last prediction weighted 0 (padding)."""
    rng = np.random.RandomState(seed)
    mask = np.ones((b, s), np.int64)
    mask[0, 3 * s // 4:] = 0
    weights = np.ones((b, p), np.float32)
    weights[1, -1] = 0.0
    return {
        "input_ids": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int64),
        "token_type_ids": rng.randint(0, 2, (b, s)).astype(np.int64),
        "position_ids": np.tile(np.arange(s, dtype=np.int64), (b, 1)),
        "attention_mask": mask,
        "masked_positions": np.stack([np.sort(rng.choice(
            3 * s // 4, p, replace=False)) for _ in range(b)]).astype(
                np.int64),
        "mlm_labels": rng.randint(0, cfg.vocab_size, (b, p)).astype(np.int64),
        "mlm_weights": weights,
        "nsp_labels": rng.randint(0, 2, (b, 1)).astype(np.int64)}


def static_train_program(ptt, dropout):
    """(cfg, main, startup, loss): `models.bert_pretraining_program` at
    STATIC_BERT's widths with ``dropout``, the fused FFN and
    AdamW(STATIC_TRAIN_LR, wd 0.01); the startup program seeded."""
    cfg = ptt.models.BertConfig(**STATIC_BERT, hidden_dropout_prob=dropout,
                                attention_probs_dropout_prob=dropout)
    with _env("PADDLE_TPU_FUSED_FFN", "1"):
        main, startup, _, loss = \
            ptt.models.bert_program.bert_pretraining_program(
                cfg, STATIC_S, STATIC_TRAIN_P,
                optimizer=ptt.optimizer.AdamWOptimizer(
                    STATIC_TRAIN_LR, weight_decay=0.01))
    startup.random_seed = STATIC_TRAIN_SEED
    return cfg, main, startup, loss


def static_train_flops(cfg, b, s, p):
    """`flops_per_step`'s model FLOPs for the static program's BERT: 6 a
    matmul parameter a token for the trunk (encoder, embedding LayerNorm,
    pooler, NSP head), the MLM head (mlm_transform and the tied decoder)
    on the P masked rows, and the attention term 12 L S d a token."""
    d, f, v, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    layer = 4 * d * d + 4 * d + 2 * d * f + f + d + 4 * d
    trunk = L * layer + 2 * d + d * d + d + 2 * d + 2
    head = v * d + d * d + d + v
    return b * s * (6.0 * trunk + 12.0 * L * d * s) + b * p * 6.0 * head


def _static_train_launches(ops, cfg, b):
    """Launches a step: kernels 1, 5, 6, 7 once a layer; the backward
    `ops.attention._use_fused_bwd` picks for B*H heads of S = STATIC_S,
    f32 (kernel 4, or kernels 2 and 3); none of 8-11."""
    L, h = cfg.num_hidden_layers, cfg.num_attention_heads
    fused = ops.attention._use_fused_bwd(
        b * h, STATIC_S, STATIC_S, cfg.hidden_size // h,
        ops.attention._sm_count(torch.device("cuda")), torch.float32)
    want = {name: 0 for name in ops.KERNEL_WRAPPERS}
    want.update(flash_fwd=L, matmul_bias_act=L, matmul_bwd_dx=L,
                matmul_bwd_dw=L)
    if fused:
        want["flash_bwd_fused"] = L
    else:
        want.update(flash_bwd_dq=L, flash_bwd_dkv=L)
    return want, fused


def static_train_kernel_rows(ops, calls, fused):
    """Kernels 1, 4 (or 2 + 3), 5, 6 and 7 on the arguments the static
    training path gave kernels 1 and 5 (its first call of each), with a
    seeded output gradient: errors against the plain versions (f32
    limits), then each timed beside its plain version, the library call
    (SDPA's forward and backward; F.linear + gelu and its dX, dW + dbias
    on a retained graph) and its bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(31)
    f32 = torch.float32
    rows = []
    q, k, v, kw = calls["flash"][0]
    q, k, v = (t.detach() for t in (q, k, v))
    bias = kw.get("bias")
    bias = bias.detach() if bias is not None else None
    b, s, h, d = q.shape
    scale, layout = kw["scale"], kw["layout"]
    o, lse = ops.flash_fwd(q, k, v, bias, None, scale, False, layout,
                           with_lse=True)
    do = torch.randn(o.shape, device="cuda", generator=gen)
    o_ref, _ = ops.flash_attention_reference(q, k, v, bias, None, scale,
                                             False, layout)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, bias, None, scale,
                                  False, layout, bias_grad=True)
    want = ops.flash_attention_bwd_reference(q, k, v, bias, None, o, do,
                                             lse, scale, False, layout)
    torch.cuda.synchronize()
    errs = {"o": compare("static train flash o", o, o_ref, TOL[f32])[0]}
    for tag, g_, w_ in zip(("dq", "dk", "dv", "dbias"), got, want):
        errs[tag] = compare("static train flash " + tag, g_, w_,
                            GRAD_TOL[f32])[0]
    lib_fwd, lib_bwd, _ = _library_attention(q, k, v, do, bias, None,
                                             False, scale)
    x_ = b * s * h * d * 4
    pairs = b * h * s * s * d
    bwd_name = "flash_bwd_fused" if fused else "flash_bwd_dq+flash_bwd_dkv"
    rows.append({
        "kernel": "flash_fwd", "B": b, "S": s, "H": h, "D": d,
        "layout": layout, "bias": list(bias.shape),
        "max_abs_err": errs["o"],
        "ms": time_ms(lambda: ops.flash_fwd(q, k, v, bias, None, scale,
                                            False, layout, with_lse=True)),
        "plain_ms": time_ms(lambda: ops.flash_attention_reference(
            q, k, v, bias, None, scale, False, layout), iters=5, warmup=1),
        "library_ms": lib_fwd,
        **dict(zip(("bound_ms", "bound_by"), bound(
            4 * x_ + b * h * s * 4 + b * s * 4, 4 * pairs, f32)))})
    rows.append({
        "kernel": bwd_name, "B": b, "S": s, "H": h, "D": d,
        "dbias": True, "max_abs_err": max(errs[t] for t in (
            "dq", "dk", "dv", "dbias")), "errors": errs,
        "ms": time_ms(lambda: ops.flash_attention_bwd(
            q, k, v, o, do, lse, bias, None, scale, False, layout,
            bias_grad=True)),
        "plain_ms": time_ms(lambda: ops.flash_attention_bwd_reference(
            q, k, v, bias, None, o, do, lse, scale, False, layout),
            iters=5, warmup=1),
        "library_ms": lib_bwd,
        **dict(zip(("bound_ms", "bound_by"), bound(
            8 * x_ + b * h * s * 4 + b * s * 4 + b * h * s * 4,
            10 * pairs, f32)))})

    x, w, bias, kw = calls["mba"][0]
    x, w, bias = (t.detach() for t in (x, w, bias))
    act = kw.get("activation", "none")
    m, kk = x.shape
    n = w.shape[0]
    y, z = ops.matmul_bias_act_fwd(x, w, bias, act, emit_z=True)
    g = torch.randn(m, n, device="cuda", generator=gen)
    res = z if ops.matmul._residual_kind(act) == "z" else y
    dx = ops.matmul_bwd_dx(g, res, w, act)
    dw, db = ops.matmul_bwd_dw(x, g, res, act, bias=bias)
    y_ref, z_ref = ops.matmul_bias_act_reference(x, w, bias, act,
                                                 emit_z=True)
    dx_ref, dw_ref, db_ref = ops.matmul_bias_act_bwd_reference(
        x, w, bias, res, g, act)
    torch.cuda.synchronize()
    e = {tag: compare("static train matmul " + tag, got_, want_,
                      gemm_tol(f32, want_))[0]
         for tag, got_, want_ in (("y", y, y_ref), ("z", z, z_ref),
                                  ("dx", dx, dx_ref), ("dw", dw, dw_ref),
                                  ("dbias", db, db_ref))}
    far = float64_distances(ops, x, w, res, g, act, (dx, dw, db),
                            (dx_ref, dw_ref, db_ref))
    xl, wl, bl = (t.detach().requires_grad_() for t in (x, w, bias))
    out = F.gelu(F.linear(xl, wl, bl))
    flops = 2 * m * n * kk
    for name, err, ms, plain_ms, lib_ms, nbytes in (
            ("matmul_bias_act", max(e["y"], e["z"]),
             time_ms(lambda: ops.matmul_bias_act_fwd(x, w, bias, act,
                                                     emit_z=True)),
             time_ms(lambda: ops.matmul_bias_act_reference(
                 x, w, bias, act, emit_z=True), iters=5, warmup=1),
             time_ms(lambda: F.gelu(F.linear(x, w, bias))),
             m * kk + n * kk + n + 2 * m * n),
            ("matmul_bwd_dx", e["dx"],
             time_ms(lambda: ops.matmul_bwd_dx(g, res, w, act)),
             time_ms(lambda: ops.matmul_bias_act_bwd_reference(
                 x, w, bias, res, g, act, needs=(True, False, False)),
                 iters=5, warmup=1),
             time_ms(lambda: torch.autograd.grad(out, (xl,), g,
                                                 retain_graph=True)),
             2 * m * n + n * kk + m * kk),
            ("matmul_bwd_dw", max(e["dw"], e["dbias"]),
             time_ms(lambda: ops.matmul_bwd_dw(x, g, res, act, bias=bias)),
             time_ms(lambda: ops.matmul_bias_act_bwd_reference(
                 x, w, bias, res, g, act, needs=(False, True, True)),
                 iters=5, warmup=1),
             time_ms(lambda: torch.autograd.grad(out, (wl, bl), g,
                                                 retain_graph=True)),
             m * kk + 2 * m * n + n * kk + n)):
        rows.append({"kernel": name, "M": m, "K": kk, "N": n, "act": act,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms,
                     **dict(zip(("bound_ms", "bound_by"),
                                bound(nbytes * 4, flops, f32)))})
        if name in far:
            rows[-1]["rel_to_float64"] = far[name]
    del out
    emit({"phase": "static_train_kernels", "rows": rows})
    return rows


F64_FACTOR = 4.0   # kernels 6, 7 (f32): distance from float64 vs plain's


def float64_distances(ops, x, w, res, g, act, got, plain):
    """Kernels 6 and 7 (f32) against a float64 product on the same
    inputs: each output's largest distance from it over the float64
    output's scale, the kernel's beside the plain version's (cuBLAS's
    f32 product).  Fails unless the kernel's dX and dW stand within
    F64_FACTOR times the plain version's distance (dbias, a plain f32
    sum on both sides, is reported)."""
    mm = ops.matmul
    dz = mm._dact_from_residual(g.double(), res.double(), act, False)
    want = (dz @ w.double(), dz.t() @ x.double(), dz.sum(dim=0))
    del dz

    def rel(a, b):
        return ((a.double() - b).abs().max() / b.abs().max()).item()

    out = {}
    for name, tags, idx in (("matmul_bwd_dx", ("dx",), (0,)),
                            ("matmul_bwd_dw", ("dw", "dbias"), (1, 2))):
        out[name] = {"kernel": {t: rel(got[i], want[i])
                                for t, i in zip(tags, idx)},
                     "plain": {t: rel(plain[i], want[i])
                               for t, i in zip(tags, idx)},
                     "limit": "%g x plain (dx, dw)" % F64_FACTOR}
        t = tags[0]
        if not (out[name]["kernel"][t]
                <= F64_FACTOR * out[name]["plain"][t]):
            raise AssertionError(
                "static train %s: %g of the scale from float64, over %g x "
                "the plain version's %g" % (t, out[name]["kernel"][t],
                                            F64_FACTOR,
                                            out[name]["plain"][t]))
    return out


def _copy_scope(fluid, scope, names):
    out = fluid.Scope()
    for n in names:
        out.set(n, scope.find_var(n).clone())
    return out


def static_train_vs_plain(ptt):
    """One step of the pretraining program at dropout 0 from one seeded
    startup, run through the kernels and, from a copy of the same state,
    through their plain versions on the card (autograd through the
    plain forwards).  Gates: the loss within STATIC_TRAIN_REL of itself;
    each parameter's gradient within STATIC_TRAIN_REL of its scale (max
    |g|); each updated parameter within STATIC_TRAIN_REL of its scale
    (max |p|) beyond what AdamW makes of the two gradients.  The first
    AdamW step moves an element by lr g / (|g| + 3.2e-7): by +-lr
    whatever |g| is, unless |g| is near 3.2e-7, where a gradient's
    last-bit difference moves it by up to lr x 1e-8 / 3.2e-7; a zero-init
    bias's scale is lr itself.  So the update of each run's own gradient
    (`optimizer.adamw` on the initial state) is subtracted first: what
    remains is the update's own error."""
    fluid, ops = ptt.fluid, ptt.ops
    cfg, main, startup, loss = static_train_program(ptt, 0.0)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable]
    params = [p.name for p in main.all_parameters()]
    plain_scope = _copy_scope(fluid, scope, names)
    start = _copy_scope(fluid, scope, params)
    feed = static_train_feed(cfg, 2)
    fetch = [loss.name] + [n + "@GRAD" for n in params]
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                  return_numpy=False)
    ops.reset_launch_counts()
    p1, p2 = _plain_static(ops)
    with p1, p2:
        want = exe.run(main, feed=feed, fetch_list=fetch,
                       scope=plain_scope, return_numpy=False)
    if any(ops.launch_counts().values()):
        raise AssertionError("the plain step launched %s"
                             % ops.launch_counts())
    loss_rel = abs(got[0].item() - want[0].item()) / abs(want[0].item())
    opt = ptt.optimizer.AdamWOptimizer(STATIC_TRAIN_LR, weight_decay=0.01)
    worst_g, worst_p = (-1.0, ""), (-1.0, "")
    for n, g_k, g_p in zip(params, got[1:], want[1:]):
        g_scale = g_p.abs().max().item()
        err = (g_k - g_p).abs().max().item()
        worst_g = max(worst_g, (err / g_scale if g_scale else err, n))
        p0 = start.find_var(n)
        u_k, u_p = (ptt.optimizer.adamw(
            [p0], [g], STATIC_TRAIN_LR, *([v] for v in opt.init_slots(p0)
                                          .values()), **opt.attrs())[0][0]
            for g in (g_k, g_p))
        a, b_ = scope.find_var(n), plain_scope.find_var(n)
        scale = b_.abs().max().item()
        err = ((a - b_) - (u_k - u_p)).abs().max().item()
        worst_p = max(worst_p, (err / scale if scale else err, n))
    if not (loss_rel <= STATIC_TRAIN_REL and worst_g[0] <= STATIC_TRAIN_REL
            and worst_p[0] <= STATIC_TRAIN_REL
            and np.isfinite(got[0].item())):
        raise AssertionError(
            "static train step vs plain: loss %g vs %g (rel %g), worst "
            "gradient %s at %g of its scale, worst parameter %s at %g of "
            "its scale beyond the gradients' AdamW updates; limit %g" % (
                got[0].item(), want[0].item(), loss_rel, worst_g[1],
                worst_g[0], worst_p[1], worst_p[0], STATIC_TRAIN_REL))
    return {"loss": got[0].item(), "plain_loss": want[0].item(),
            "loss_rel_err": loss_rel, "max_grad_rel_err": worst_g[0],
            "worst_grad": worst_g[1], "max_param_rel_err": worst_p[0],
            "worst_param": worst_p[1], "limit": STATIC_TRAIN_REL}


def static_train(ptt):
    """BERT-base pretraining as a static program, trained by the
    Executor on the card: `models.bert_pretraining_program` (MLM over
    P = 20 masked positions with the tied decoder, NSP; vocab 30522, 12
    layers, hidden 768, 12 heads, FFN 3072; S = 128, B = 32, f32,
    dropout 0.1, the fused FFN) with AdamWOptimizer(1e-4, wd
    0.01).minimize, the startup program run on the card from a fixed
    seed, two seeded batches alternating over STATIC_TRAIN_WARMUP +
    STATIC_TRAIN_STEPS steps.  Gates: each step launches kernels 1, 5,
    6 and 7 once a layer and the flash backward the dispatch picks
    (kernel 4, or 2 and 3) once a layer, none of 8-11 (12 kernel-1 and
    12 kernel-5 launches: the tape recomputes nothing); finite, falling
    losses; one dropout-0 step against the plain versions
    (`static_train_vs_plain`); the trained program's
    ``clone(for_test=True)`` serves a batch equal to the training
    forward at is_test.  Then p50 / p99 a step (CUDA events), tokens/s,
    model TFLOP/s, peak memory, a profiled step, and the path's kernels
    at its shapes (`static_train_kernel_rows`)."""
    fluid, ops = ptt.fluid, ptt.ops
    t0 = time.perf_counter()
    cfg, main, startup, loss = static_train_program(ptt, 0.1)
    t1 = time.perf_counter()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    types = [o.type for o in main.global_block.ops]
    b, s, p = STATIC_TRAIN_B, STATIC_S, STATIC_TRAIN_P
    want, fused = _static_train_launches(ops, cfg, b)
    feeds = [static_train_feed(cfg, seed) for seed in (0, 1)]

    def step(i):
        out, = exe.run(main, feed=feeds[i % 2], fetch_list=[loss],
                       scope=scope, return_numpy=False)
        return out

    losses, per_step = [], []
    for i in range(STATIC_TRAIN_WARMUP):
        ops.reset_launch_counts()
        losses.append(step(i).item())
        per_step.append(ops.launch_counts())
        _expect_launches("static train step %d" % i, per_step[-1], want)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(STATIC_TRAIN_STEPS + 1)]
    outs = []
    t3 = time.perf_counter()
    evs[0].record()
    for n in range(STATIC_TRAIN_STEPS):
        outs.append(step(STATIC_TRAIN_WARMUP + n))
        evs[n + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t3
    run_launches = ops.launch_counts()
    _expect_launches("static train run", run_launches,
                     {k: v * STATIC_TRAIN_STEPS for k, v in want.items()})
    peak = torch.cuda.max_memory_allocated()
    ms = [evs[n].elapsed_time(evs[n + 1]) for n in range(STATIC_TRAIN_STEPS)]
    losses += [o.item() for o in outs]
    if not (np.isfinite(losses).all()
            and np.mean(losses[-2:]) < np.mean(losses[:2])):
        raise AssertionError("static train losses: %s" % losses)

    # the arguments kernels 1 and 5 got on the path, one more step
    calls = _recorded_calls(ops, lambda: step(0))
    prof = device_profile(lambda: step(1))
    # the trained program's inference clone against its training forward
    # at is_test (the clone's ops, and the training program's own run
    # with the whole block in test mode)
    test_prog = main.clone(for_test=True)
    ops.reset_launch_counts()
    served, = exe.run(test_prog, feed=feeds[0], fetch_list=[loss],
                      scope=scope)
    serve_launches = ops.launch_counts()
    as_test = main.clone()
    as_test._is_test = True
    trained, = exe.run(as_test, feed=feeds[0], fetch_list=[loss],
                       scope=scope)
    clone_err = compare("static train clone(for_test) loss",
                        torch.from_numpy(served), torch.from_numpy(trained),
                        TOL[torch.float32])
    _expect_launches("static train clone(for_test) forward", serve_launches,
                     {k: (v if k in ("flash_fwd", "matmul_bias_act") else 0)
                      for k, v in want.items()})
    del scope, exe
    kernel_rows = static_train_kernel_rows(ops, calls, fused)
    del calls
    vs_plain = static_train_vs_plain(ptt)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    flops = static_train_flops(cfg, b, s, p)
    p50 = float(np.percentile(ms, 50))
    emit({"phase": "static_train", "nvidia_smi": smi,
          "config": dict(STATIC_BERT, S=s, B=b, P=p, dtype="float32",
                         dropout=0.1, fused_ffn=True,
                         optimizer="AdamW(%g, wd 0.01)" % STATIC_TRAIN_LR,
                         startup_seed=STATIC_TRAIN_SEED),
          "flash_backward": "fused (kernel 4)" if fused
          else "pair (kernels 2 and 3)",
          "build_s": t1 - t0, "startup_s": t2 - t1,
          "ops_per_step": len(types),
          "op_types": {t: types.count(t) for t in sorted(set(types))},
          "parameters": len(main.all_parameters()),
          "launches_per_step": per_step[-1], "run_launches": run_launches,
          "steps": STATIC_TRAIN_STEPS, "losses": losses,
          "step_ms": ms, "p50_ms": p50,
          "p99_ms": float(np.percentile(ms, 99)),
          "wall_s": wall,
          "tokens_per_s": b * s * STATIC_TRAIN_STEPS / (sum(ms) / 1e3),
          "model_flops_per_step": flops,
          "model_tflops_at_p50": flops / p50 / 1e9,
          "share_of_67_tflops": flops / p50 / 1e9 / 67.0,
          "peak_memory_gb": peak / 1e9,
          "clone_for_test": {"loss": float(served),
                             "training_forward_at_is_test": float(trained),
                             "max_abs_err": clone_err[0],
                             "launches": serve_launches},
          "vs_plain": vs_plain, "profile": prof})
    return {"per_step": per_step[-1], "run_launches": run_launches,
            "steps": STATIC_TRAIN_STEPS, "kernel_rows": kernel_rows,
            "fused": fused}


# ---------------------------------------------------------------------------
# the Fluid book's first programs: recognize_digits (LeNet-5) trained,
# saved and served through kernel 5, and image_classification (VGG-16
# with batch norm) trained and served, through the static core's vision
# ops (cuDNN's convolutions and pooling, no hand kernel)
# ---------------------------------------------------------------------------

# the book's BATCH_SIZEs (test_recognize_digits.py 64,
# test_image_classification.py 128), f32, Adam(1e-3) as the book's
BOOK_LENET_B, BOOK_LENET_EPOCHS = 64, 5
BOOK_VGG_B = 128
BOOK_VGG_WARMUP, BOOK_VGG_STEPS = 2, 10
BOOK_SERVE_BATCHES = (1, 64)
BOOK_SERVE_REQUESTS = 20
BOOK_SEED = 43
BOOK_REL = 1e-4     # card vs CPU: loss, gradients, parameters, running stats
ROOT = os.path.dirname(os.path.abspath(__file__))
BOOK_DIR = os.path.join(ROOT, "build", "static_book")


def book_lenet5(layers, img, label):
    """`tests/test_book_mnist.py:28-38`'s LeNet-5; returns (mean loss,
    accuracy, the softmax prediction)."""
    conv1 = layers.conv2d(img, num_filters=6, filter_size=5, padding=2,
                          act="relu")
    pool1 = layers.pool2d(conv1, pool_size=2, pool_stride=2)
    conv2 = layers.conv2d(pool1, num_filters=16, filter_size=5, act="relu")
    pool2 = layers.pool2d(conv2, pool_size=2, pool_stride=2)
    fc1 = layers.fc(pool2, size=120, act="relu")
    fc2 = layers.fc(fc1, size=84, act="relu")
    logits = layers.fc(fc2, size=10)
    loss = layers.softmax_with_cross_entropy(logits, label)
    prob = layers.softmax(logits)
    return layers.mean(loss), layers.accuracy(prob, label), prob


def book_vgg16_bn(layers, img, label, dropout=True):
    """The book's `vgg16_bn_drop` (Paddle's tests/book/
    test_image_classification.py): five `img_conv_group`s (3x3 convs,
    pad 1, each with batch_norm + relu and dropout at the group's rates,
    none at 0, then a 2x2 max pool), dropout 0.5, fc 512, batch_norm
    + relu, dropout 0.5, fc 512, fc 10 softmax, cross_entropy, mean and
    accuracy.  ``dropout=False``: every rate 0 (the explicit dropout
    ops stay, keeping every unit)."""
    k = 1.0 if dropout else 0.0
    x = img
    for n, rates in ((64, (0.3, 0)), (128, (0.4, 0)), (256, (0.4, 0.4, 0)),
                     (512, (0.4, 0.4, 0)), (512, (0.4, 0.4, 0))):
        for rate in rates:
            x = layers.conv2d(x, num_filters=n, filter_size=3, padding=1)
            x = layers.batch_norm(x, act="relu")
            if rate * k > 1e-5:
                x = layers.dropout(x, dropout_prob=rate * k)
        x = layers.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")
    x = layers.dropout(x, dropout_prob=0.5 * k)
    x = layers.fc(x, size=512)
    x = layers.batch_norm(x, act="relu")
    x = layers.dropout(x, dropout_prob=0.5 * k)
    x = layers.fc(x, size=512)
    prob = layers.fc(x, size=10, act="softmax")
    loss = layers.mean(layers.cross_entropy(prob, label))
    return loss, layers.accuracy(prob, label), prob


def book_program(ptt, net, shape, **kw):
    """(main, startup, test clone, loss, accuracy, prediction) of ``net``
    on an f32 image of ``shape`` and an int64 label, minimized by
    AdamOptimizer(1e-3), the startup program seeded."""
    fluid, layers = ptt.fluid, ptt.fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data("img", shape=list(shape))
        label = layers.data("label", shape=[1], dtype="int64")
        loss, acc, prob = net(layers, img, label, **kw)
        test = main.clone(for_test=True)
        fluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
    startup.random_seed = BOOK_SEED
    return main, startup, test, loss, acc, prob


def book_feeds(ptt, reader, b, shape):
    """One epoch of a book reader in batches of ``b`` (the last partial
    batch dropped), as feeds: images reshaped to NCHW."""
    out = []
    for batch in ptt.batch(reader, b, drop_last=True)():
        feed = ptt.reader.to_feed(batch, ["img", "label"])
        feed["img"] = feed["img"].reshape((-1,) + tuple(shape))
        out.append(feed)
    return out


def _kink_flips(ops, card, cpu):
    """{"pool2d": [...], "relu": [...]}: for each op of ``ops`` (a max
    ``pool2d`` or a ``relu``) the elements whose gradient the card's
    and the CPU's forward route apart: windows whose argmax differs, or
    inputs on the other side of 0 (the book's unpadded NCHW pools)."""
    import torch.nn.functional as F

    out = {"pool2d": [], "relu": []}
    for op in ops:
        a, b = card[op.input("X")[0]].cpu(), cpu[op.input("X")[0]]
        if op.type == "relu":
            out["relu"].append(int(((a > 0) != (b > 0)).sum().item()))
            continue
        k = op.attrs["ksize"]
        st = op.attrs.get("strides", k)
        _, ia = F.max_pool2d(a, k, st, return_indices=True)
        _, ib = F.max_pool2d(b, k, st, return_indices=True)
        out["pool2d"].append(int((ia != ib).sum().item()))
    return out


def book_backward_on_cpu(block, vals):
    """The step's backward ops run again on the CPU, in program order,
    over the card step's forward: each input that no backward op writes
    is the card's value (``vals``: its activations, and the parameters
    as the step began), each gradient the CPU's own, from the loss's
    seed on.  A max pool or a relu so routes every gradient as the card
    did.  Returns {name: CPU value} of every var the backward ops
    write."""
    from paddle_tpu_torch.fluid.core.registry import (LowerContext,
                                                      get_op_def)

    env = {}
    for op in block.ops:
        if op.attrs.get("op_role") != "backward":
            continue
        ins = {slot: [env[v] if v in env else vals[v].cpu()
                      for v in op.input(slot)] for slot in op.inputs}
        with torch.no_grad():
            out = get_op_def(op.type).lower(LowerContext(), ins, op.attrs)
        for slot, ts in out.items():
            env.update(zip(op.output(slot), ts))
    return env


def book_card_vs_cpu(ptt, main, startup, loss, feed, loss_limit=BOOK_REL,
                     own_forward=False):
    """One step of ``main`` (no dropout) from one seeded startup, on the
    card and, from a copy of the same state, on the CPU.  Gates:

    * the loss within ``loss_limit`` of itself;
    * each parameter's gradient within BOOK_REL of its scale (max |g|)
      of the CPU's backward over the card's forward
      (`book_backward_on_cpu`), except a bias added right before a
      ``batch_norm``, whose gradient is 0 in exact arithmetic (the
      normalization removes it) and rounding noise on either side: both
      are held under BOOK_REL of the step's largest gradient.  The CPU
      step's own gradients are reported beside them, with the elements
      whose gradient the two forwards route apart (`_kink_flips`): a
      max pool's window whose two largest inputs lie within rounding of
      each other, or a relu's input within rounding of 0, sends its
      gradient elsewhere when the forward moves by 1e-7, and every
      gradient below it moves by up to a few percent of its scale;
    * each parameter within BOOK_REL of its scale (max |p|) beyond what
      its update op makes of the two runs' gradients (Adam moves an
      element by about +-lr whatever its gradient, and by a share of lr
      where |g| is near its eps: a rounding-level difference there is
      no fault, `static_train_vs_plain` likewise);
    * each running statistic within BOOK_REL of its scale.

    ``own_forward``: a path with no kink (no relu, no max pool) holds
    each gradient within BOOK_REL of its scale of the CPU step's own
    gradients instead, and reports the backward over the card's forward
    beside them."""
    fluid = ptt.fluid
    from paddle_tpu_torch.fluid.core.registry import (LowerContext,
                                                      get_op_def)

    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    names = [v.name for v in main.list_vars()
             if v.persistable and not v.is_data]
    start = {n: scope.find_var(n).to("cpu", copy=True) for n in names}
    cpu_scope = fluid.Scope()
    for n, t in start.items():
        cpu_scope.set(n, t.clone())
    params = [p.name for p in main.all_parameters() if p.trainable]
    stats = [p.name for p in main.all_parameters() if not p.trainable]
    block = main.global_block
    fwd = [op for op in block.ops if op.attrs.get("op_role") is None]
    bwd = [op for op in block.ops if op.attrs.get("op_role") == "backward"]
    bn_in = {n for op in fwd if op.type == "batch_norm"
             for n in op.input("X")}
    bn_fed = {op.input("Y")[0] for op in fwd
              if op.type == "elementwise_add"
              and op.output("Out")[0] in bn_in
              and block.var(op.input("Y")[0]).persistable}
    kinks = [op for op in fwd if op.type == "relu" or (
        op.type == "pool2d" and op.attrs.get("pooling_type") == "max")]
    kink_in = [op.input("X")[0] for op in kinks]
    written = {v for op in bwd for slot in op.outputs
               for v in op.output(slot)}
    bwd_in = sorted({v for op in bwd for slot in op.inputs
                     for v in op.input(slot)} - written)
    fetch = [loss.name] + [n + "@GRAD" for n in params] + kink_in
    got = exe.run(main, feed=feed, fetch_list=fetch + bwd_in, scope=scope,
                  return_numpy=False)
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=cpu_scope,
        return_numpy=False)
    k = 1 + len(params)
    flips = _kink_flips(kinks, dict(zip(kink_in, got[k:])),
                        dict(zip(kink_in, want[k:])))
    # the parameters as the step began: the fetch reads them updated
    swept = book_backward_on_cpu(block, {
        v: start.get(v, t) for v, t in zip(bwd_in, got[k + len(kink_in):])})
    got, want = got[:k], want[:k]
    top = max(g.abs().max().item() for g in want[1:])
    update_of = {op.input("Param")[0]: op for op in block.ops
                 if op.attrs.get("op_role") == "optimize"}

    def updated(name, grad):
        op = update_of[name]
        ins = {slot: [grad if slot == "Grad" else start[n].clone()
                      for n in op.input(slot)] for slot in op.inputs}
        return get_op_def(op.type).lower(LowerContext(), ins,
                                         op.attrs)["ParamOut"][0]

    def rel(a, b):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        return err / scale if scale else err

    if own_forward and kinks:
        raise AssertionError("own_forward on a path with kinks: %s"
                             % sorted({op.type for op in kinks}))
    loss_rel = abs(got[0].item() - want[0].item()) / abs(want[0].item())
    worst_g, worst_z, worst_step = (-1.0, ""), (-1.0, ""), (-1.0, "")
    worst_p, worst_s = (-1.0, ""), (-1.0, "")
    for n, g_card, g_cpu in zip(params, got[1:], want[1:]):
        g_card, g_swept = g_card.cpu(), swept[n + "@GRAD"]
        if n in bn_fed:
            noise = max(g_card.abs().max().item(),
                        g_swept.abs().max().item())
            worst_z = max(worst_z, (noise / top, n))
        else:
            worst_g = max(worst_g, (rel(g_card, g_swept), n))
            worst_step = max(worst_step, (rel(g_card, g_cpu), n))
        a, b = scope.find_var(n).cpu(), cpu_scope.find_var(n)
        du = updated(n, g_card) - updated(n, g_cpu)
        scale = b.abs().max().item()
        err = ((a - b) - du).abs().max().item()
        worst_p = max(worst_p, (err / scale if scale else err, n))
    for n in stats:
        a, b = scope.find_var(n).cpu(), cpu_scope.find_var(n)
        err = (a - b).abs().max().item() / b.abs().max().item()
        worst_s = max(worst_s, (err, n))
    gated = worst_step if own_forward else worst_g
    if not (np.isfinite(got[0].item()) and loss_rel <= loss_limit
            and gated[0] <= BOOK_REL and worst_z[0] <= BOOK_REL
            and worst_p[0] <= BOOK_REL and worst_s[0] <= BOOK_REL):
        raise AssertionError(
            "book step, card vs CPU: loss %g vs %g (rel %g, limit %g); "
            "worst gradient %s at %g of its scale of the CPU's backward "
            "over the card's forward; worst batch_norm-fed bias gradient "
            "%s at %g of the step's largest gradient; worst parameter %s "
            "at %g of its scale beyond the two gradients' updates; worst "
            "running statistic %s at %g; limit %g (the CPU step's own "
            "gradients, gated: %s: worst %s at %g, kink flips %s)" % (
                got[0].item(), want[0].item(), loss_rel, loss_limit,
                worst_g[1], worst_g[0], worst_z[1], worst_z[0], worst_p[1],
                worst_p[0], worst_s[1], worst_s[0], BOOK_REL, own_forward,
                worst_step[1], worst_step[0], flips))
    return {"loss": got[0].item(), "cpu_loss": want[0].item(),
            "loss_rel_err": loss_rel, "backward_ops": len(bwd),
            "max_grad_rel_err": worst_g[0], "worst_grad": worst_g[1],
            "grad_share_of_limit": worst_g[0] / BOOK_REL,
            "bn_fed_bias_grads": len(bn_fed),
            "max_bn_fed_bias_grad_of_top": worst_z[0] if bn_fed else None,
            "cpu_step_max_grad_rel_err": worst_step[0],
            "cpu_step_worst_grad": worst_step[1],
            "gated_on_cpu_step": own_forward,
            "cpu_step_grad_share_of_limit": worst_step[0] / BOOK_REL,
            "loss_limit": loss_limit, "kink_flips": flips,
            "max_param_rel_err": worst_p[0],
            "worst_param": worst_p[1], "max_running_stat_rel_err":
            worst_s[0] if stats else None, "limit": BOOK_REL}


def _no_launches(tag, ops):
    _expect_launches(tag, ops.launch_counts(),
                     {k: 0 for k in ops.KERNEL_WRAPPERS})


def book_serve(ptt, main, prob, exe, scope, name, passes, feeds_b,
               width=10):
    """Save ``main``'s inference program (the feeds of ``feeds_b`` ->
    ``prob``, ``width`` columns) with the port's `save_inference_model`,
    load it into a `create_predictor` on the card, run each feed of
    ``feeds_b`` ({b: {name: array}}) unfused, apply ``passes`` and run
    it again.  Returns (predictor, {b: (unfused, fused) outputs}, {b:
    launches of the fused forward}, op types)."""
    import shutil

    fluid, inference, ops = ptt.fluid, ptt.inference, ptt.ops
    d = os.path.join(BOOK_DIR, name)
    shutil.rmtree(d, ignore_errors=True)
    names = list(next(iter(feeds_b.values())))
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, names, [prob], exe, main)
    pred = inference.create_predictor(inference.AnalysisConfig(d))
    plain = {b: pred.run(f)[0] for b, f in feeds_b.items()}
    fluid.ir.apply_passes(pred._program, passes)
    outs, launches = {}, {}
    for b, f in feeds_b.items():
        ops.reset_launch_counts()
        out = pred.run(f)[0]
        launches[b] = ops.launch_counts()
        if out.shape != (b, width) or not np.isfinite(out).all():
            raise AssertionError("%s served shape %s" % (name, out.shape))
        compare("%s served B=%d, fused vs unfused" % (name, b),
                torch.from_numpy(out), torch.from_numpy(plain[b]),
                TOL[torch.float32])
        outs[b] = (plain[b], out)
    shutil.rmtree(d, ignore_errors=True)
    return pred, outs, launches, [o.type for o in pred._program.global_block
                                  .ops]


def static_book_lenet(ptt):
    """recognize_digits: LeNet-5 trained by the Executor on the card
    over BOOK_LENET_EPOCHS epochs of `dataset.mnist.train()` at B = 64
    (no kernel: convs, pools and the fc `mul`s are cuDNN's and
    cuBLAS's); gates: the last epoch's mean loss under half the first
    step's, the test clone's accuracy on `dataset.mnist.test()` over
    0.5, one step against the CPU's (`book_card_vs_cpu`).  Then saved
    and served through `create_predictor` + ``matmul_bias_act_fuse`` at
    B = 1 and 64: exactly 2 kernel-5 launches a forward (fc 120 relu,
    fc 84 relu) and none of any other kernel, each batch within TOL f32
    of the unfused program's; kernel 5 at the served shapes against its
    plain version and timed."""
    fluid, ops = ptt.fluid, ptt.ops
    shape = (1, 28, 28)
    main, startup, test, loss, acc, prob = book_program(ptt, book_lenet5,
                                                        shape)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    train = book_feeds(ptt, ptt.dataset.mnist.train(), BOOK_LENET_B, shape)
    ops.reset_launch_counts()
    losses = []
    feeds = train * BOOK_LENET_EPOCHS
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(len(feeds) + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evs[0].record()
    for i, feed in enumerate(feeds):
        lv, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      return_numpy=False)
        losses.append(lv)
        evs[i + 1].record()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = [v.item() for v in losses]
    step_ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(len(feeds))]
    train_launches = ops.launch_counts()
    _no_launches("lenet train", ops)
    last = float(np.mean(losses[-len(train):]))
    if not (np.isfinite(losses).all() and last < 0.5 * losses[0]):
        raise AssertionError("lenet losses %s" % losses)
    test_feeds = book_feeds(ptt, ptt.dataset.mnist.test(), BOOK_LENET_B,
                            shape)
    accs = [exe.run(test, feed=f, fetch_list=[acc], scope=scope)[0].item()
            for f in test_feeds]
    if not np.mean(accs) > 0.5:
        raise AssertionError("lenet test accuracy %s" % accs)
    vs_cpu = book_card_vs_cpu(ptt, main, startup, loss, train[0])

    feeds_b = {b: {"img": test_feeds[0]["img"][:b]}
               for b in BOOK_SERVE_BATCHES}
    pred, outs, launches, types = book_serve(
        ptt, main, prob, exe, scope, "lenet5", ["matmul_bias_act_fuse"],
        feeds_b)
    want = {k: 0 for k in ops.KERNEL_WRAPPERS}
    want["matmul_bias_act"] = 2
    for b in BOOK_SERVE_BATCHES:
        _expect_launches("lenet served forward B=%d" % b, launches[b], want)
    b = BOOK_SERVE_BATCHES[-1]
    calls = _recorded_calls(ops, lambda: pred.run_async([feeds_b[b]["img"]]))
    rows = mba_rows(ops, calls["mba"], "lenet")
    if sorted((r["M"], r["K"], r["N"], r["act"]) for r in rows) != [
            (b, 120, 84, "relu"), (b, 400, 120, "relu")]:
        raise AssertionError("lenet kernel 5 shapes %s" % rows)
    latency = {}
    for bb in BOOK_SERVE_BATCHES:
        ts = []
        for _ in range(BOOK_SERVE_REQUESTS):
            t = time.perf_counter()
            pred.run([feeds_b[bb]["img"]])
            ts.append((time.perf_counter() - t) * 1e3)
        latency[bb] = {"p50_ms": float(np.percentile(ts, 50)),
                       "min_ms": min(ts)}
    ops.reset_launch_counts()
    for bb in BOOK_SERVE_BATCHES:
        pred.run([feeds_b[bb]["img"]])
    serve_launches = ops.launch_counts()
    del pred, scope, exe
    return {"config": dict(net="LeNet-5 (tests/test_book_mnist.py)", B=b,
                           epochs=BOOK_LENET_EPOCHS, steps=len(losses),
                           optimizer="Adam(1e-3)", dtype="float32",
                           startup_seed=BOOK_SEED),
            "ops_per_step": len(main.global_block.ops),
            "train_s": train_s, "step_ms": step_ms,
            "p50_ms_after_2": float(np.percentile(step_ms[2:], 50)),
            "losses": losses, "last_epoch_loss": last,
            "train_launches": train_launches, "test_accuracy": accs,
            "card_vs_cpu": vs_cpu, "served_op_types": {
                t: types.count(t) for t in sorted(set(types))},
            "served_launches": launches, "served_max_abs_err": {
                bb: float(np.abs(f - p).max()) for bb, (p, f) in outs.items()},
            "serve_latency": latency, "serve_run_launches": serve_launches,
            "kernel_rows": rows}


def static_book_vgg(ptt):
    """image_classification: the book's VGG-16 with batch norm trained
    by the Executor on the card on `dataset.cifar.train10()` at B = 128
    (BOOK_VGG_WARMUP + BOOK_VGG_STEPS steps, the reader's four batches
    in turn); gates: finite losses, the last epoch's mean under the
    first's, every running mean and variance moved from its initial 0
    and 1, no launch of any kernel (cuDNN's convs, the plain BN passes,
    cuBLAS's `mul`s), one dropout-0 step against the CPU's
    (`book_card_vs_cpu`); then p50 / p99 a step (CUDA events),
    images/s, peak memory, ops a step and a profiled step.  Served
    through `create_predictor` + ``batch_norm_act_fuse`` at B = 128:
    14 ``fused_batch_norm_act`` ops, the output within TOL f32 of the
    unfused program's, no kernel launched (the fc layers carry no act
    that ``matmul_bias_act_fuse`` takes: fc 512 feeds a batch_norm or
    the last fc, fc 10 ends in softmax)."""
    fluid, ops = ptt.fluid, ptt.ops
    shape = (3, 32, 32)
    t0 = time.perf_counter()
    main, startup, test, loss, acc, prob = book_program(ptt, book_vgg16_bn,
                                                        shape)
    t1 = time.perf_counter()
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    stats = [p.name for p in main.all_parameters() if not p.trainable]
    init = {n: scope.find_var(n).clone() for n in stats}
    train = book_feeds(ptt, ptt.dataset.cifar.train10(), BOOK_VGG_B, shape)
    n_feed = len(train)

    def step(i):
        out, = exe.run(main, feed=train[i % n_feed], fetch_list=[loss],
                       scope=scope, return_numpy=False)
        return out

    ops.reset_launch_counts()
    losses = [step(i).item() for i in range(BOOK_VGG_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(BOOK_VGG_STEPS + 1)]
    outs = []
    evs[0].record()
    for n in range(BOOK_VGG_STEPS):
        outs.append(step(BOOK_VGG_WARMUP + n))
        evs[n + 1].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = [evs[n].elapsed_time(evs[n + 1]) for n in range(BOOK_VGG_STEPS)]
    losses += [o.item() for o in outs]
    prof = device_profile(lambda: step(0))
    train_launches = ops.launch_counts()
    _no_launches("vgg train", ops)
    if not (np.isfinite(losses).all() and np.mean(losses[-n_feed:])
            < np.mean(losses[:n_feed])):
        raise AssertionError("vgg losses %s" % losses)
    still = [n for n in stats
             if (scope.find_var(n) == init[n]).any().item()]
    if len(stats) != 28 or still:
        raise AssertionError("vgg running statistics: %d, unmoved %s"
                             % (len(stats), still))

    ops.reset_launch_counts()
    pred, outs_b, launches, types = book_serve(
        ptt, main, prob, exe, scope, "vgg16_bn", ["batch_norm_act_fuse"],
        {BOOK_VGG_B: {"img": train[0]["img"]}})
    _expect_launches("vgg served forward", launches[BOOK_VGG_B],
                     {k: 0 for k in ops.KERNEL_WRAPPERS})
    if types.count("fused_batch_norm_act") != 14 or "batch_norm" in types:
        raise AssertionError("vgg served ops %s" % sorted(set(types)))
    del pred, scope, exe

    main0, startup0, _, loss0, _, _ = book_program(
        ptt, book_vgg16_bn, shape, dropout=False)
    vs_cpu = book_card_vs_cpu(ptt, main0, startup0, loss0, train[0])
    p50 = float(np.percentile(ms, 50))
    return {"config": dict(net="VGG-16 with batch norm (vgg16_bn_drop)",
                           B=BOOK_VGG_B, image="3x32x32",
                           optimizer="Adam(1e-3)", dtype="float32",
                           startup_seed=BOOK_SEED),
            "build_s": t1 - t0, "ops_per_step": len(main.global_block.ops),
            "op_types": {t: [o.type for o in main.global_block.ops].count(t)
                         for t in sorted({o.type for o in
                                          main.global_block.ops})},
            "losses": losses, "step_ms": ms, "p50_ms": p50,
            "p99_ms": float(np.percentile(ms, 99)),
            "images_per_s": BOOK_VGG_B * BOOK_VGG_STEPS / (sum(ms) / 1e3),
            "peak_memory_gb": peak / 1e9, "profile": prof,
            "train_launches": train_launches,
            "served_op_types": {t: types.count(t) for t in sorted(set(types))},
            "served_launches": launches[BOOK_VGG_B],
            "served_max_abs_err": float(np.abs(
                outs_b[BOOK_VGG_B][1] - outs_b[BOOK_VGG_B][0]).max()),
            "card_vs_cpu": vs_cpu}


def static_book(ptt):
    """The Fluid book's recognize_digits (`static_book_lenet`) and
    image_classification (`static_book_vgg`) programs, with TF32 off in
    cuBLAS and cuDNN for the phase (its card-vs-CPU gates at 1e-4 need
    f32 products)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lenet = static_book_lenet(ptt)
    t1 = time.perf_counter()
    vgg = static_book_vgg(ptt)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "static_book", "nvidia_smi": smi,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "lenet_s": t1 - t0, "vgg_s": time.perf_counter() - t1,
          "recognize_digits": lenet, "image_classification": vgg})
    return {"per_forward": lenet["served_launches"][BOOK_SERVE_BATCHES[-1]],
            "run_launches": {k: lenet["serve_run_launches"][k]
                             + lenet["train_launches"][k]
                             + vgg["train_launches"][k]
                             + vgg["served_launches"][k]
                             for k in ptt.ops.KERNEL_WRAPPERS},
            "kernel_rows": lenet["kernel_rows"]}


# the Fluid book's embedding programs, at Paddle v1.8's book-test widths
# (tests/book/test_word2vec.py: N = 5, EMBED_SIZE 32, HIDDEN_SIZE 256,
# BATCH_SIZE 32, SGD(1e-3); test_recommender_system.py: embeddings
# 32 / 16 / 16 / 16 and 32 / 32 with an fc each, the towers fc 200
# tanh, cos_sim x 5, square_error_cost, SGD(0.2), BATCH_SIZE 256), f32
W2V_N, W2V_EMB, W2V_HID, W2V_B = 5, 32, 256, 32
W2V_WORDS = ("firstw", "secondw", "thirdw", "forthw", "nextw")
W2V_EPOCHS = 4
REC_B, REC_BATCHES, REC_EPOCHS = 256, 30, 3
REC_FEEDS = ("user_id", "gender_id", "age_id", "job_id", "movie_id",
             "category_id", "score")
EMBED_SERVE_BATCHES = {"word2vec": (1, W2V_B), "recommender": (1, REC_B)}
EMBED_WARMUP = 2
EMBED_LOSS_REL = 1e-5   # card vs CPU: the loss of one step
SWEEP_REL = 1e-5        # the op sweep: card vs CPU, of each output's scale


def book_word2vec(layers, dict_size):
    """Paddle's book `test_word2vec.py`: four lookups of one table
    (``param_attr="shared_w"``), concat, fc 256 sigmoid, fc dict_size
    softmax, cross_entropy against the fifth word, mean.  Returns (mean
    loss, the softmax prediction)."""
    words = [layers.data(n, shape=[1], dtype="int64") for n in W2V_WORDS]
    embs = [layers.embedding(w, size=[dict_size, W2V_EMB], dtype="float32",
                             is_sparse=False, param_attr="shared_w")
            for w in words[:4]]
    hidden = layers.fc(layers.concat(embs, axis=1), size=W2V_HID,
                       act="sigmoid")
    predict = layers.fc(hidden, size=dict_size, act="softmax")
    return layers.mean(layers.cross_entropy(predict, words[4])), predict


def book_recommender(layers, ml):
    """Paddle's book `test_recommender_system.py` on the synthetic
    `dataset.movielens`: the user tower (id 32, gender 16, age 16, job
    16, an fc of each width on each, concat, fc 200 tanh) and the movie
    tower (id 32 and an fc 32; the category id's embedding 32, which the
    book sums over a sequence with ``sequence_pool``: the synthetic
    dataset yields one category id, whose sum is its embedding; the
    book's title CNN is dropped, the dataset has no title; concat, fc
    200 tanh), cos_sim x 5 against ``score`` by square_error_cost, mean.
    Returns (mean loss, the scaled similarity)."""
    uid, gender, age, job, mid, cat = (
        layers.data(n, shape=[1], dtype="int64") for n in REC_FEEDS[:6])
    score = layers.data("score", shape=[1], dtype="float32")

    def emb_fc(ids, rows, width, table):
        return layers.fc(layers.embedding(ids, size=[rows, width],
                                          is_sparse=False, param_attr=table),
                         size=width)

    usr = layers.fc(layers.concat([
        emb_fc(uid, ml.max_user_id() + 1, 32, "user_table"),
        emb_fc(gender, 2, 16, "gender_table"),
        emb_fc(age, ml.AGE_COUNT, 16, "age_table"),
        emb_fc(job, ml.max_job_id() + 1, 16, "job_table")], axis=1),
        size=200, act="tanh")
    mov_cat = layers.embedding(cat, size=[ml.CATEGORY_COUNT, 32],
                               is_sparse=False)
    mov = layers.fc(layers.concat([
        emb_fc(mid, ml.max_movie_id() + 1, 32, "movie_table"), mov_cat],
        axis=1), size=200, act="tanh")
    infer = layers.scale(layers.ops.cos_sim(usr, mov), scale=5.0)
    return layers.mean(layers.square_error_cost(infer, score)), infer


def embed_program(ptt, name):
    """(main, startup, loss, prediction, feed names, served feed names)
    of a book embedding program, minimized by the book's SGD, the
    startup program seeded."""
    fluid, layers, ds = ptt.fluid, ptt.fluid.layers, ptt.dataset
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if name == "word2vec":
            loss, pred = book_word2vec(layers,
                                       len(ds.imikolov.build_dict()))
            lr, feeds = 1e-3, list(W2V_WORDS)
        else:
            loss, pred = book_recommender(layers, ds.movielens)
            lr, feeds = 0.2, list(REC_FEEDS)
        fluid.optimizer.SGDOptimizer(learning_rate=lr).minimize(loss)
    startup.random_seed = BOOK_SEED
    return main, startup, loss, pred, feeds, feeds[:-1]


def embed_feeds(ptt, name):
    """One epoch of the program's book reader as feeds (the last
    partial batch dropped): word2vec's 5-grams of `dataset.imikolov` at
    B = 32, REC_BATCHES batches of `dataset.movielens` at B = 256."""
    ds = ptt.dataset
    if name == "word2vec":
        reader = ds.imikolov.train(ds.imikolov.build_dict(), W2V_N)
        names, b = W2V_WORDS, W2V_B
    else:
        reader = ds.movielens.train(REC_B * REC_BATCHES)
        names, b = REC_FEEDS, REC_B
    out = []
    for batch in ptt.batch(reader, b, drop_last=True)():
        feed = ptt.reader.to_feed(batch, list(names))
        if "score" in feed:
            feed["score"] = feed["score"].astype(np.float32)
        out.append(feed)
    return out


def embed_train(ptt, main, startup, loss, train, epochs):
    """``epochs`` passes over ``train`` through the Executor on the card:
    the losses, each step's CUDA-event ms after EMBED_WARMUP steps, the
    examples/s over them, the peak memory, a profiled step (one more
    step, outside the losses) and the launches of every kernel over the
    run."""
    fluid, ops = ptt.fluid, ptt.ops
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    feeds = train * epochs
    ops.reset_launch_counts()
    losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                      return_numpy=False)[0] for f in feeds[:EMBED_WARMUP]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = feeds[EMBED_WARMUP:]
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(len(timed) + 1)]
    evs[0].record()
    for i, f in enumerate(timed):
        losses.append(exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                              return_numpy=False)[0])
        evs[i + 1].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(lambda: exe.run(main, feed=timed[0],
                                          fetch_list=[loss], scope=scope))
    launches = ops.launch_counts()
    losses = [v.item() for v in losses]
    ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(len(timed))]
    first = float(np.mean(losses[:len(train)]))
    last = float(np.mean(losses[-len(train):]))
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError("losses: first epoch %g, last %g: %s"
                             % (first, last, losses))
    b = next(iter(train[0].values())).shape[0]
    return exe, scope, {
        "steps": len(losses), "epochs": epochs,
        "first_epoch_loss": first, "last_epoch_loss": last,
        "losses_first_last": [losses[0], losses[-1]],
        "step_ms_p50": float(np.percentile(ms, 50)),
        "step_ms_p99": float(np.percentile(ms, 99)),
        "examples_per_s": b * len(ms) / (sum(ms) / 1e3),
        "peak_memory_gb": peak / 1e9, "profile": prof,
        "ops_per_step": len(main.global_block.ops),
        "op_types": {t: [o.type for o in main.global_block.ops].count(t)
                     for t in sorted({o.type for o in
                                      main.global_block.ops})},
        "train_launches": launches}


def _sweep_rel(got, want):
    """|got - want| over max |want| (an integer output: 0 if equal; NaN
    where want is NaN and nowhere else, or inf)."""
    got = got.cpu()
    if not want.is_floating_point():
        return 0.0 if torch.equal(got, want) else float("inf")
    nan = want.isnan()
    if not torch.equal(got.isnan(), nan):
        return float("inf")
    got, want = got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0)
    scale = want.abs().max().item()
    err = (got.double() - want.double()).abs().max().item()
    return err / scale if scale else err


def op_sweep(ptt, cases=None):
    """Every op `fluid.layers.ops` reaches (and concat), at the inputs of
    `tests/test_torch_static_surface.py` (the cases the CPU tests hold
    against the JAX lowerings), or the ops of another such table
    (``cases``): its forward and its ``vjp_grad`` (seeded cotangents on
    every floating output a program differentiates) on the card against
    the same on the CPU, each output within SWEEP_REL of its scale
    (integer and boolean outputs equal).
    Returns {op: {"forward": worst, "grad": worst, "cases": n}}."""
    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.append(os.path.join(ROOT, "tests"))
    if cases is None:
        from test_torch_static_surface import SURFACE as cases
    from paddle_tpu_torch.fluid.core.registry import LowerContext, get_op_def

    worst = {}
    for case, (op_type, ins, attrs) in sorted(cases.items()):
        opdef = get_op_def(op_type)

        def run(dev, op, tins, at):
            with torch.no_grad():
                return get_op_def(op).lower(LowerContext(device=dev), {
                    k: [torch.from_numpy(a).to(dev) for a in v]
                    for k, v in tins.items()}, at)

        card, cpu = (run(d, op_type, ins, attrs) for d in ("cuda", "cpu"))
        fwd = max(_sweep_rel(g, w) for k in cpu
                  for g, w in zip(card[k], cpu[k]))
        grad = None
        slots = [sl for sl, arrs in ins.items()
                 if sl not in opdef.no_grad_slots
                 and all(np.issubdtype(a.dtype, np.floating) for a in arrs)]
        out_slots = [sl for sl in opdef.output_slots
                     if sl in cpu and sl not in opdef.stateful_out_slots]
        present = [[o.is_floating_point() for o in cpu[sl]]
                   for sl in out_slots]
        if slots and any(map(any, present)):
            rng = np.random.RandomState(5)
            vins = {"X$" + k: v for k, v in ins.items()}
            for sl, here in zip(out_slots, present):
                cots = [rng.standard_normal(tuple(o.shape)).astype(np.float32)
                        for o, h in zip(cpu[sl], here) if h]
                if cots:
                    vins["DO$" + sl] = cots
            vattrs = {"fwd_type": op_type, "fwd_attrs": dict(attrs),
                      "fwd_in_slots": list(ins), "fwd_out_slots": out_slots,
                      "fwd_out_counts": [len(cpu[sl]) for sl in out_slots],
                      "out_grad_present": present, "grad_in_slots": slots}
            gcard, gcpu = (run(d, "vjp_grad", vins, vattrs)
                           for d in ("cuda", "cpu"))
            grad = max(_sweep_rel(g, w) for k in gcpu
                       for g, w in zip(gcard[k], gcpu[k]))
        row = worst.setdefault(op_type, {"forward": 0.0, "grad": None,
                                         "cases": 0, "worst_case": case})
        if fwd > row["forward"] or (grad or 0.0) > (row["grad"] or 0.0):
            row["worst_case"] = case
        row["forward"] = max(row["forward"], fwd)
        if grad is not None:
            row["grad"] = max(row["grad"] or 0.0, grad)
        row["cases"] += 1
    bad = {op: r for op, r in worst.items()
           if max(r["forward"], r["grad"] or 0.0) > SWEEP_REL}
    if bad:
        raise AssertionError("op sweep, card vs CPU, over %g of scale: %s"
                             % (SWEEP_REL, bad))
    return worst


def static_book_embed(ptt):
    """The Fluid book's word2vec and recommender_system programs (Paddle
    v1.8's book tests at their widths, f32), built with the port's
    `fluid.layers` and trained through the Executor on the card by SGD:
    word2vec W2V_EPOCHS epochs of `dataset.imikolov`'s 5-grams at B = 32,
    the recommender REC_EPOCHS epochs of REC_BATCHES batches of
    `dataset.movielens` at B = 256.  Gates: finite losses, the last
    epoch's mean under the first's, one embedding table in word2vec; one
    step on the card against the CPU (`book_card_vs_cpu` on the CPU's
    own forward: the paths have no kink; the loss within
    EMBED_LOSS_REL); no kernel launched in training (the fcs are `mul`
    + `elementwise_add`).  Served through `create_predictor` +
    ``matmul_bias_act_fuse``: word2vec at B = 1 and 32 launches no
    kernel (its fcs end in sigmoid and softmax, acts kernel 5 lacks);
    the recommender at B = 1 and 256 launches kernel 5 exactly twice a
    forward, at (B, 80, 200) and (B, 64, 200) tanh, and no other; each
    within TOL f32 of the unfused program; kernel 5 at those shapes
    against its plain version and timed.  Then every op of
    `fluid.layers.ops` on the card against the CPU (`op_sweep`).  TF32
    is off in cuBLAS and cuDNN for the phase (its card-vs-CPU gates need
    f32 products)."""
    ops = ptt.ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    kernel_rows, served_forward = [], {}
    for name, epochs in (("word2vec", W2V_EPOCHS),
                         ("recommender", REC_EPOCHS)):
        t0 = time.perf_counter()
        main, startup, loss, pred, feed_names, served = embed_program(
            ptt, name)
        train = embed_feeds(ptt, name)
        exe, scope, res = embed_train(ptt, main, startup, loss, train,
                                      epochs)
        _no_launches(name + " train", ops)
        tables = sorted({op.input("W")[0] for op in main.global_block.ops
                         if op.type == "lookup_table"})
        if name == "word2vec" and tables != ["shared_w"]:
            raise AssertionError("word2vec tables %s" % tables)
        res["tables"] = tables
        res["card_vs_cpu"] = book_card_vs_cpu(
            ptt, main, startup, loss, train[0],
            loss_limit=EMBED_LOSS_REL, own_forward=True)
        width = int(pred.shape[-1])
        feeds_b = {b: {n: train[0][n][:b] for n in served}
                   for b in EMBED_SERVE_BATCHES[name]}
        predictor, outs, launches, types = book_serve(
            ptt, main, pred, exe, scope, name, ["matmul_bias_act_fuse"],
            feeds_b, width=width)
        want = {k: 0 for k in ops.KERNEL_WRAPPERS}
        if name == "recommender":
            want["matmul_bias_act"] = 2
        for b in feeds_b:
            _expect_launches("%s served forward B=%d" % (name, b),
                             launches[b], want)
        served_forward[name] = launches[max(feeds_b)]
        if name == "recommender":
            calls = []
            for b in feeds_b:
                calls += _recorded_calls(
                    ops, lambda: predictor.run_async(feeds_b[b]))["mba"]
            rows = mba_rows(ops, calls, name)
            shapes = sorted((r["M"], r["K"], r["N"], r["act"]) for r in rows)
            if shapes != sorted((b, k, 200, "tanh") for b in feeds_b
                                for k in (64, 80)):
                raise AssertionError("recommender kernel 5 shapes %s"
                                     % shapes)
            kernel_rows = rows
        latency = {}
        for b, f in feeds_b.items():
            ts = []
            for _ in range(BOOK_SERVE_REQUESTS):
                t = time.perf_counter()
                predictor.run(f)
                ts.append((time.perf_counter() - t) * 1e3)
            latency[b] = {"p50_ms": float(np.percentile(ts, 50)),
                          "min_ms": min(ts)}
        ops.reset_launch_counts()
        for f in feeds_b.values():
            predictor.run(f)
        res.update({
            "served_op_types": {t: types.count(t) for t in sorted(set(types))},
            "served_launches": launches, "serve_run_launches":
                ops.launch_counts(),
            "served_max_abs_err": {b: float(np.abs(f - p).max())
                                   for b, (p, f) in outs.items()},
            "serve_latency": latency, "seconds": time.perf_counter() - t0})
        out[name] = res
        del predictor, scope, exe
    t0 = time.perf_counter()
    sweep = op_sweep(ptt)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "static_book_embed", "nvidia_smi": smi,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "word2vec": dict(out["word2vec"], config=dict(
              net="Paddle book test_word2vec.py", N=W2V_N, emb=W2V_EMB,
              hidden=W2V_HID, B=W2V_B, optimizer="SGD(1e-3)",
              dtype="float32", startup_seed=BOOK_SEED),
              served_note="0 launches: the fcs end in sigmoid and softmax, "
                          "acts kernel 5 lacks (none / relu / tanh / gelu; "
                          "the pass takes relu / tanh / gelu)"),
          "recommender_system": dict(out["recommender"], config=dict(
              net="Paddle book test_recommender_system.py (no title CNN, "
                  "one category id)", B=REC_B, batches=REC_BATCHES,
              optimizer="SGD(0.2)", dtype="float32",
              startup_seed=BOOK_SEED), kernel_rows=kernel_rows,
              kernel_note="launch-bound shapes, not tuned"),
          "op_sweep": sweep, "op_sweep_limit": SWEEP_REL,
          "op_sweep_s": time.perf_counter() - t0})
    return {"per_forward": served_forward["recommender"],
            "run_launches": {k: sum(r["train_launches"][k]
                                    + r["serve_run_launches"][k]
                                    for r in out.values())
                             for k in ops.KERNEL_WRAPPERS},
            "kernel_rows": kernel_rows}


# ---------------------------------------------------------------------------
# the WMT Transformer-base as a static program (`models.transformer_program`),
# trained by the Executor on Adam + noam_decay and served, through kernels
# 1 and 4 (or 2 and 3) in training and 1 and 5 in serving, with the rest
# of `fluid.layers.tensor` swept card against CPU
# ---------------------------------------------------------------------------

# "Attention Is All You Need" §5.3-5.4 (Transformer-base: Adam(0.9, 0.98,
# 1e-9) on noam_decay(512, 4000), label smoothing 0.1, dropout 0.1) at
# about the paper's per-GPU share (25k target tokens over 8 GPUs): 32
# pairs of 128 source and 120 target tokens, f32
TR_B, TR_SRC, TR_TGT = 32, 128, 120
TR_MIN_SRC = 64               # source rows: lengths in [64, 128]
TR_SEED = 47
TR_WARMUP, TR_STEPS = 2, 10
TR_NOAM_WARMUP = 4000
TR_LEARN_WARMUP, TR_LEARN_STEPS = 10, 30   # the learning gate's own cut
TR_REL = 1e-4           # kernels vs plain: the loss, gradients, parameters
TR_LR_REL = 1e-6        # the fetched rate vs noam in float64
TR_BETAS = dict(beta1=0.9, beta2=0.98, epsilon=1e-9)
TR_SERVE_BATCHES = (1, TR_B)
TR_SERVE_REQUESTS = 20
TR_DIR = os.path.join(ROOT, "build", "static_transformer")


def wmt_batch(cfg, seed, b=TR_B, src_len=TR_SRC, tgt_len=TR_TGT,
              min_len=TR_MIN_SRC):
    """One batch by `dataset.wmt14`'s law (int64, numpy, as a user feeds
    it): each source row <s> + words + <e> of a length drawn in
    [min_len, src_len], padded through ``src_pad_mask``; the target the
    reversed source words offset by 7 in the vocabulary, <s> first, the
    labels the target shifted by one with <e>, both cut or padded with
    <e> to ``tgt_len``."""
    rng = np.random.RandomState(seed)
    v = cfg.tgt_vocab_size
    out = {n: np.zeros((b, src_len if n.startswith("src") else tgt_len),
                       np.int64)
           for n in ("src_ids", "src_pos", "tgt_ids", "tgt_pos",
                     "src_pad_mask", "labels")}
    for r in range(b):
        n = int(rng.randint(min_len, src_len + 1))
        words = rng.randint(3, cfg.src_vocab_size, n - 2)
        trg = [3 + (w - 3 + 7) % (v - 3) for w in words[::-1]]
        out["src_ids"][r, :n] = [0] + list(words) + [1]
        out["src_pad_mask"][r, :n] = 1
        out["tgt_ids"][r] = ([0] + trg + [1] * tgt_len)[:tgt_len]
        out["labels"][r] = (trg + [1] * tgt_len)[:tgt_len]
    out["src_pos"][:] = np.arange(src_len)
    out["tgt_pos"][:] = np.arange(tgt_len)
    return out


def transformer_train_program(ptt, dropout, warmup=TR_NOAM_WARMUP):
    """(cfg, main, startup, loss, logits, lr): `models.transformer_program`
    at Transformer-base with ``dropout`` and Adam on noam_decay(512,
    ``warmup``), label smoothing 0.1; the startup program seeded."""
    models, fluid = ptt.models, ptt.fluid
    cfg = models.TransformerConfig(dropout=dropout)
    main, startup, _, loss, logits = models.transformer_program(
        cfg, TR_SRC, TR_TGT, label_smooth_eps=0.1,
        optimizer=lambda: ptt.optimizer.AdamOptimizer(
            fluid.layers.noam_decay(cfg.d_model, warmup, 1.0), **TR_BETAS))
    startup.random_seed = TR_SEED
    lr = next(main.global_block.var(o.output("Out")[0])
              for o in main.global_block.ops if o.type == "lr_schedule")
    return cfg, main, startup, loss, logits, lr


def noam64(step, d_model=512, warmup=TR_NOAM_WARMUP):
    return d_model ** -0.5 * min(step ** -0.5, step * warmup ** -1.5)


def transformer_attention_shapes(ops, cfg, b=TR_B, dtype=torch.float32):
    """[(tag, Sq, Sk, causal, fused backward?, launches a step)] of the
    path's three attention kinds, with the backward
    `ops.attention._use_fused_bwd` picks for each (``dtype``, D = 64)."""
    h, d = cfg.n_head, cfg.d_model // cfg.n_head
    sms = ops.attention._sm_count(torch.device("cuda"))
    out = []
    for tag, sq, sk, causal, n in (
            ("encoder self", TR_SRC, TR_SRC, False, cfg.num_encoder_layers),
            ("decoder causal self", TR_TGT, TR_TGT, True,
             cfg.num_decoder_layers),
            ("cross", TR_TGT, TR_SRC, False, cfg.num_decoder_layers)):
        out.append((tag, sq, sk, causal, ops.attention._use_fused_bwd(
            b * h, sq, sk, d, sms, dtype), n))
    return out


def _transformer_launches(ops, shapes):
    """A training step's launches: kernel 1 once an attention, the
    backward each picks once, nothing else (the FFN is unfused)."""
    want = {name: 0 for name in ops.KERNEL_WRAPPERS}
    for *_, fused, n in shapes:
        want["flash_fwd"] += n
        for k in (("flash_bwd_fused",) if fused
                  else ("flash_bwd_dq", "flash_bwd_dkv")):
            want[k] += n
    return want


def key_bias_weights(main):
    """{cross-attention key bias: its key weight}.  Softmax is invariant
    to a shift common to every key, so a key bias's gradient is zero in
    exact arithmetic: its computed value is rounding noise on the scale
    of the key weight's gradient, the scale it is held to."""
    ops_ = main.global_block.ops
    tgt = next(i for i, o in enumerate(ops_) if o.type == "lookup_table"
               and o.input("Ids") == ["tgt_ids"])
    memory = next(o.output("Y")[0] for o in reversed(ops_[:tgt])
                  if o.type == "layer_norm")           # enc_ln's output
    kv = [(ops_[i + 1].input("Y")[0], o.input("Y")[0])
          for i, o in enumerate(ops_)
          if o.type == "mul" and o.input("X") == [memory]]
    return dict(kv[::2])        # each decoder layer's k, then v


def _adam_first_step64(g, lr):
    """The adam op's first update of a parameter (zero moments, beta
    powers beta1 and beta2) in float64."""
    b1, b2, eps = TR_BETAS["beta1"], TR_BETAS["beta2"], TR_BETAS["epsilon"]
    g = g.double()
    lr_t = lr * (1 - b2) ** 0.5 / (1 - b1)
    return -lr_t * (1 - b1) * g / (((1 - b2) * g * g).sqrt() + eps)


class _static_relu_decisions:
    """Record the decision (x > 0) of every static ``relu`` op in run
    order, or, given another run's, apply those (x times the mask: the
    gradient is relu's on that decision) and count the inputs that lie
    on the other side of 0 here.  A unit whose input lies within
    rounding of 0 takes one branch in one run and the other in the
    other, and moves every gradient below it by its whole share: over a
    step's 47M FFN units a few do, and the target position table's
    gradient moves by ~1e-3 of its scale whichever attention kind runs
    through the kernel (`tools/transformer_grad_probe.py`)."""

    def __init__(self, ptt, force=None):
        from paddle_tpu_torch.fluid.core.registry import get_op_def

        self.opdef = get_op_def("relu")
        self.force, self.masks, self.flips = force, [], 0

    def __enter__(self):
        self.real = self.opdef.lower
        it = iter(self.force or ())

        def lower(ctx, ins, attrs):
            x = ins["X"][0]
            if self.force is None:
                self.masks.append((x > 0).detach())
                return self.real(ctx, ins, attrs)
            mask = next(it)
            self.flips += int(((x > 0) != mask).sum().item())
            return {"Out": [x * mask.to(x.dtype)]}

        self.opdef.lower = lower
        return self

    def __exit__(self, *exc):
        self.opdef.lower = self.real
        return False


def transformer_vs_plain(ptt):
    """One dropout-0 step of the training program from one seeded
    startup through the kernels and, from a copy of the same state,
    through their plain versions on the card (autograd through the plain
    forwards), on the kernel run's relu decisions
    (`_static_relu_decisions`; the flips are counted).  Gates, each
    TR_REL: the loss of itself; each gradient of its scale (max |g|; a
    cross-attention key bias's of its key weight's gradient,
    `key_bias_weights`); each updated parameter of its scale beyond what
    Adam's first step makes of the two runs' own gradients (Adam moves
    an element by about lr whatever |g| is)."""
    fluid, ops = ptt.fluid, ptt.ops
    cfg, main, startup, loss, _, lr = transformer_train_program(ptt, 0.0)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable]
    params = [p.name for p in main.all_parameters()]
    plain_scope = _copy_scope(fluid, scope, names)
    feed = wmt_batch(cfg, 2)
    fetch = [loss.name, lr.name] + [n + "@GRAD" for n in params]
    with _static_relu_decisions(ptt) as rec:
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=False)
    ops.reset_launch_counts()
    p1, p2 = _plain_static(ops)
    with p1, p2, _static_relu_decisions(ptt, rec.masks) as forced:
        want = exe.run(main, feed=feed, fetch_list=fetch,
                       scope=plain_scope, return_numpy=False)
    if any(ops.launch_counts().values()):
        raise AssertionError("the plain step launched %s"
                             % ops.launch_counts())
    del rec
    loss_rel = abs(got[0].item() - want[0].item()) / abs(want[0].item())
    rate = want[1].item()
    grads = dict(zip(params, want[2:]))
    key_bias = key_bias_weights(main)
    worst_g, worst_p = (-1.0, ""), (-1.0, "")
    for n, g_k, g_p in zip(params, got[2:], want[2:]):
        g_scale = grads[key_bias.get(n, n)].abs().max().item()
        err = (g_k - g_p).abs().max().item()
        worst_g = max(worst_g, (err / g_scale if g_scale else err, n))
        a, b_ = scope.find_var(n), plain_scope.find_var(n)
        upd = _adam_first_step64(g_k, rate) - _adam_first_step64(g_p, rate)
        scale = b_.abs().max().item()
        err = ((a.double() - b_.double()) - upd).abs().max().item()
        worst_p = max(worst_p, (err / scale if scale else err, n))
    if not (loss_rel <= TR_REL and worst_g[0] <= TR_REL
            and worst_p[0] <= TR_REL and np.isfinite(got[0].item())):
        raise AssertionError(
            "transformer step vs plain: loss %g vs %g (rel %g), worst "
            "gradient %s at %g of its scale, worst parameter %s at %g of "
            "its scale beyond the gradients' Adam updates; limit %g" % (
                got[0].item(), want[0].item(), loss_rel, worst_g[1],
                worst_g[0], worst_p[1], worst_p[0], TR_REL))
    return {"loss": got[0].item(), "plain_loss": want[0].item(),
            "loss_rel_err": loss_rel, "max_grad_rel_err": worst_g[0],
            "worst_grad": worst_g[1], "max_param_rel_err": worst_p[0],
            "worst_param": worst_p[1], "key_biases": len(key_bias),
            "relu_units_flipped": forced.flips, "limit": TR_REL}


def transformer_learns(ptt):
    """The learning gate: the training program with noam_decay(512,
    TR_LEARN_WARMUP) (under the recipe's warmup of 4000 the rate at step
    40 is ~7e-6, too small to move the loss in a smoke run: a cut of
    the warmup only), dropout 0.1, TR_LEARN_STEPS steps on one repeated
    batch.  Gate: finite losses, the last five steps' mean under the
    first five's.  Returns the losses."""
    fluid = ptt.fluid
    cfg, main, startup, loss, _, _ = transformer_train_program(
        ptt, 0.1, warmup=TR_LEARN_WARMUP)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = wmt_batch(cfg, 3)
    outs = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)[0] for _ in range(TR_LEARN_STEPS)]
    losses = [o.item() for o in outs]
    if not (np.isfinite(losses).all()
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise AssertionError("transformer learning gate losses: %s"
                             % losses)
    return losses


def transformer_flash_rows(ops, calls, shapes, bias_grad=True):
    """Kernels 1 and 4 (or 2 + 3, as the dispatch picks) on the arguments
    the training path gave kernel 1, the first call of each of the three
    attention kinds, with a seeded output gradient: errors against the
    plain versions (TOL and GRAD_TOL of the arguments' dtype), then each
    timed by events and `queued_ms` beside its plain version, SDPA's
    forward or backward (the library) and its bound (the visible (query,
    key) pairs: the causal triangle; bias and, with ``bias_grad`` (a
    path whose bias takes a gradient), dbias read and written once)."""
    gen = torch.Generator(device="cuda").manual_seed(TR_SEED)
    rows, seen = [], set()
    kinds = {(sq, sk, causal): (tag, fused)
             for tag, sq, sk, causal, fused, _ in shapes}
    per_step = {(sq, sk, causal): n for _, sq, sk, causal, _, n in shapes}
    for q, k, v, kw in calls:
        q, k, v = (t.detach() for t in (q, k, v))
        b, sq, h, d = q.shape
        sk = k.shape[1]
        key = (sq, sk, kw["causal"])
        if key in seen:
            continue
        seen.add(key)
        tag, fused = kinds[key]
        dt = q.dtype
        bias = kw.get("bias")
        bias = bias.detach() if bias is not None else None
        scale, layout, causal = kw["scale"], kw["layout"], kw["causal"]
        o, lse = ops.flash_fwd(q, k, v, bias, None, scale, causal, layout,
                               with_lse=True)
        do = torch.randn(o.shape, device="cuda", generator=gen).to(dt)
        qf, kf, vf, of, dof = upcast(q, k, v, o, do)
        o_ref, _ = ops.flash_attention_reference(qf, kf, vf, bias, None,
                                                 scale, causal, layout)
        grad_bias = bias is not None and bias_grad
        got = ops.flash_attention_bwd(q, k, v, o, do, lse, bias, None, scale,
                                      causal, layout, bias_grad=grad_bias)
        want = ops.flash_attention_bwd_reference(qf, kf, vf, bias, None, of,
                                                 dof, lse, scale, causal,
                                                 layout)
        torch.cuda.synchronize()
        name = str(dt).replace("torch.", "")
        errs = {"o": compare("transformer %s %s flash o" % (tag, name), o,
                             o_ref, TOL[dt])[0]}
        for t, g_, w_ in zip(("dq", "dk", "dv", "dbias"), got, want):
            if g_ is not None:
                errs[t] = compare("transformer %s %s flash %s" % (
                    tag, name, t), g_, w_, GRAD_TOL[dt])[0]
        lib_fwd, lib_bwd, _ = _library_attention(q, k, v, do, bias, None,
                                                 causal, scale)
        elt = q.element_size()
        xq, xk = b * sq * h * d * elt, b * sk * h * d * elt
        row = b * h * sq * 4
        mask = b * sk * 4 if bias is not None else 0
        dbias = b * h * sk * 4 if grad_bias else 0
        pairs = b * h * _visible_pairs(sq, sk, causal) * d
        common = {"shape": tag, "dtype": name, "B": b, "Sq": sq, "Sk": sk,
                  "H": h, "D": d, "causal": causal,
                  "bias": list(bias.shape) if bias is not None else None,
                  "per_step": per_step[key]}

        def fwd():
            return ops.flash_fwd(q, k, v, bias, None, scale, causal, layout,
                                 with_lse=True)

        def bwd():
            return ops.flash_attention_bwd(q, k, v, o, do, lse, bias, None,
                                           scale, causal, layout,
                                           bias_grad=grad_bias)
        rows.append(dict(
            common, kernel="flash_fwd", max_abs_err=errs["o"],
            ms=time_ms(fwd), queued_ms=queued_ms(fwd),
            plain_ms=time_ms(lambda: ops.flash_attention_reference(
                q, k, v, bias, None, scale, causal, layout), iters=5,
                warmup=1),
            library_ms=lib_fwd,
            **dict(zip(("bound_ms", "bound_by"), bound(
                2 * xq + 2 * xk + row + mask, 4 * pairs, dt)))))
        rows.append(dict(
            common, kernel=("flash_bwd_fused" if fused
                            else "flash_bwd_dq+flash_bwd_dkv"),
            dbias=grad_bias, max_abs_err=max(
                e for t, e in errs.items() if t != "o"), errors=errs,
            ms=time_ms(bwd), queued_ms=queued_ms(bwd),
            plain_ms=time_ms(lambda: ops.flash_attention_bwd_reference(
                q, k, v, bias, None, o, do, lse, scale, causal, layout),
                iters=5, warmup=1),
            library_ms=lib_bwd,
            **dict(zip(("bound_ms", "bound_by"), bound(
                4 * xq + 4 * xk + row + mask + dbias, 10 * pairs, dt)))))
    if len(seen) != 3:
        raise AssertionError("transformer attention kinds seen: %s" % seen)
    return rows


def transformer_serve(ptt, main, logits, exe, scope):
    """The trained model's logits saved by `save_inference_model` and
    served by `create_predictor` as saved and with
    ``matmul_bias_act_fuse`` at B = 1 and TR_B.  Gates: a fused forward
    launches kernel 1 18 times and kernel 5 12 times (fc1 + relu of
    every layer) and no other kernel; fused = unfused within TOL f32.
    Then p50 a batch over TR_SERVE_REQUESTS and kernel 5 at its two fc1
    shapes (`mba_rows`)."""
    import shutil

    fluid, inference, ops = ptt.fluid, ptt.inference, ptt.ops
    cfg = ptt.models.TransformerConfig()
    feeds = ["src_ids", "src_pos", "tgt_ids", "tgt_pos", "src_pad_mask"]
    shutil.rmtree(TR_DIR, ignore_errors=True)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(TR_DIR, feeds, [logits], exe, main)
    disk = sum(os.path.getsize(os.path.join(TR_DIR, f))
               for f in os.listdir(TR_DIR))
    plain = inference.create_predictor(inference.AnalysisConfig(TR_DIR))
    fused = inference.create_predictor(inference.AnalysisConfig(TR_DIR))
    fluid.ir.apply_passes(fused._program, ["matmul_bias_act_fuse"])
    types = [o.type for o in fused._program.global_block.ops]
    n_att = cfg.num_encoder_layers + 2 * cfg.num_decoder_layers
    n_fc = cfg.num_encoder_layers + cfg.num_decoder_layers
    want = {k: 0 for k in ops.KERNEL_WRAPPERS}
    want.update(flash_fwd=n_att, matmul_bias_act=n_fc)
    if (types.count("flash_attention"), types.count("matmul_bias_act"),
            types.count("relu")) != (n_att, n_fc, 0):
        raise AssertionError("served transformer after the pass: %s"
                             % sorted(set(types)))
    feeds_b = {b: {n: v[:b] for n, v in wmt_batch(cfg, 9).items()
                   if n != "labels"} for b in TR_SERVE_BATCHES}
    launches, errs, calls = {}, {}, []
    for b, f in feeds_b.items():
        ops.reset_launch_counts()
        got, = fused.run(f)
        launches[b] = ops.launch_counts()
        _expect_launches("transformer served forward B=%d" % b, launches[b],
                         want)
        ref, = plain.run(f)
        if got.shape != (b, TR_TGT, cfg.tgt_vocab_size) or \
                not np.isfinite(got).all():
            raise AssertionError("served logits at B=%d: %s"
                                 % (b, got.shape))
        errs[b] = compare("transformer served B=%d fused vs unfused" % b,
                          torch.from_numpy(got), torch.from_numpy(ref),
                          TOL[torch.float32])
        calls += _recorded_calls(ops, lambda: fused.run_async(f))["mba"]
    rows = mba_rows(ops, calls, "transformer")
    shapes = sorted({(r["M"], r["K"], r["N"], r["act"]) for r in rows})
    want_shapes = sorted({(b * s, cfg.d_model, cfg.d_inner, "relu")
                          for b in TR_SERVE_BATCHES
                          for s in (TR_SRC, TR_TGT)})
    if shapes != want_shapes:
        raise AssertionError("transformer kernel 5 shapes %s, want %s"
                             % (shapes, want_shapes))
    latency = {}
    for b, f in feeds_b.items():
        for _ in range(2):
            fused.run(f)
        ts, ts_dev = [], []
        for _ in range(TR_SERVE_REQUESTS):
            t = time.perf_counter()
            fused.run(f)
            ts.append((time.perf_counter() - t) * 1e3)
        for _ in range(TR_SERVE_REQUESTS):
            t = time.perf_counter()
            fused.run_async(f)
            torch.cuda.synchronize()
            ts_dev.append((time.perf_counter() - t) * 1e3)
        latency[b] = {"p50_ms": float(np.percentile(ts, 50)),
                      "p90_ms": float(np.percentile(ts, 90)),
                      "min_ms": min(ts),
                      "target_tokens_per_s": b * TR_TGT / (
                          float(np.percentile(ts, 50)) / 1e3),
                      # the logits left on the card: the forward without
                      # the copy of [b, 120, 32000] f32 to the host
                      "run_async_p50_ms": float(np.percentile(ts_dev, 50))}
    ops.reset_launch_counts()
    for f in feeds_b.values():
        fused.run(f)
    run_launches = ops.launch_counts()
    prof = device_profile(lambda: fused.run(feeds_b[TR_B]))
    del plain, fused
    shutil.rmtree(TR_DIR, ignore_errors=True)
    return {"saved_bytes": disk, "ops": len(types),
            "launches_per_forward": launches,
            "fused_vs_unfused": {b: {"max_abs_err": e[0], "limit_share": e[1]}
                                 for b, e in errs.items()},
            "latency": latency, "kernel_rows": rows,
            "run_launches": run_launches,
            "profile_B%d" % TR_B: {k: prof.get(k) for k in (
                "profiled_wall_ms", "device_busy_ms", "device_idle_share",
                "by_category_ms")}}


def static_transformer(ptt):
    """The WMT Transformer-base (d_model 512, 8 heads, 6 + 6 layers, FFN
    2048, vocabularies 32000, nothing cut) as a static program
    (`models.transformer_program`), trained through the Executor on the
    card by the paper's recipe (Adam(0.9, 0.98, 1e-9) on
    noam_decay(512, 4000), label smoothing 0.1, dropout 0.1) at B = 32
    pairs of 128 source (lengths 64-128, padded) and 120 target tokens,
    f32, TF32 off, startup seeded 47; two seeded batches alternate over
    TR_WARMUP + TR_STEPS steps.  Gates: each step launches kernel 1 18
    times (6 encoder self, 6 decoder causal self, 6 cross attentions)
    and the backward the dispatch picks for each kind 6 times, none of
    kernels 5-11; finite losses; after the run the step counter equals
    the steps taken and the fetched rate noam's float64 value within
    TR_LR_REL; one dropout-0 step against the plain versions
    (`transformer_vs_plain`); the learning gate (`transformer_learns`);
    kernels 1 and 4 (or 2 + 3) at the three attention shapes
    (`transformer_flash_rows`); the trained logits served with
    ``matmul_bias_act_fuse`` (`transformer_serve`); every op of this
    slice and its gradient card against CPU (`op_sweep` over
    `tests/test_torch_static_tensor.py`'s TENSOR).  Then p50 / p99 a
    step (CUDA events), target tokens/s, TFLOP/s from the counted FLOPs
    of a step (`observability.cost.FlopCounter`), peak memory, a
    profiled step."""
    import contextlib
    import io as _io

    from paddle_tpu_torch.observability.cost import FlopCounter

    fluid, ops = ptt.fluid, ptt.ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, main, startup, loss, logits, lr = transformer_train_program(ptt, 0.1)
    t1 = time.perf_counter()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    types = [o.type for o in main.global_block.ops]
    shapes = transformer_attention_shapes(ops, cfg)
    want = _transformer_launches(ops, shapes)
    feeds = [wmt_batch(cfg, seed) for seed in (0, 1)]
    steps_taken = [0]

    def step(i):
        out = exe.run(main, feed=feeds[i % 2], fetch_list=[loss, lr],
                      scope=scope, return_numpy=False)
        steps_taken[0] += 1
        return out

    losses, per_step = [], []
    for i in range(TR_WARMUP):
        ops.reset_launch_counts()
        losses.append(step(i)[0].item())
        per_step.append(ops.launch_counts())
        _expect_launches("transformer step %d" % i, per_step[-1], want)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(TR_STEPS + 1)]
    outs = []
    t3 = time.perf_counter()
    evs[0].record()
    for n in range(TR_STEPS):
        outs.append(step(TR_WARMUP + n))
        evs[n + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t3
    run_launches = ops.launch_counts()
    _expect_launches("transformer run", run_launches,
                     {k: v * TR_STEPS for k, v in want.items()})
    peak = torch.cuda.max_memory_allocated()
    ms = [evs[n].elapsed_time(evs[n + 1]) for n in range(TR_STEPS)]
    losses += [o[0].item() for o in outs]
    if not np.isfinite(losses).all():
        raise AssertionError("transformer losses: %s" % losses)

    # the arguments kernel 1 got on the path, a counted and a profiled step
    calls = _recorded_calls(ops, lambda: step(0))
    with FlopCounter() as counter:
        step(1)
    prof = device_profile(lambda: step(0))
    rate = step(1)[1].item()
    counter_after = scope.find_var("@LR_DECAY_COUNTER@").item()
    lr_want = noam64(counter_after, cfg.d_model)
    lr_rel = abs(rate - lr_want) / lr_want
    if counter_after != steps_taken[0] or lr_rel > TR_LR_REL:
        raise AssertionError(
            "transformer counter %g after %d steps, rate %g vs noam %g "
            "(rel %g)" % (counter_after, steps_taken[0], rate, lr_want,
                          lr_rel))
    flash_rows = transformer_flash_rows(ops, calls["flash"], shapes)
    del calls
    serve = transformer_serve(ptt, main, logits, exe, scope)
    del scope, exe
    vs_plain = transformer_vs_plain(ptt)
    learn = transformer_learns(ptt)
    t4 = time.perf_counter()
    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.append(os.path.join(ROOT, "tests"))
    from test_torch_static_tensor import TENSOR

    with contextlib.redirect_stdout(_io.StringIO()):     # the print op's
        sweep = op_sweep(ptt, TENSOR)
    sweep_s = time.perf_counter() - t4

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    p50 = float(np.percentile(ms, 50))
    flops = counter.flops
    emit({"phase": "static_transformer", "nvidia_smi": smi,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "config": dict(d_model=cfg.d_model, n_head=cfg.n_head,
                         encoder_layers=cfg.num_encoder_layers,
                         decoder_layers=cfg.num_decoder_layers,
                         d_inner=cfg.d_inner, vocab=cfg.tgt_vocab_size,
                         B=TR_B, src_len=TR_SRC, tgt_len=TR_TGT,
                         src_lengths="[%d, %d]" % (TR_MIN_SRC, TR_SRC),
                         dtype="float32", dropout=0.1, label_smoothing=0.1,
                         optimizer="Adam(0.9, 0.98, 1e-9) on noam_decay("
                                   "512, %d)" % TR_NOAM_WARMUP,
                         startup_seed=TR_SEED),
          "flash_backward": {tag: "fused (kernel 4)" if fused
                             else "pair (kernels 2 and 3)"
                             for tag, _, _, _, fused, _ in shapes},
          "build_s": t1 - t0, "startup_s": t2 - t1,
          "ops_per_step": len(types),
          "op_types": {t: types.count(t) for t in sorted(set(types))},
          "parameters": len(main.all_parameters()),
          "launches_per_step": per_step[-1], "run_launches": run_launches,
          "steps": TR_STEPS, "losses": losses, "step_ms": ms, "p50_ms": p50,
          "p99_ms": float(np.percentile(ms, 99)), "wall_s": wall,
          "target_tokens_per_s": TR_B * TR_TGT * TR_STEPS / (sum(ms) / 1e3),
          "counted_flops_per_step": flops,
          "model_tflops_at_p50": flops / p50 / 1e9,
          "peak_memory_gb": peak / 1e9,
          "counter": {"steps_taken": steps_taken[0],
                      "counter": counter_after, "rate": rate,
                      "noam_float64": lr_want, "rel_err": lr_rel},
          "vs_plain": vs_plain,
          "learning_gate": {"losses": learn, "noam_warmup": TR_LEARN_WARMUP,
                            "note": "the warmup is a cut: under 4000 the "
                                    "rate at step 40 is ~7e-6"},
          "kernel_rows": flash_rows,
          "serve": {k: v for k, v in serve.items() if k != "run_launches"},
          "op_sweep": sweep, "op_sweep_limit": SWEEP_REL,
          "op_sweep_s": sweep_s, "profile": prof})
    return {"per_step": per_step[-1], "run_launches": run_launches,
            "steps": TR_STEPS, "flash_rows": flash_rows,
            "serve_per_forward": serve["launches_per_forward"][TR_B],
            "serve_run_launches": serve["run_launches"],
            "mba_rows": serve["kernel_rows"]}


# ---------------------------------------------------------------------------
# the WMT Transformer-base, eager (`models.Transformer`): trained by the
# reference's own eager recipe in f32 and under ShardedTrainStep in bf16,
# and served, through kernels 1 and 4 (or 2 and 3); the repaired index
# ops at bad ids on the card
# ---------------------------------------------------------------------------

ETR_CFG = {}                   # TransformerConfig's defaults: nothing cut
ETR_SEED = 53                  # init_transformer_params
ETR_REL_LOSS = 1e-6            # kernels vs plain, f32: the loss
ETR_REL = 1e-5                 # ... gradients, parameters, of their scale
ETR_STATIC_LOGITS = 1e-5       # eager vs static: logits of their scale
ETR_BF16_FWD, ETR_BF16_GRAD = 2e-2, 5e-2    # the port's bf16 policy
ETR_LEARN_WARMUP, ETR_LEARN_STEPS = 10, 20  # the learning gate's cut
ETR_BF16_STEPS, ETR_BF16_LR = 10, 1e-4


def index_ops_on_card(ptt):
    """The repaired index ops at negative and out-of-range ids on the
    card against the CPU (`tests/test_torch_index_ops.py`'s BAD_IDS,
    forward and ``vjp_grad``, NaN where the CPU's is NaN), and the eager
    embedding's row take at bad ids, forward and gradient; then a
    synchronize, so a device-side assert would fail here."""
    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.append(os.path.join(ROOT, "tests"))
    from test_torch_index_ops import BAD_IDS

    sweep = op_sweep(ptt, BAD_IDS)
    ids = torch.tensor([[-1, 3, 32000], [-32001, 0, 40000]])
    got = {}
    for dev in ("cuda", "cpu"):
        w = torch.arange(32000 * 4, dtype=torch.float32, device=dev).reshape(
            32000, 4).requires_grad_()
        out = ptt.ops.nn_ops.take(w, ids.to(dev), 0)
        out.nan_to_num(0.0).sum().backward()
        got[dev] = (out.detach().cpu(), w.grad.cpu())
    torch.cuda.synchronize()
    if not (_sweep_rel(got["cuda"][0], got["cpu"][0]) == 0.0
            and torch.equal(got["cuda"][1], got["cpu"][1])
            and got["cpu"][0][0, 2].isnan().all()
            and got["cpu"][1].sum().item() == 3 * 4):
        raise AssertionError("the embedding's row take at bad ids: card %s, "
                             "CPU %s" % (got["cuda"][0], got["cpu"][0]))
    return {"ops": sweep, "embedding_take": "card = CPU, NaN rows, no "
            "gradient to bad ids"}


def eager_transformer_model(ptt, dropout, seed=ETR_SEED):
    cfg = ptt.models.TransformerConfig(**ETR_CFG, dropout=dropout)
    model = ptt.models.Transformer(cfg, device="cuda")
    model.load_state_dict(ptt.models.from_jax_state_dict(
        ptt.models.init_transformer_params(cfg, seed)))
    return cfg, model


def eager_feeds(cfg, seed, b=TR_B):
    """`wmt_batch`'s batch as tensors on the card: (the five model
    inputs, labels)."""
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in wmt_batch(cfg, seed, b).items()}
    return ([batch[k] for k in ("src_ids", "src_pos", "tgt_ids", "tgt_pos",
                                "src_pad_mask")], batch["labels"])


def eager_noam_adam(ptt, warmup=TR_NOAM_WARMUP):
    """The paper's Adam(0.9, 0.98, 1e-9) on NoamDecay(512, warmup):
    (optimizer, schedule)."""
    sched = ptt.learning_rate_scheduler.NoamDecay(512, warmup)
    return ptt.optimizer.AdamOptimizer(sched, **TR_BETAS), sched


def eager_step(model, opt, feeds, labels, params=None):
    """The reference's eager recipe: the loss, ``backward``, ``minimize``
    over the model's parameters, the gradients cleared.  Returns the
    loss (a tensor on the card)."""
    loss = model.loss(model(*feeds), labels, 0.1)
    loss.backward()
    opt.minimize(loss, parameter_list=params or list(model.parameters()))
    model.zero_grad(set_to_none=True)
    return loss


def _eager_sdpa(ptt, fn):
    """A patch of the attention the eager blocks call."""
    return patch.object(ptt.models.bert, "scaled_dot_product_attention", fn)


def _recorded_eager_flash(ptt, run):
    """The arguments kernel 1 gets from the eager blocks in one call of
    ``run``, each call still launching it."""
    calls, real = [], ptt.models.bert.scaled_dot_product_attention

    def rec(q, k, v, **kw):
        calls.append((q, k, v, kw))
        return real(q, k, v, **kw)

    with _eager_sdpa(ptt, rec):
        run()
    return calls


def _key_bias_scales(grads):
    """{name: the gradient scale a tensor is held to}: its own max |g|,
    but a cross attention's k_proj bias (exact gradient 0: softmax is
    shift-invariant) its k_proj weight's."""
    out = {}
    for n, g in grads.items():
        ref = n.replace("k_proj.bias", "k_proj.weight") \
            if n.endswith("cross_attn.k_proj.bias") else n
        out[n] = grads[ref].abs().max().item()
    return out


def eager_transformer_vs_plain(ptt):
    """One dropout-0 f32 step of the eager recipe through the kernels
    and, from the same weights, through their plain versions on the card
    (autograd through the plain attention), on the kernel run's relu
    decisions (`_relu_decisions`).  Gates: the loss within ETR_REL_LOSS
    of itself; each gradient within ETR_REL of its scale
    (`_key_bias_scales`); each new parameter within ETR_REL of its scale
    beyond what Adam's first step makes of the two runs' own
    gradients."""
    runs, relus = {}, _relu_decisions()
    for tag in ("kernel", "plain"):
        cfg, model = eager_transformer_model(ptt, 0.0)
        opt, sched = eager_noam_adam(ptt)
        feeds, labels = eager_feeds(cfg, 2)
        params = dict(model.named_parameters())
        sdpa = (ptt.models.bert.scaled_dot_product_attention
                if tag == "kernel" else plain_sdpa(ptt.ops))
        dec = relus if tag == "kernel" else _relu_decisions(force=relus.masks)
        with _eager_sdpa(ptt, sdpa), dec:
            loss = model.loss(model(*feeds), labels, 0.1)
            loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in params.items()}
        opt.minimize(loss, parameter_list=list(params.values()))
        runs[tag] = (loss.item(), grads,
                     {n: p.detach() for n, p in params.items()},
                     sched.get_lr())
        del model, opt
    (lk, gk, pk, rate), (lp, gp, pp, _) = runs["kernel"], runs["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    scales = _key_bias_scales(gp)
    worst_g, worst_p = (-1.0, ""), (-1.0, "")
    for n in gk:
        err = (gk[n] - gp[n]).abs().max().item()
        worst_g = max(worst_g, (err / scales[n] if scales[n] else err, n))
        upd = _adam_first_step64(gk[n], rate) - _adam_first_step64(gp[n],
                                                                    rate)
        scale = pp[n].abs().max().item()
        err = ((pk[n].double() - pp[n].double()) - upd).abs().max().item()
        worst_p = max(worst_p, (err / scale if scale else err, n))
    out = {"loss": lk, "plain_loss": lp, "loss_rel_err": loss_rel,
           "max_grad_rel_err": worst_g[0], "worst_grad": worst_g[1],
           "max_param_rel_err": worst_p[0], "worst_param": worst_p[1],
           "rate": rate, "relu_units": sum(m.numel() for m in relus.masks),
           "limits": {"loss": ETR_REL_LOSS, "grads_params": ETR_REL}}
    if not (loss_rel <= ETR_REL_LOSS and worst_g[0] <= ETR_REL
            and worst_p[0] <= ETR_REL and np.isfinite(lk)):
        raise AssertionError("eager transformer step vs plain: %s" % out)
    return out


def eager_vs_static(ptt):
    """The eager model's forward and loss against the static
    `transformer_program` at dropout 0 from the same weights, mapped in
    the reference's creation order (`models.program_params_from_eager`,
    which checks every shape), on the same batch.  Gates: the loss
    within ETR_REL_LOSS of the static one, the logits within
    ETR_STATIC_LOGITS of their scale."""
    fluid, models = ptt.fluid, ptt.models
    cfg, model = eager_transformer_model(ptt, 0.0)
    model.eval()
    main, startup, _, loss, logits = models.transformer_program(
        cfg, TR_SRC, TR_TGT, label_smooth_eps=0.1)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    mapped = models.program_params_from_eager(model, main)
    for name, t in mapped.items():
        scope.set(name, t)
    batch = wmt_batch(cfg, 4)
    want_logits, want_loss = exe.run(main, feed=batch,
                                     fetch_list=[logits, loss], scope=scope,
                                     return_numpy=False)
    feeds, labels = eager_feeds(cfg, 4)
    with torch.no_grad():
        got = model(*feeds)
        got_loss = model.loss(got, labels, 0.1)
    loss_rel = abs(got_loss.item() - want_loss.item()) / abs(
        want_loss.item())
    logits_rel = ((got - want_logits).abs().max()
                  / want_logits.abs().max()).item()
    out = {"parameters_mapped": len(mapped), "loss": got_loss.item(),
           "static_loss": want_loss.item(), "loss_rel_err": loss_rel,
           "logits_rel_err": logits_rel,
           "limits": {"loss": ETR_REL_LOSS, "logits": ETR_STATIC_LOGITS}}
    if not (loss_rel <= ETR_REL_LOSS and logits_rel <= ETR_STATIC_LOGITS):
        raise AssertionError("eager vs static transformer: %s" % out)
    return out


def eager_learns(ptt):
    """The learning gate: the f32 eager recipe under NoamDecay(512,
    ETR_LEARN_WARMUP) (a cut of the warmup only, as the static phase's),
    dropout 0.1, ETR_LEARN_STEPS steps on one repeated batch: finite
    losses, the last five's mean under the first five's."""
    cfg, model = eager_transformer_model(ptt, 0.1)
    opt, _ = eager_noam_adam(ptt, ETR_LEARN_WARMUP)
    feeds, labels = eager_feeds(cfg, 3)
    params = list(model.parameters())
    losses = [eager_step(model, opt, feeds, labels, params)
              for _ in range(ETR_LEARN_STEPS)]
    losses = [x.item() for x in losses]
    if not (np.isfinite(losses).all()
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise AssertionError("eager transformer learning gate: %s" % losses)
    return losses


def _bf16_grads(ptt, step, state, batch, tag, relus, amp="bf16"):
    """One `ShardedTrainStep` pass (loss, f32 gradients) from ``state``
    on ``batch``, dropout drawn from one seed, through the kernels
    ("kernel"), their plain versions ("plain", `plain_flash`) or autograd
    over the plain forward ("autograd", `plain_sdpa`), under ``relus``,
    with ``amp`` ("bf16", or None for f32).  A pass that is not
    "kernel" must launch no kernel."""
    ops = ptt.ops
    masters = {k: v.detach().requires_grad_()
               for k, v in state["params"].items()}
    old, step.amp = step.amp, amp
    try:
        with contextlib.ExitStack() as stack:
            if tag == "plain":
                for p_ in plain_flash(ops):
                    stack.enter_context(p_)
            elif tag == "autograd":
                stack.enter_context(_eager_sdpa(ptt, plain_sdpa(ops)))
            stack.enter_context(relus)
            ops.reset_launch_counts()
            loss, grads = step._losses_and_grads(
                masters, state["buffers"], batch, 7)
            if tag != "kernel" and any(ops.launch_counts().values()):
                raise AssertionError("the %s bf16 pass launched %s"
                                     % (tag, ops.launch_counts()))
    finally:
        step.amp = old
    return loss.item(), {n: g.float() for n, g in grads.items()}


def _grad_distances(a, b, scales):
    """{name: (max |a - b| / scale, ||a - b|| / ||b||)}, the second
    left out (None) for a cross attention's k_proj bias (exact gradient
    0, `_key_bias_scales`)."""
    out = {}
    for n in a:
        fro = None
        if not n.endswith("cross_attn.k_proj.bias"):
            fro = ((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-30)).item()
        out[n] = ((a[n] - b[n]).abs().max().item() / (scales[n] or 1.0),
                  fro)
    return out


def _bf16_step_vs_plain(ptt, step, state, batch):
    """The bf16 step from the initial weights through the kernels against
    its plain versions (`plain_flash`), on the kernel run's relu
    decisions.  Gate, the port's bf16 policy: the loss within
    ETR_BF16_FWD of itself, each gradient within ETR_BF16_GRAD of its
    scale (`_key_bias_scales`).  The numbers are emitted before the gate
    is applied."""
    relus = _relu_decisions()
    lk, gk = _bf16_grads(ptt, step, state, batch, "kernel", relus)
    lp, gp = _bf16_grads(ptt, step, state, batch, "plain",
                         _relu_decisions(force=relus.masks))
    errs = _grad_distances(gk, gp, _key_bias_scales(gp))
    worst = sorted(errs, key=lambda n: errs[n][0])[::-1][:5]
    out = {"state": "initial", "loss": lk, "plain_loss": lp,
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "worst_grads": [[n, *errs[n]] for n in worst],
           "limits": {"forward": ETR_BF16_FWD, "grads": ETR_BF16_GRAD}}
    emit({"phase": "eager_transformer_bf16_vs_plain", **out})
    if not (out["loss_rel_err"] <= ETR_BF16_FWD
            and errs[worst[0]][0] <= ETR_BF16_GRAD):
        raise AssertionError("eager transformer bf16 step vs plain: %s"
                             % out)
    return out


def eager_bf16(ptt):
    """Transformer-base under ``ShardedTrainStep(amp="bf16")`` with
    AdamW(ETR_BF16_LR), dropout 0.1, the two seeded batches alternating
    over ETR_BF16_STEPS steps.  Gates: each step launches bf16 kernel 1
    18 times and the backward the dispatch picks at bf16 for each kind 6
    times; finite losses, the last three's mean under the first three's;
    the first step's loss and f32 gradients through the kernels against
    the same through the kernels' plain versions (`_bf16_step_vs_plain`);
    after training, kernels 1 and 4 (or 2 + 3) on the arguments the step
    gives them against their plain versions (`transformer_flash_rows`,
    bf16 limits).  Returns (the phase's row, the launches a
    step, the kernel rows)."""
    ops = ptt.ops
    cfg, model = eager_transformer_model(ptt, 0.1)

    def loss_fn(m, batch):
        return m.loss(m(*[batch[k] for k in (
            "src_ids", "src_pos", "tgt_ids", "tgt_pos", "src_pad_mask")]),
            batch["labels"], 0.1)

    step = ptt.distributed.ShardedTrainStep(
        model, ptt.optimizer.AdamWOptimizer(ETR_BF16_LR), loss_fn,
        amp="bf16")
    shapes = transformer_attention_shapes(ops, cfg, dtype=torch.bfloat16)
    want = _transformer_launches(ops, shapes)
    batches = [step.place_batch(wmt_batch(cfg, seed)) for seed in (0, 1)]
    vs_plain = _bf16_step_vs_plain(ptt, step, step.init(), batches[0])
    state = step.init()
    losses, per_step = [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(ETR_BF16_STEPS + 1)]
    evs[0].record()
    for i in range(ETR_BF16_STEPS):
        ops.reset_launch_counts()
        state, loss = step(state, batches[i % 2])
        evs[i + 1].record()
        launches = ops.launch_counts()
        _expect_launches("eager transformer bf16 step %d" % i, launches,
                         want)
        per_step = launches
        losses.append(loss)
    torch.cuda.synchronize()
    ms = [evs[n].elapsed_time(evs[n + 1]) for n in range(ETR_BF16_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    if not (np.isfinite(losses).all()
            and np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError("eager transformer bf16 losses: %s" % losses)
    calls = _recorded_eager_flash(ptt, lambda: step._losses_and_grads(
        {k: v.detach().requires_grad_() for k, v in state["params"].items()},
        state["buffers"], batches[0], 8))
    rows = transformer_flash_rows(ops, calls, shapes, bias_grad=False)
    del calls
    row = {"optimizer": "AdamW(%g)" % ETR_BF16_LR, "steps": ETR_BF16_STEPS,
           "losses": losses, "step_ms": ms,
           "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)),
           "target_tokens_per_s": TR_B * TR_TGT * ETR_BF16_STEPS
           / (sum(ms) / 1e3), "peak_memory_gb": peak / 1e9,
           "flash_backward": {tag: "fused (kernel 4)" if fused
                              else "pair (kernels 2 and 3)"
                              for tag, _, _, _, fused, _ in shapes},
           "launches_per_step": per_step, "vs_plain": vs_plain}
    return row, per_step, rows


def eager_serve(ptt, model, cfg):
    """``model.eval()``, then ``encode`` + ``decode`` under
    `torch.no_grad()` at B = 1 and TR_B: each forward launches kernel 1
    18 times and nothing else; the logits against the same forward
    through the plain attention within ETR_STATIC_LOGITS of their scale;
    p50 over TR_SERVE_REQUESTS forwards with the logits left on the card
    (host clock around a forward ending in a synchronize)."""
    ops = ptt.ops
    model.eval()
    n_att = cfg.num_encoder_layers + 2 * cfg.num_decoder_layers
    want = {k: 0 for k in ops.KERNEL_WRAPPERS}
    want["flash_fwd"] = n_att
    out = {}
    for b in TR_SERVE_BATCHES:
        (src, spos, tgt, tpos, mask), _ = eager_feeds(cfg, 9, b)

        def fwd():
            with torch.no_grad():
                mem = model.encode(src, spos, mask)
                return model.decode(tgt, tpos, mem, mask)

        ops.reset_launch_counts()
        got = fwd()
        launches = ops.launch_counts()
        _expect_launches("eager transformer served B=%d" % b, launches, want)
        with _eager_sdpa(ptt, plain_sdpa(ops)):
            ref = fwd()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        if not (rel <= ETR_STATIC_LOGITS and torch.isfinite(got).all()
                and got.shape == (b, TR_TGT, cfg.tgt_vocab_size)):
            raise AssertionError("eager transformer served B=%d: logits "
                                 "%s, %g of their scale from plain"
                                 % (b, tuple(got.shape), rel))
        for _ in range(2):
            fwd()
        ts = []
        for _ in range(TR_SERVE_REQUESTS):
            t = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        out[b] = {"launches_per_forward": launches,
                  "vs_plain_rel_err": rel,
                  "p50_ms": float(np.percentile(ts, 50)),
                  "p90_ms": float(np.percentile(ts, 90)), "min_ms": min(ts),
                  "target_tokens_per_s": b * TR_TGT / (
                      float(np.percentile(ts, 50)) / 1e3)}
    return out


def eager_transformer(ptt):
    """The WMT Transformer-base as the eager `models.Transformer`
    (d_model 512, 8 heads, 6 + 6 layers, FFN 2048, vocabularies 32000,
    nothing cut; weights `init_transformer_params(cfg, ETR_SEED)`), at
    B = 32 pairs of `wmt_batch`'s (the static phase's batches: 128
    source tokens, lengths 64-128 padded, 120 target), TF32 off.  First
    the repaired index ops at bad ids on the card (`index_ops_on_card`).
    f32, the reference's own eager recipe (`eager_step`: Adam(0.9, 0.98,
    1e-9) on NoamDecay(512, 4000), label smoothing 0.1, dropout 0.1),
    TR_WARMUP + TR_STEPS steps, the two batches alternating.  Gates:
    each step launches kernel 1 18 times and the backward the dispatch
    picks for each of the three kinds 6 times, nothing else; finite
    losses; one dropout-0 step against the plain versions
    (`eager_transformer_vs_plain`); the eager forward against the static
    program (`eager_vs_static`); the learning gate (`eager_learns`);
    bf16 under ShardedTrainStep (`eager_bf16`); served (`eager_serve`);
    kernels 1 and 4 (or 2 + 3) at the three attention shapes in f32 and
    bf16 (`transformer_flash_rows`).  Then p50 / p99 a step (CUDA
    events), target tokens/s, TFLOP/s from the counted FLOPs of a step,
    peak memory, a profiled step."""
    from paddle_tpu_torch.observability.cost import FlopCounter

    ops = ptt.ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    index_ops = index_ops_on_card(ptt)
    t1 = time.perf_counter()
    cfg, model = eager_transformer_model(ptt, 0.1)
    opt, sched = eager_noam_adam(ptt)
    params = list(model.parameters())
    n_params = len(params)
    feeds = [eager_feeds(cfg, seed) for seed in (0, 1)]
    shapes = transformer_attention_shapes(ops, cfg)
    want = _transformer_launches(ops, shapes)
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    def step(i):
        return eager_step(model, opt, *feeds[i % 2], params)

    losses, per_step = [], None
    for i in range(TR_WARMUP):
        ops.reset_launch_counts()
        losses.append(step(i).item())
        per_step = ops.launch_counts()
        _expect_launches("eager transformer step %d" % i, per_step, want)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(TR_STEPS + 1)]
    outs = []
    t3 = time.perf_counter()
    evs[0].record()
    for n in range(TR_STEPS):
        outs.append(step(TR_WARMUP + n))
        evs[n + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t3
    run_launches = ops.launch_counts()
    _expect_launches("eager transformer run", run_launches,
                     {k: v * TR_STEPS for k, v in want.items()})
    peak = torch.cuda.max_memory_allocated()
    ms = [evs[n].elapsed_time(evs[n + 1]) for n in range(TR_STEPS)]
    losses += [o.item() for o in outs]
    if not np.isfinite(losses).all():
        raise AssertionError("eager transformer losses: %s" % losses)
    calls = _recorded_eager_flash(ptt, lambda: step(0))
    with FlopCounter() as counter:
        step(1)
    prof = device_profile(lambda: step(0))
    flash_rows = transformer_flash_rows(ops, calls, shapes, bias_grad=False)
    del calls
    serve = eager_serve(ptt, model, cfg)
    del model, opt, params, feeds
    vs_plain = eager_transformer_vs_plain(ptt)
    vs_static = eager_vs_static(ptt)
    learn = eager_learns(ptt)
    ops.reset_launch_counts()
    bf16, bf16_per_step, bf16_rows = eager_bf16(ptt)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    p50 = float(np.percentile(ms, 50))
    flops = counter.flops
    emit({"phase": "eager_transformer", "nvidia_smi": smi,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "config": dict(d_model=cfg.d_model, n_head=cfg.n_head,
                         encoder_layers=cfg.num_encoder_layers,
                         decoder_layers=cfg.num_decoder_layers,
                         d_inner=cfg.d_inner, vocab=cfg.tgt_vocab_size,
                         B=TR_B, src_len=TR_SRC, tgt_len=TR_TGT,
                         src_lengths="[%d, %d]" % (TR_MIN_SRC, TR_SRC),
                         dtype="float32", dropout=0.1, label_smoothing=0.1,
                         optimizer="Adam(0.9, 0.98, 1e-9) on NoamDecay("
                                   "512, %d), eager minimize"
                                   % TR_NOAM_WARMUP, weights_seed=ETR_SEED),
          "index_ops_on_card": index_ops,
          "flash_backward": {tag: "fused (kernel 4)" if fused
                             else "pair (kernels 2 and 3)"
                             for tag, _, _, _, fused, _ in shapes},
          "index_check_s": t1 - t0, "setup_s": t2 - t1,
          "parameters": n_params,
          "launches_per_step": per_step, "run_launches": run_launches,
          "steps": TR_STEPS, "losses": losses, "step_ms": ms, "p50_ms": p50,
          "p99_ms": float(np.percentile(ms, 99)), "wall_s": wall,
          "target_tokens_per_s": TR_B * TR_TGT * TR_STEPS / (sum(ms) / 1e3),
          "counted_flops_per_step": flops,
          "model_tflops_at_p50": flops / p50 / 1e9,
          "peak_memory_gb": peak / 1e9, "vs_plain": vs_plain,
          "vs_static": vs_static,
          "learning_gate": {"losses": learn,
                            "noam_warmup": ETR_LEARN_WARMUP},
          "bf16": bf16, "serve": serve, "kernel_rows": flash_rows,
          "bf16_kernel_rows": bf16_rows, "profile": prof})
    return {"per_step": per_step, "run_launches": run_launches,
            "steps": TR_STEPS, "flash_rows": flash_rows + bf16_rows,
            "bf16_per_step": bf16_per_step,
            "serve_per_forward": serve[TR_B]["launches_per_forward"]}


# ---------------------------------------------------------------------------
# the eager vision zoo: MobileNetV1 (its 13 pointwise layers through
# kernels 10 and 11), VGG-16-BN and LeNet-5 (no hand-written kernel)
# ---------------------------------------------------------------------------

MB_CLASSES, MB_HW, MB_SEED = 1000, 224, 59
MB_EVAL_B, MB_TRAIN_B = 64, 128
MB_PW = 13                    # pointwise 1x1 stride-1 layers a forward
MB_STEPS, MB_WARMUP = 10, 2
MB_EVAL_REL = 1e-5            # kernel 10 vs plain: logits of their scale
MB_CHECK_B, MB_CHECK_HW = 4, 64      # the f32 step vs plain (ResNet's)
VGG_B, VGG_HW, VGG_STEPS = 64, 224, 4
LENET_B, LENET_STEPS = 128, 6
ZOO_LR = 0.01


def _mobilenet(ptt, dt=torch.float32, seed=MB_SEED):
    model = ptt.models.MobileNetV1(num_classes=MB_CLASSES, device="cuda",
                                   dtype=dt)
    model.load_state_dict(ptt.models.from_jax_state_dict(
        ptt.models.init_mobilenet_params(MB_CLASSES, 1.0, seed,
                                         bn_stats="random")))
    return model


def _images(b, c, hw, seed, classes=MB_CLASSES):
    rng = np.random.RandomState(seed)
    return {"image": rng.standard_normal((b, c, hw, hw)).astype(np.float32),
            "label": rng.randint(0, classes, (b, 1)).astype(np.int32)}


def mobilenet_eval(ptt):
    """MobileNetV1 (scale 1, 1000 classes, 224) eval in f32 at B =
    MB_EVAL_B: each forward launches kernel 10 MB_PW times and nothing
    else; the logits against the same forward with kernel 10's plain
    version in its place within MB_EVAL_REL of their scale; p50 a batch
    (host clock around a forward ending in a synchronize)."""
    ops = ptt.ops
    model = _mobilenet(ptt).eval()
    x = torch.from_numpy(_images(MB_EVAL_B, 3, MB_HW, 1)["image"]).cuda()

    def fwd():
        with torch.no_grad():
            return model(x)

    ops.reset_launch_counts()
    got = fwd()
    launches = ops.launch_counts()
    _expect_launches("MobileNetV1 eval forward", launches,
                     {k: MB_PW if k == "conv_bn_relu" else 0
                      for k in ops.KERNEL_WRAPPERS})
    with patch.object(ops, "conv1x1_bn_relu", ops.conv1x1_bn_relu_reference):
        ref = fwd()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    if not (rel <= MB_EVAL_REL and torch.isfinite(got).all()):
        raise AssertionError("MobileNetV1 eval: %g of the logits' scale "
                             "from plain" % rel)
    for _ in range(2):
        fwd()
    ts = []
    for _ in range(10):
        t = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    p50 = float(np.percentile(ts, 50))
    return {"B": MB_EVAL_B, "dtype": "float32",
            "launches_per_forward": launches, "vs_plain_rel_err": rel,
            "p50_ms": p50, "images_per_s": MB_EVAL_B / p50 * 1e3}


def _mobilenet_step(ptt, model, amp=None, lr=0.1):
    return ptt.distributed.ShardedTrainStep(
        model, ptt.optimizer.MomentumOptimizer(lr, 0.9), resnet_loss_fn,
        amp=amp)


def mobilenet_train_check(ptt):
    """One f32 Momentum(0.01, 0.9) step of full-width MobileNetV1 (1000
    classes) at B = MB_CHECK_B, MB_CHECK_HW², through kernel 11 on the
    13 pointwise layers and, from the same weights, through its plain
    version on the card, on the kernel run's relu decisions: the ResNet
    step's gates (`resnet_train_model_check`): the loss within
    RESNET_CARD_VS_CPU of itself, every gradient (the step's first
    Velocity), new parameter and running statistic within
    RESNET_CARD_VS_CPU of its scale."""
    batch = _images(MB_CHECK_B, 3, MB_CHECK_HW, 7)
    runs, relus = {}, _relu_decisions()
    for tag, fn in (("kernel", ptt.ops.conv1x1_bn_stats),
                    ("plain", ptt.ops.conv1x1_bn_stats_reference)):
        step = _mobilenet_step(ptt, _mobilenet(ptt), lr=0.01)
        ptt.ops.reset_launch_counts()
        dec = relus if tag == "kernel" else _relu_decisions(force=relus.masks)
        with patch.object(ptt.ops, "conv1x1_bn_stats", fn), dec:
            state, loss = step(step.init(), batch)
        torch.cuda.synchronize()
        runs[tag] = (loss.item(), {
            "grads": {n: st["Velocity"] for n, st in state["opt"].items()},
            "params": state["params"], "running_stats": state["buffers"]},
            ptt.ops.launch_counts())
        del step, state
    _expect_launches("MobileNetV1 f32 step", runs["kernel"][2],
                     {"conv_bn_stats": MB_PW, "conv_bn_relu": 0})
    _expect_launches("MobileNetV1 f32 step, plain", runs["plain"][2],
                     {"conv_bn_stats": 0})
    out = {"B": MB_CHECK_B, "HW": MB_CHECK_HW, "loss": runs["kernel"][0],
           "plain_loss": runs["plain"][0], "limit": RESNET_CARD_VS_CPU}
    for kind in ("grads", "params", "running_stats"):
        out[kind] = _check_rel("MobileNetV1 step %s, kernel 11 vs plain"
                               % kind, _rel_errs(runs["kernel"][1][kind],
                                                 runs["plain"][1][kind]),
                               RESNET_CARD_VS_CPU)
    if not abs(runs["kernel"][0] - runs["plain"][0]) <= \
            RESNET_CARD_VS_CPU * abs(runs["plain"][0]):
        raise AssertionError("MobileNetV1 step loss: %s" % out)
    return out


def mobilenet_train(ptt):
    """MobileNetV1 trained as the ResNet step is (`resnet_train`):
    ShardedTrainStep(amp="bf16") + Momentum(0.1, 0.9) at B = MB_TRAIN_B,
    224, MB_WARMUP steps then MB_STEPS timed with CUDA events on one
    repeated batch.  Gates: kernel 11 launches MB_PW times a step and
    nothing else launches; finite losses, the last under the first; the
    running statistics move.  Returns (the phase's row, run
    launches)."""
    ops = ptt.ops
    step = _mobilenet_step(ptt, _mobilenet(ptt), amp="bf16")
    state = step.init()
    before = {k: v.clone() for k, v in state["buffers"].items()}
    batch = step.place_batch(_images(MB_TRAIN_B, 3, MB_HW, 0))
    state, warm, _ = _run_steps(step, state, [batch], [0] * MB_WARMUP)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, losses, ms = _run_steps(step, state, [batch], [0] * MB_STEPS)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _expect_launches("MobileNetV1 train run", launches,
                     {k: MB_PW * MB_STEPS if k == "conv_bn_stats" else 0
                      for k in ops.KERNEL_WRAPPERS})
    losses = warm + losses
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("MobileNetV1 bf16 losses: %s" % losses)
    moved = max((state["buffers"][k] - before[k]).abs().max().item()
                for k in before)
    if not moved > 0:
        raise AssertionError("MobileNetV1's running statistics never moved")
    p50 = float(np.percentile(ms, 50))
    return {"B": MB_TRAIN_B, "amp": "bf16", "optimizer": "Momentum(0.1, 0.9)",
            "losses": losses, "step_ms": ms, "p50_ms": p50,
            "p99_ms": float(np.percentile(ms, 99)),
            "images_per_s": MB_TRAIN_B / p50 * 1e3,
            "peak_memory_gb": peak / 1e9, "running_stats_max_move": moved,
            "launches_per_step": {k: v // MB_STEPS
                                  for k, v in launches.items()}}, launches


def mobilenet_conv_rows(ops):
    """Kernel 10 (f32, the eval path's dtype, B = MB_EVAL_B) and kernel
    11 (bf16, the train step's, B = MB_TRAIN_B) at MobileNetV1's
    narrowest pointwise shape (112², K = 32 -> N = 64, below any ResNet
    width) and its widest (7², 1024 -> 1024), each against its plain
    version and timed (`conv_bn_row`, `conv_stats_row`)."""
    gen = torch.Generator(device="cuda").manual_seed(MB_SEED)
    shapes = ((112, 32, 64), (7, 1024, 1024))
    rows = [dict(conv_bn_row(ops, gen, MB_EVAL_B, hw, k, n, torch.float32,
                             1), kernel="conv_bn_relu")
            for hw, k, n in shapes]
    rows += [dict(conv_stats_row(ops, gen, MB_TRAIN_B * hw * hw, k, n,
                                 torch.bfloat16, 1), kernel="conv_bn_stats")
             for hw, k, n in shapes]
    return rows


def zoo_train_and_serve(ptt, name, model, b, hw, c, classes, steps):
    """``steps`` f32 eager Momentum(ZOO_LR, 0.9) steps (the reference's
    recipe: ``backward``, ``minimize``, clear the gradients) on one
    repeated batch of B = ``b`` ``hw``² images of ``c`` channels
    (``classes`` labels), then eval twice on it.  Each Dropout draws
    from a generator of its own, seeded anew before every step: the same
    masks each step, so that the losses fall by the optimizer and not by
    the draw (VGG's two masks moved its loss by more than four steps do).
    Gates: finite losses, the last under the first; the two evals'
    logits equal (VGG's downgrade_in_infer dropout is deterministic);
    no hand-written kernel launches.  p50 a step (CUDA events)."""
    ops = ptt.ops
    model.load_state_dict(ptt.models.from_jax_state_dict(
        ptt.models.init_vision_params(model, MB_SEED)))
    data = _images(b, c, hw, 3, classes)
    x = torch.from_numpy(data["image"]).cuda()
    lab = torch.from_numpy(data["label"]).cuda()
    opt = ptt.optimizer.MomentumOptimizer(ZOO_LR, 0.9)
    params = list(model.parameters())
    drops = [m for m in model.modules()
             if isinstance(m, ptt.models.bert.Dropout)]
    for m in drops:
        m.generator = torch.Generator(device="cuda")
    model.train()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    evs[0].record()
    for i in range(steps):
        for j, m in enumerate(drops):
            m.generator.manual_seed(MB_SEED + j)
        loss = ptt.ops.nn_ops.softmax_with_cross_entropy(model(x),
                                                         lab).mean()
        loss.backward()
        opt.minimize(loss, parameter_list=params)
        model.zero_grad(set_to_none=True)
        losses.append(loss)
        evs[i + 1].record()
    torch.cuda.synchronize()
    ms = [evs[n].elapsed_time(evs[n + 1]) for n in range(steps)]
    losses = [x_.item() for x_ in losses]
    model.eval()
    with torch.no_grad():
        e1, e2 = model(x), model(x)
    launches = ops.launch_counts()
    _expect_launches("%s steps and evals" % name, launches,
                     {k: 0 for k in ops.KERNEL_WRAPPERS})
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and torch.equal(e1, e2) and torch.isfinite(e1).all()):
        raise AssertionError("%s: losses %s, evals equal %s"
                             % (name, losses, torch.equal(e1, e2)))
    return {"B": b, "HW": hw, "dtype": "float32",
            "optimizer": "Momentum(%g, 0.9), eager minimize" % ZOO_LR,
            "losses": losses, "step_ms": ms,
            "p50_ms": float(np.percentile(ms, 50)),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "evals_equal": True, "launches": launches}


def eager_vision(ptt):
    """The eager vision zoo on the card, f32 with TF32 off unless said:
    MobileNetV1 (scale 1, 1000 classes, 224, nothing cut; weights
    `init_mobilenet_params(..., bn_stats="random")`) served in f32
    (`mobilenet_eval`: 13 kernel-10 launches a forward) and trained in
    bf16 (`mobilenet_train`: 13 kernel-11 launches a step), its f32 step
    against kernel 11's plain version (`mobilenet_train_check`), kernels
    10 and 11 at its narrowest and widest pointwise shapes
    (`mobilenet_conv_rows`); VGG-16-BN (1000 classes, 224, B = VGG_B)
    and LeNet-5 (28², B = LENET_B) trained a few steps and served
    (`zoo_train_and_serve`), no hand-written kernel on their paths."""
    models = ptt.models
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ev = mobilenet_eval(ptt)
    check = mobilenet_train_check(ptt)
    train, run_launches = mobilenet_train(ptt)
    rows = mobilenet_conv_rows(ptt.ops)
    t1 = time.perf_counter()
    vgg = zoo_train_and_serve(ptt, "VGG-16-BN", models.vgg16(
        num_classes=MB_CLASSES, device="cuda"), VGG_B, VGG_HW, 3, MB_CLASSES,
        VGG_STEPS)
    lenet = zoo_train_and_serve(ptt, "LeNet-5", models.LeNet5(
        device="cuda"), LENET_B, 28, 1, 10, LENET_STEPS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "eager_vision", "nvidia_smi": smi,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "mobilenet": {"config": "MobileNetV1 scale 1.0, %d classes, "
                                  "%d²" % (MB_CLASSES, MB_HW),
                        "eval": ev, "train_check": check, "train": train,
                        "kernel_rows": rows, "seconds": t1 - t0},
          "vgg16_bn": vgg, "lenet5": lenet})
    return {"eval_per_forward": ev["launches_per_forward"],
            "train_per_step": train["launches_per_step"],
            "train_run_launches": run_launches, "steps": MB_STEPS,
            "rows": rows}


REDESIGNED_KERNELS = ("matmul_fwd_tc", "conv_bn_relu_tc", "conv_bn_stats_tc",
                      "decode_dense_kernel", "decode_paged_kernel",
                      "tf32x3")


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
          "bound_peak_tflops": {
              "float32 (3xTF32: 495 / 3)": BOUND_FLOPS[torch.float32] / 1e12,
              "bfloat16": BOUND_FLOPS[torch.bfloat16] / 1e12}})

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
    draft_decode_row, draft_flash_row = check_draft_kernels(ops)
    check_matmul(ops)
    mm_main = check_matmul_main_shape(ops)
    train_model_check(ptt)
    train_launches, pair_launches, ffn_launches = train(ptt)
    train_knobs_check(ptt)
    lamb_launches = train_lamb(ptt)
    launches = run_engine(ptt)
    conv_rows, resnet_launches, resnet_params = run_resnet(ptt)
    stats_rows, stats_main, train_launches11 = run_resnet_train(
        ptt, resnet_params)
    eager_launches = train_eager(ptt)
    static = static_serve(ptt)
    static_tr = static_train(ptt)
    book = static_book(ptt)
    embed = static_book_embed(ptt)
    tr = static_transformer(ptt)
    etr = eager_transformer(ptt)
    vis = eager_vision(ptt)

    prefill = next(r for r in flash_rows
                   if r["S"] == 1024 and r["dtype"] == "float32"
                   and not r["strided_qkv"])
    err, bounds = main["max_abs_err"], main["bounds"]
    src = "paddle_tpu_torch/ops/csrc/"
    pallas = "paddle_tpu/ops/pallas/attention.py:"

    def static_entry(name):
        """The kernel on the static-graph inference path: launches a
        forward and over the served requests, and its rows at the
        path's own shapes."""
        return {"launches_per_forward": static["per_forward"][name],
                "run_launches": static["run_launches"][name],
                "requests": static["requests"],
                "shapes": [r for r in static["kernel_rows"]
                           if r["kernel"] == name]}

    def static_train_entry(name):
        """The kernel on the static-graph training path: launches a step
        and over the timed steps, and its row at the path's shapes."""
        row = [r for r in static_tr["kernel_rows"]
               if name in r["kernel"].split("+")]
        return {"launches_per_step": static_tr["per_step"][name],
                "run_launches": static_tr["run_launches"][name],
                "steps": static_tr["steps"], "shapes": row}

    def static_book_entry(name):
        """The kernel on the Fluid book's programs (LeNet-5 trained and
        served, VGG-16-BN trained and served): launches over the phase,
        and kernel 5's rows at the served LeNet's shapes."""
        out = {"run_launches": book["run_launches"][name],
               "launches_per_served_lenet_forward": book["per_forward"][name]}
        if name == "matmul_bias_act":
            out["shapes"] = book["kernel_rows"]
        return out

    def embed_entry(name):
        """The kernel on the Fluid book's embedding programs (word2vec
        and the recommender trained and served): launches over the
        phase, a served recommender forward's, and kernel 5's rows at
        the recommender's tower shapes."""
        out = {"run_launches": embed["run_launches"][name],
               "launches_per_served_recommender_forward":
                   embed["per_forward"][name]}
        if name == "matmul_bias_act":
            out["shapes"] = embed["kernel_rows"]
        return out

    def transformer_entry(name):
        """The kernel on the static Transformer-base path: launches a
        training step and over the timed steps, a served forward's and
        over the served run, and its rows at the path's shapes."""
        out = {"launches_per_step": tr["per_step"][name],
               "run_launches": tr["run_launches"][name],
               "steps": tr["steps"],
               "launches_per_served_forward": tr["serve_per_forward"][name],
               "serve_run_launches": tr["serve_run_launches"][name]}
        rows = [r for r in tr["flash_rows"] + tr["mba_rows"]
                if name in r["kernel"].split("+")]
        if rows:
            out["shapes"] = rows
        return out

    def eager_transformer_entry(name):
        """The kernel on the eager Transformer-base path: launches an f32
        step and over the timed steps, a bf16 step's, a served forward's,
        and its rows at the path's shapes (f32 and bf16)."""
        out = {"launches_per_step": etr["per_step"][name],
               "run_launches": etr["run_launches"][name],
               "steps": etr["steps"],
               "bf16_launches_per_step": etr["bf16_per_step"][name],
               "launches_per_served_forward": etr["serve_per_forward"][name]}
        rows = [r for r in etr["flash_rows"]
                if name in r["kernel"].split("+")]
        if rows:
            out["shapes"] = rows
        return out

    def eager_vision_entry(name):
        """The kernel on the eager vision path: launches a MobileNetV1
        eval forward, a bf16 train step and over the timed steps, and
        its rows at MobileNetV1's narrowest and widest pointwise
        shapes."""
        out = {"launches_per_mobilenet_eval_forward":
                   vis["eval_per_forward"][name],
               "launches_per_mobilenet_train_step":
                   vis["train_per_step"][name],
               "mobilenet_train_run_launches":
                   vis["train_run_launches"][name],
               "steps": vis["steps"]}
        rows = [r for r in vis["rows"] if r["kernel"] == name]
        if rows:
            out["shapes"] = rows
        return out

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
                             "prefix_run_launches":
                                 launches["engine_prefix"]["flash_fwd"],
                             "int8_run_launches":
                                 launches["engine_int8"]["flash_fwd"],
                             "serving_fleet_run_launches":
                                 launches["serving_fleet"]["flash_fwd"],
                             "serving_kill_run_launches":
                                 launches["serving_kill"]["flash_fwd"],
                             "disagg_prefill_launches": [
                                 launches[k]["flash_fwd"] for k in (
                                     "disagg_prefill",
                                     "disagg_int8_prefill")],
                             "disagg_decode_launches": [
                                 launches[k]["flash_fwd"] for k in (
                                     "disagg_decode",
                                     "disagg_int8_decode")],
                             **{k: prefill[k] for k in (
                                 "S", "dtype", "max_abs_err", "ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}},
             draft_prefill=dict(draft_flash_row, speculative_run_launches=(
                 launches["engine_speculative"]["flash_fwd"])),
             train_lamb_run_launches=lamb_launches["flash_fwd"],
             static_serve=static_entry("flash_fwd"),
             static_train=static_train_entry("flash_fwd"),
             static_book=static_book_entry("flash_fwd"),
             static_book_embed=embed_entry("flash_fwd"),
             static_transformer=transformer_entry("flash_fwd"),
             eager_transformer=eager_transformer_entry("flash_fwd"),
             eager_vision=eager_vision_entry("flash_fwd")),
        dict(flash_entry("flash_bwd_dq", "flash_bwd.cu", "343",
                         pair_launches["flash_bwd_dq"], err["pair_dq"],
                         main["dq_ms"], main["plain_bwd_ms"],
                         main["library_bwd_ms"]),
             d128=d128_bwd("dq_ms", ("pair_dq", "pair_delta")),
             train_lamb_run_launches=lamb_launches["flash_bwd_dq"],
             static_train=static_train_entry("flash_bwd_dq"),
             static_book=static_book_entry("flash_bwd_dq"),
             static_book_embed=embed_entry("flash_bwd_dq"),
             static_transformer=transformer_entry("flash_bwd_dq"),
             eager_transformer=eager_transformer_entry("flash_bwd_dq"),
             eager_vision=eager_vision_entry("flash_bwd_dq")),
        dict(flash_entry("flash_bwd_dkv", "flash_bwd.cu", "399",
                         pair_launches["flash_bwd_dkv"],
                         max(err["pair_dk"], err["pair_dv"]), main["dkv_ms"],
                         main["plain_bwd_ms"], main["library_bwd_ms"]),
             d128=d128_bwd("dkv_ms", ("pair_dk", "pair_dv")),
             train_lamb_run_launches=lamb_launches["flash_bwd_dkv"],
             static_train=static_train_entry("flash_bwd_dkv"),
             static_book=static_book_entry("flash_bwd_dkv"),
             static_book_embed=embed_entry("flash_bwd_dkv"),
             static_transformer=transformer_entry("flash_bwd_dkv"),
             eager_transformer=eager_transformer_entry("flash_bwd_dkv"),
             eager_vision=eager_vision_entry("flash_bwd_dkv")),
        dict(flash_entry("flash_bwd_fused", "flash_bwd_fused.cu", "490",
                         train_launches["flash_bwd_fused"],
                         max(err["fused_dq"], err["fused_dk"],
                             err["fused_dv"]),
                         main["fused_ms"], main["plain_bwd_ms"],
                         main["library_bwd_ms"]),
             train_lamb_run_launches=lamb_launches["flash_bwd_fused"],
             static_train=static_train_entry("flash_bwd_fused"),
             static_book=static_book_entry("flash_bwd_fused"),
             static_book_embed=embed_entry("flash_bwd_fused"),
             static_transformer=transformer_entry("flash_bwd_fused"),
             eager_transformer=eager_transformer_entry("flash_bwd_fused"),
             eager_vision=eager_vision_entry("flash_bwd_fused")),
        dict(name="decode_attention", route="cuda",
             source=src + "decode_attention.cu",
             replaces="paddle_tpu/ops/pallas/decode_attention.py:73",
             launches=launches["decode_attention"],
             draft_decode=dict(draft_decode_row, speculative_run_launches=(
                 launches["engine_speculative"]["decode_attention"])),
             static_train=static_train_entry("decode_attention"),
             static_book=static_book_entry("decode_attention"),
             static_book_embed=embed_entry("decode_attention"),
             static_transformer=transformer_entry("decode_attention"),
             eager_transformer=eager_transformer_entry("decode_attention"),
             eager_vision=eager_vision_entry("decode_attention"),
             **dense_row),
        dict(name="paged_attention", route="cuda",
             source=src + "paged_attention.cu",
             replaces="paddle_tpu/ops/pallas/paged_attention.py:153",
             launches=launches["paged_attention"],
             prefix_run_launches=launches["engine_prefix"]["paged_attention"],
             chunked_run_launches=launches["engine_chunked"][
                 "paged_attention"],
             int8_run_launches=launches["engine_int8"]["paged_attention"],
             speculative_run_launches=launches["engine_speculative"][
                 "paged_attention"],
             serving_fleet_run_launches=launches["serving_fleet"][
                 "paged_attention"],
             serving_kill_run_launches=launches["serving_kill"][
                 "paged_attention"],
             disagg_decode_launches=[launches[k]["paged_attention"] for k in (
                 "disagg_decode", "disagg_int8_decode")],
             static_train=static_train_entry("paged_attention"),
             static_book=static_book_entry("paged_attention"),
             static_book_embed=embed_entry("paged_attention"),
             static_transformer=transformer_entry("paged_attention"),
             eager_transformer=eager_transformer_entry("paged_attention"),
             eager_vision=eager_vision_entry("paged_attention"),
             **paged_row),
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
             cublas_gemm_ms=mm_main["cublas_gemm_ms"]["fwd"],
             static_serve=static_entry("matmul_bias_act"),
             static_train=static_train_entry("matmul_bias_act"),
             static_book=static_book_entry("matmul_bias_act"),
             static_book_embed=embed_entry("matmul_bias_act"),
             static_transformer=transformer_entry("matmul_bias_act"),
             eager_transformer=eager_transformer_entry("matmul_bias_act"),
             eager_vision=eager_vision_entry("matmul_bias_act")),
        dict(mm_entry("matmul_bwd_dx", "matmul_bwd.cu", "272", mm_err["dx"],
                      "dx"), tile=mm_main["bwd_tile"], splits=1,
             static_train=static_train_entry("matmul_bwd_dx"),
             static_book=static_book_entry("matmul_bwd_dx"),
             static_book_embed=embed_entry("matmul_bwd_dx"),
             static_transformer=transformer_entry("matmul_bwd_dx"),
             eager_transformer=eager_transformer_entry("matmul_bwd_dx"),
             eager_vision=eager_vision_entry("matmul_bwd_dx")),
        dict(mm_entry("matmul_bwd_dw", "matmul_bwd.cu", "296",
                      max(mm_err["dw"], mm_err["dbias"]), "dw"),
             tile=mm_main["bwd_tile"], splits=mm_main["dw_splits"],
             static_train=static_train_entry("matmul_bwd_dw"),
             static_book=static_book_entry("matmul_bwd_dw"),
             static_book_embed=embed_entry("matmul_bwd_dw"),
             static_transformer=transformer_entry("matmul_bwd_dw"),
             eager_transformer=eager_transformer_entry("matmul_bwd_dw"),
             eager_vision=eager_vision_entry("matmul_bwd_dw")),
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
    t_ops = sum(w[1] * n for w, n in work) / BOUND_FLOPS[torch.bfloat16] * 1e3
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
        static_train=static_train_entry("conv_bn_relu"),
        static_book=static_book_entry("conv_bn_relu"),
        static_book_embed=embed_entry("conv_bn_relu"),
        static_transformer=transformer_entry("conv_bn_relu"),
        eager_transformer=eager_transformer_entry("conv_bn_relu"),
        eager_vision=eager_vision_entry("conv_bn_relu"),
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
    t_ops = sum(w[1] * n for w, n in work) / BOUND_FLOPS[torch.bfloat16] * 1e3
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
        train_eager_run_launches=eager_launches["conv_bn_stats"],
        static_train=static_train_entry("conv_bn_stats"),
        static_book=static_book_entry("conv_bn_stats"),
        static_book_embed=embed_entry("conv_bn_stats"),
        static_transformer=transformer_entry("conv_bn_stats"),
        eager_transformer=eager_transformer_entry("conv_bn_stats"),
        eager_vision=eager_vision_entry("conv_bn_stats"),
        per_shape=[{k: r[k] for k in keep11} for r in stats_main]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
