#!/usr/bin/env python3
"""Where one dropout-0 step of the static Transformer-base program
(`chip_smoke.transformer_train_program`) through the flash kernels
differs from the same step through their plain versions, on the H100.

    python3 tools/transformer_grad_probe.py

From one seeded startup the step runs through the kernels, through the
plain versions, and through the kernels with one attention kind at a
time (encoder self, decoder causal self, cross) sent to the plain
version.  Printed as JSON lines: each parameter's gradient distance
between the kernel and plain runs over the plain gradient's scale (the
worst eight), the same for each mixed run, and, per row, where in the
target position table the distance lies.  Then, on the arguments the
step gave kernel 1 for each kind (and a seeded output gradient), the
forward and the backward (fused kernel and the dQ + dK/dV pair) against
the plain version and both against a float64 attention: each output's
largest distance over its float64 scale, by 64-row query tile.  The
kernel and plain runs are also compared on one run's relu decisions
(`chip_smoke._static_relu_decisions`), with the number of FFN units
whose input lies on the other side of 0 in the other run.
"""

import json
import os
import sys
from unittest.mock import patch

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402


def kind(q, k, kw):
    if kw.get("causal"):
        return "decoder causal self"
    return "encoder self" if q.shape[1] == k.shape[1] else "cross"


def step(ptt, main, scope, feed, fetch, plain_kinds=()):
    """One run of ``main`` with the attention kinds of ``plain_kinds``
    through the plain version: the fetches as tensors."""
    ops = ptt.ops
    sdpa = ops.attention.scaled_dot_product_attention

    def mixed(q, k, v, **kw):
        if kind(q, k, kw) in plain_kinds:
            return ops.flash_attention_reference(
                q, k, v, kw.get("bias"), kw.get("segment_ids"), kw["scale"],
                kw["causal"], kw["layout"])[0]
        return sdpa(q, k, v, **kw)

    with patch.object(ops.attention, "scaled_dot_product_attention", mixed):
        return ptt.fluid.Executor().run(main, feed=feed, fetch_list=fetch,
                                        scope=scope, return_numpy=False)


def rel(a, b):
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    return err / scale if scale else err


def attention64(q, k, v, bias, scale, causal):
    """Attention in float64 with autograd leaves: (o, (q, k, v, bias))."""
    q, k, v = (t.double().detach().requires_grad_() for t in (q, k, v))
    b64 = None if bias is None else bias.double().detach().requires_grad_()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if b64 is not None:
        s = s + b64
    if causal:
        sq, sk = s.shape[-2:]
        vis = torch.ones(sq, sk, dtype=torch.bool,
                         device=s.device).tril(sk - sq)
        s = s.masked_fill(~vis, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return o, (q, k, v, b64)


def by_tile(err, scale, rows, axis):
    """The largest distance over ``scale`` of each 64-row tile along
    ``axis``."""
    return [round((err.narrow(axis, i, min(64, rows - i)).max()
                   / scale).item(), 9) for i in range(0, rows, 64)]


def kernel_check(ptt, q, k, v, kw, gen):
    ops = ptt.ops
    bias = kw.get("bias")
    bias = bias.detach() if bias is not None else None
    scale, causal, layout = kw["scale"], kw["causal"], kw["layout"]
    o, lse = ops.flash_fwd(q, k, v, bias, None, scale, causal, layout,
                           with_lse=True)
    do = torch.randn(o.shape, device="cuda", generator=gen)
    o_p, lse_p = ops.flash_attention_reference(q, k, v, bias, None, scale,
                                               causal, layout)
    o64, leaves = attention64(q, k, v, bias, scale, causal)
    g64 = torch.autograd.grad(o64, [t for t in leaves if t is not None],
                              do.double())
    names = ("dq", "dk", "dv", "dbias")
    grad_bias = bias is not None
    runs = {
        "fused": ops.flash_bwd_fused(q, k, v, o, do, lse, bias, None, scale,
                                     causal, layout, bias_grad=grad_bias),
        "plain": ops.flash_attention_bwd_reference(
            q, k, v, bias, None, o, do, lse, scale, causal, layout),
    }
    dq, delta = ops.flash_bwd_dq(q, k, v, o, do, lse, bias, None, scale,
                                 causal, layout)
    dk, dv, db = ops.flash_bwd_dkv(q, k, v, o, do, lse, delta, bias, None,
                                   scale, causal, layout,
                                   bias_grad=grad_bias)
    runs["pair"] = (dq, dk, dv, db)
    torch.cuda.synchronize()
    out = {"o": {"kernel_vs_f64": rel(o.double(), o64),
                 "plain_vs_f64": rel(o_p.double(), o64),
                 "kernel_by_q_tile": by_tile((o.double() - o64).abs(),
                                             o64.abs().max(), q.shape[1], 1)}}
    for name, i in zip(names, range(4)):
        if i >= len(g64):
            break
        want = g64[i]
        row = {}
        for run, res in runs.items():
            got = res[i]
            if got is None:
                continue
            got = got.double()
            if name == "dbias":         # [B, H, 1, Sk] to the bias' shape
                got = got.sum(dim=1, keepdim=True)
            row[run + "_vs_f64"] = rel(got, want)
            if name != "dbias":
                row[run + "_by_tile"] = by_tile(
                    (got - want).abs(), want.abs().max(), got.shape[1], 1)
        out[name] = row
    return out


def main():
    if not torch.cuda.is_available():
        print("transformer_grad_probe: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    fluid, ops = ptt.fluid, ptt.ops
    cfg, main, startup, loss, _, _ = cs.transformer_train_program(ptt, 0.0)
    scope0 = fluid.Scope()
    fluid.Executor().run(startup, scope=scope0)
    names = [v.name for v in main.list_vars() if v.persistable]
    params = [p.name for p in main.all_parameters()]
    feed = cs.wmt_batch(cfg, 2)
    fetch = [loss.name] + [n + "@GRAD" for n in params]
    kinds = ("encoder self", "decoder causal self", "cross")

    def run(plain_kinds):
        scope = cs._copy_scope(fluid, scope0, names)
        out = step(ptt, main, scope, feed, fetch, plain_kinds)
        return dict(zip(["loss"] + params, out))

    with cs._static_relu_decisions(ptt) as rec:
        kernel = run(())
    plain = run(kinds)
    with cs._static_relu_decisions(ptt, rec.masks) as forced:
        held = run(kinds)
    del rec
    errs = sorted(((rel(kernel[n], held[n]), n) for n in params),
                  reverse=True)
    print(json.dumps({"probe": "kernel vs plain on the kernel run's relu "
                               "decisions", "relu_units_flipped":
                      forced.flips, "embedding.w_3": rel(
                          kernel["embedding.w_3"], held["embedding.w_3"]),
                      "worst": errs[:8]}), flush=True)
    errs = sorted(((rel(kernel[n], plain[n]), n) for n in params),
                  reverse=True)
    print(json.dumps({"probe": "kernel vs plain", "loss": [
        kernel["loss"].item(), plain["loss"].item()],
        "worst": errs[:8]}), flush=True)
    g_k, g_p = kernel["embedding.w_3"], plain["embedding.w_3"]
    per_row = ((g_k - g_p).abs().amax(1) / g_p.abs().max()).tolist()
    scale_row = (g_p.abs().amax(1) / g_p.abs().max()).tolist()
    worst_rows = sorted(range(len(per_row)), key=lambda i: -per_row[i])[:10]
    print(json.dumps({"probe": "embedding.w_3 rows", "worst_rows": [
        (i, per_row[i], scale_row[i]) for i in worst_rows]}), flush=True)
    for kd in kinds:
        mixed = run((kd,))
        errs = sorted(((rel(mixed[n], plain[n]), n) for n in params),
                      reverse=True)
        print(json.dumps({"probe": "kernels except at %s" % kd,
                          "embedding.w_3": rel(mixed["embedding.w_3"],
                                               plain["embedding.w_3"]),
                          "worst": errs[:4]}), flush=True)
        mixed = run(tuple(k for k in kinds if k != kd))
        print(json.dumps({"probe": "kernels only at %s" % kd,
                          "embedding.w_3": rel(mixed["embedding.w_3"],
                                               plain["embedding.w_3"])}),
              flush=True)

    calls = cs._recorded_calls(ops, lambda: step(
        ptt, main, cs._copy_scope(fluid, scope0, names), feed, fetch))
    gen = torch.Generator(device="cuda").manual_seed(5)
    seen = set()
    for q, k, v, kw in calls["flash"]:
        kd = kind(q, k, kw)
        if kd in seen:
            continue
        seen.add(kd)
        q, k, v = (t.detach() for t in (q, k, v))
        print(json.dumps({"probe": "kernel at " + kd,
                          "shape": list(q.shape), "Sk": k.shape[1],
                          **kernel_check(ptt, q, k, v, kw, gen)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
