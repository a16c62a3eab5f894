#!/usr/bin/env python3
"""Runs the fused-epilogue GEMM's backward kernels (dX, and dW + dbias:
`paddle_tpu_torch.ops.matmul_bwd_dx` / `matmul_bwd_dw`) alone on the
card and holds each output against its plain version.

    python3 tools/gemm_bwd_probe.py [--stage A|B|C] [--sweep]

Cases: `chip_smoke.py`'s `check_matmul` shapes (M, K, N = 256, 128, 384
and the ragged 777, 264, 200), M = 1 and M = 63, a bf16 shape whose M
is not a multiple of its dW split's chunk (4000, 256, 512), and the
BERT FFN's shape (30720, 768, 3072); every activation, with and without
a bias; bf16 (f32 too at the small shapes).  The residual comes from the
forward kernel, as in training.  Each case launches dX and dW twice and
fails unless the two launches are bitwise equal, and holds dX, dW and
dbias to `chip_smoke.gemm_tol`'s limits against the plain version on
the same inputs.  `--stage A` takes act none without a bias only.

One JSON line a case (errors, limit shares, the dW split), then the
FFN shape's times (bf16, gelu, bias: dX, dW + dbias, the same with no
activation and with each other one, cuBLAS's bare products, the library
call, the bound) and, with `--sweep`, dW + dbias at several splits of
M.  Exits 1 on any failure and 2 without a card.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

SHAPES = ((256, 128, 384), (777, 264, 200), (1, 768, 3072),
          (63, 264, 200), (63, 768, 3072), (4000, 256, 512))
FFN = (cs.FFN_M, cs.FFN_K, cs.FFN_N)
SWEEP_SPLITS = (1, 2, 3, 4, 5, 6, 8, 11, 16)


def operands(gen, m, k, n, dt, has_bias, scale=1.0):
    x = torch.randn(m, k, device="cuda", generator=gen).to(dt)
    w = (torch.randn(n, k, device="cuda", generator=gen) * scale
         * k ** -0.5).to(dt)
    b = (torch.randn(n, device="cuda", generator=gen) * 0.1).to(dt) \
        if has_bias else None
    g = torch.randn(m, n, device="cuda", generator=gen).to(dt)
    return x, w, b, g


def case(ops, gen, m, k, n, dt, act, approx, has_bias, scale=1.0):
    mm = ops.matmul
    x, w, b, g = operands(gen, m, k, n, dt, has_bias, scale)
    kind = mm._residual_kind(act)
    y, z = ops.matmul_bias_act_fwd(x, w, b, act, approx, emit_z=True)
    res = z if kind == "z" else (y if kind == "y" else None)
    dx = ops.matmul_bwd_dx(g, res, w, act, approx)
    dx2 = ops.matmul_bwd_dx(g, res, w, act, approx)
    dw, db = ops.matmul_bwd_dw(x, g, res, act, approx, bias=b)
    dw2, db2 = ops.matmul_bwd_dw(x, g, res, act, approx, bias=b)
    torch.cuda.synchronize()
    row = {"M": m, "K": k, "N": n, "dtype": str(dt).replace("torch.", ""),
           "act": act + ("_tanh" if approx else ""), "bias": has_bias}
    if dt == torch.bfloat16:
        row["dw_split"] = mm.dw_split_plan(m, n, k, mm._sm_count(x.device))
    bitwise = torch.equal(dx, dx2) and torch.equal(dw, dw2) and (
        b is None or torch.equal(db, db2))
    xf, wf, bf, gf, rf = cs.upcast(x, w, b, g, res)
    dx_ref, dw_ref, db_ref = ops.matmul_bias_act_bwd_reference(
        xf, wf, bf, rf, gf, act, approx)
    bf16 = dt == torch.bfloat16
    checks = [("dx", dx, dx_ref, cs.gemm_tol(dt, dx_ref, bf16)),
              ("dw", dw, dw_ref, cs.gemm_tol(dt, dw_ref, bf16))]
    if b is not None:
        checks.append(("dbias", db, db_ref, cs.gemm_tol(dt, db_ref)))
    row["max_abs_err"], row["limit_share"] = {}, {}
    failures = [] if bitwise else ["two launches differ"]
    for tag, got, want, tol in checks:
        got_f, want_f = got.float(), want.float()
        diff = (got_f - want_f).abs()
        row["max_abs_err"][tag] = diff.max().item()
        row["limit_share"][tag] = (diff / (tol["atol"] + tol["rtol"]
                                           * want_f.abs())).max().item()
        if not (row["limit_share"][tag] <= 1.0
                and torch.isfinite(got_f).all()):
            failures.append(tag)
    row["bitwise"] = bitwise
    row["ok"] = not failures
    if failures:
        row["failed"] = failures
    return row


def ffn_times(ops, gen, sweep):
    """dX and dW + dbias at the FFN shape (bf16, gelu, bias), beside the
    same kernels with no activation, cuBLAS's bare products, the
    library call and the bound; with ``sweep`` also dW + dbias at
    several splits of M."""
    import torch.nn.functional as F

    mm = ops.matmul
    m, k, n = FFN
    dt = torch.bfloat16
    x, w, b, g = operands(gen, m, k, n, dt, True, scale=0.02 * k ** 0.5)
    _, z = ops.matmul_bias_act_fwd(x, w, b, "gelu", emit_z=True)
    xl, wl, bl = (v.detach().requires_grad_() for v in (x, w, b))
    out = F.gelu(F.linear(xl, wl, bl))
    splits, chunk = mm.dw_split_plan(m, n, k, mm._sm_count(x.device))
    row = {
        "M": m, "K": k, "N": n, "dtype": "bfloat16", "act": "gelu",
        "tile": [mm.BWD_ROWS, mm.BWD_COLS], "dw_split": [splits, chunk],
        "dx_ms": cs.time_ms(lambda: ops.matmul_bwd_dx(g, z, w, "gelu")),
        "dw_ms": cs.time_ms(lambda: ops.matmul_bwd_dw(x, g, z, "gelu",
                                                      bias=b)),
        "noact_ms": {
            "dx": cs.time_ms(lambda: ops.matmul_bwd_dx(g, None, w)),
            "dw": cs.time_ms(lambda: ops.matmul_bwd_dw(x, g, None))},
        "cublas_gemm_ms": {
            "dx": cs.time_ms(lambda: torch.matmul(g, w)),
            "dw": cs.time_ms(lambda: torch.matmul(g.t(), x))},
        "library_dx_ms": cs.time_ms(lambda: torch.autograd.grad(
            out, (xl,), g, retain_graph=True)),
        "library_dw_ms": cs.time_ms(lambda: torch.autograd.grad(
            out, (wl, bl), g, retain_graph=True)),
        "bound_ms": cs.bound((2 * m * n + n * k + m * k) * 2, 2 * m * n * k,
                             dt)}
    # each activation's cost in forming dZ (the residual as training
    # saves it: z for gelu, y for relu and tanh)
    row["dx_ms_by_act"], row["dw_ms_by_act"] = {}, {}
    for act, approx in cs.MM_ACTS[1:]:
        kind = mm._residual_kind(act)
        y, z2 = ops.matmul_bias_act_fwd(x, w, b, act, approx, emit_z=True)
        res = z2 if kind == "z" else y
        tag = act + ("_tanh" if approx else "")
        row["dx_ms_by_act"][tag] = cs.time_ms(
            lambda: ops.matmul_bwd_dx(g, res, w, act, approx))
        row["dw_ms_by_act"][tag] = cs.time_ms(
            lambda: ops.matmul_bwd_dw(x, g, res, act, approx, bias=b))
    if sweep:
        dw = torch.empty(n, k, dtype=dt, device="cuda")
        db = torch.empty(n, dtype=dt, device="cuda")
        stages = -(-m // mm.BWD_DEPTH)
        row["dw_ms_by_split"] = {}
        for s in SWEEP_SPLITS:
            per = -(-stages // s) * mm.BWD_DEPTH
            s_eff = -(-m // per)
            row["dw_ms_by_split"][s_eff] = cs.time_ms(lambda: mm._launch_dw(
                x, g, z, dw, db, "gelu", False, s_eff, per))
    del out
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=("A", "B", "C"), default="C")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["matmul_bias_act", "matmul_bwd"])
    cs.emit({"phase": "build", "ptxas": [
        ln.strip() for ln in _build.build_logs.get("matmul_bwd", "")
        .splitlines() if "registers" in ln or "spill" in ln
        or "Compiling entry" in ln]})
    ops = ptt.ops
    gen = torch.Generator(device="cuda").manual_seed(12)
    acts = cs.MM_ACTS if args.stage != "A" else (("none", False),)
    biases = (False, True) if args.stage != "A" else (False,)
    failed = 0
    for m, k, n in SHAPES + (FFN,):
        for dt in (torch.float32, torch.bfloat16):
            if dt == torch.float32 and m * n > 1e7:
                continue
            for act, approx in acts:
                for has_bias in biases:
                    scale = 0.02 * k ** 0.5 if (m, k, n) == FFN else 1.0
                    row = case(ops, gen, m, k, n, dt, act, approx, has_bias,
                               scale)
                    failed += not row["ok"]
                    cs.emit({"phase": "case", **row})
    cs.emit({"phase": "ffn_times", **ffn_times(ops, gen, args.sweep)})
    cs.emit({"phase": "summary", "stage": args.stage, "failed": failed,
             "card": torch.cuda.get_device_name(0)})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
