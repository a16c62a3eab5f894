#!/usr/bin/env python3
"""Runs the fused-epilogue GEMM's f32 backward kernels (dX, and dW +
dbias: `paddle_tpu_torch.ops.matmul_bwd_dx` / `matmul_bwd_dw`,
`csrc/gemm_tf32x3.cuh`'s 3xTF32 wgmma body) alone on the card.

    python3 tools/gemm_tf32x3_probe.py [--quick]

* ptxas's registers and spills of each f32 backward kernel.
* Cases: `chip_smoke.py`'s `check_matmul` f32 shapes, an f32 shape whose
  N and K are odd (the 4-byte copy path), (63, 768, 3072) and the static
  BERT step's FFN (4096, 768, 3072); every activation, with and without
  a bias.  Each case launches dX and dW twice and fails unless the two
  launches are bitwise equal, and holds dX, dW and dbias to
  `chip_smoke.gemm_tol`'s f32 limits against the plain version.
* At the FFN shape (gelu, bias): each output's largest distance from a
  float64 product, over its scale, for the kernels as built, for the
  same source built with the tensor cores' partial promoted every 4 k
  blocks and never (`-DPTT_TF32X3_PROMOTE`), and for the plain version;
  then the times of dX and dW + dbias beside the plain version, the
  library call (torch's dX, and dW + dbias, of F.linear + gelu), the
  variants, and dX and dW at several splits of their contraction.
  `--quick`: the small shapes and act none / gelu only, no times.

Exits 1 on any failure and 2 without a card.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

ODD = (129, 263, 201)
PATH = (4096, 768, 3072)
SHAPES = cs.MM_SHAPES + (ODD, (63, 768, 3072))
PROMOTE_VARIANTS = (4, 1 << 30)
SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 11, 16)


def build_variants(_build):
    """matmul_bwd.cu built once for each PROMOTE_VARIANTS value, all
    started together: {promote: ctypes library}."""
    out = _build.build_dir() / "tf32x3_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for p in PROMOTE_VARIANTS:
        lib = out / ("matmul_bwd_promote%d.so" % p)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               "-DPTT_TF32X3_PROMOTE=%d" % p, "-o", str(lib),
               str(_build.CSRC / "matmul_bwd.cu")]
        procs[p] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    libs = {}
    for p, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc (promote %d) failed:\n%s" % (p, err))
        libs[p] = ctypes.CDLL(str(lib))
    return libs


def variant_bwd(lib, mm, x, w, b, res, g, act, approx):
    """dX, dW and dbias from a variant library's C entries (dW split as
    the wrapper plans it)."""
    m, k = x.shape
    n = w.shape[0]
    code = mm._act_code(act, approx)
    s = torch.cuda.current_stream().cuda_stream
    dx = torch.empty(m, k, device="cuda")
    dw = torch.empty(n, k, device="cuda")
    db = torch.empty(n, device="cuda")
    sms = mm._sm_count(x.device)
    xs, xc = mm.dx_split_plan(m, n, k, sms, torch.float32)
    ws, wc = mm.dw_split_plan(m, n, k, sms, torch.float32)
    xws = torch.empty(xs * m * k, device="cuda") if xs > 1 else None
    wws = torch.empty(ws * n * (k + 1), device="cuda") if ws > 1 else None
    fdx, fdw = lib.matmul_bwd_dx, lib.matmul_bwd_dw
    fdx.argtypes, fdw.argtypes = mm._DX_ARGTYPES, mm._DW_ARGTYPES
    p = mm._ptr

    def run_dx():
        return fdx(g.data_ptr(), p(res), w.data_ptr(), dx.data_ptr(),
                   p(xws), m, n, k, xc, code, 0, s)

    def run_dw():
        return fdw(x.data_ptr(), g.data_ptr(), p(res), dw.data_ptr(),
                   db.data_ptr(), p(wws), m, n, k, wc, code, 0, 0, s)

    if run_dx() | run_dw():
        raise RuntimeError("variant launch failed")
    return (dx, dw, db), run_dx, run_dw


def operands(gen, m, k, n, has_bias, scale=1.0):
    x = torch.randn(m, k, device="cuda", generator=gen)
    w = torch.randn(n, k, device="cuda", generator=gen) * scale * k ** -0.5
    b = torch.randn(n, device="cuda", generator=gen) * 0.1 \
        if has_bias else None
    g = torch.randn(m, n, device="cuda", generator=gen)
    return x, w, b, g


def case(ops, gen, m, k, n, act, approx, has_bias, scale=1.0):
    mm = ops.matmul
    x, w, b, g = operands(gen, m, k, n, has_bias, scale)
    kind = mm._residual_kind(act)
    y, z = ops.matmul_bias_act_fwd(x, w, b, act, approx, emit_z=True)
    res = z if kind == "z" else (y if kind == "y" else None)
    dx = ops.matmul_bwd_dx(g, res, w, act, approx)
    dx2 = ops.matmul_bwd_dx(g, res, w, act, approx)
    dw, db = ops.matmul_bwd_dw(x, g, res, act, approx, bias=b)
    dw2, db2 = ops.matmul_bwd_dw(x, g, res, act, approx, bias=b)
    torch.cuda.synchronize()
    sms = mm._sm_count(x.device)
    row = {"M": m, "K": k, "N": n, "act": act + ("_tanh" if approx else ""),
           "bias": has_bias,
           "dx_split": mm.dx_split_plan(m, n, k, sms, torch.float32),
           "dw_split": mm.dw_split_plan(m, n, k, sms, torch.float32)}
    bitwise = torch.equal(dx, dx2) and torch.equal(dw, dw2) and (
        b is None or torch.equal(db, db2))
    want = ops.matmul_bias_act_bwd_reference(x, w, b, res, g, act, approx)
    row["max_abs_err"], row["limit_share"] = {}, {}
    failures = [] if bitwise else ["two launches differ"]
    for tag, got, ref in zip(("dx", "dw", "dbias"), (dx, dw, db), want):
        if got is None:
            continue
        tol = cs.gemm_tol(torch.float32, ref)
        diff = (got - ref).abs()
        row["max_abs_err"][tag] = diff.max().item()
        row["limit_share"][tag] = (diff / (tol["atol"] + tol["rtol"]
                                           * ref.abs())).max().item()
        if not (row["limit_share"][tag] <= 1.0 and torch.isfinite(got).all()):
            failures.append(tag)
    row["bitwise"] = bitwise
    row["ok"] = not failures
    if failures:
        row["failed"] = failures
    return row, dict(x=x, w=w, b=b, g=g, res=res, got=(dx, dw, db),
                     plain=want)


def rel64(got, ref64):
    return ((got.double() - ref64).abs().max() / ref64.abs().max()).item()


def path_row(ops, gen, libs, quick):
    """The FFN shape, gelu, bias: distances from float64 of the kernels,
    the promotion variants and the plain version; then times."""
    import torch.nn.functional as F

    mm = ops.matmul
    m, k, n = PATH
    row, t = case(ops, gen, m, k, n, "gelu", False, True,
                  scale=0.02 * k ** 0.5)
    x, w, b, g, res = t["x"], t["w"], t["b"], t["g"], t["res"]
    dz64 = mm._dact_from_residual(g.double(), res.double(), "gelu", False)
    ref64 = (dz64 @ w.double(), dz64.t() @ x.double(), dz64.sum(0))
    tags = ("dx", "dw", "dbias")
    row["rel_to_float64"] = {
        "kernel": dict(zip(tags, map(rel64, t["got"], ref64))),
        "plain": dict(zip(tags, map(rel64, t["plain"], ref64)))}
    calls = {}
    for p, lib in libs.items():
        outs, cdx, cdw = variant_bwd(lib, mm, x, w, b, res, g, "gelu", False)
        torch.cuda.synchronize()
        row["rel_to_float64"]["promote_%d" % p] = dict(
            zip(tags, map(rel64, outs, ref64)))
        calls[p] = (cdx, cdw)
    del dz64, ref64
    if quick:
        return row
    xl, wl, bl = (v.detach().requires_grad_() for v in (x, w, b))
    out = F.gelu(F.linear(xl, wl, bl))
    row.update({
        "dx_ms": cs.time_ms(lambda: ops.matmul_bwd_dx(g, res, w, "gelu")),
        "dw_ms": cs.time_ms(lambda: ops.matmul_bwd_dw(x, g, res, "gelu",
                                                      bias=b)),
        "plain_dx_ms": cs.time_ms(lambda: ops.matmul_bias_act_bwd_reference(
            x, w, b, res, g, "gelu", needs=(True, False, False)),
            iters=5, warmup=1),
        "plain_dw_ms": cs.time_ms(lambda: ops.matmul_bias_act_bwd_reference(
            x, w, b, res, g, "gelu", needs=(False, True, True)),
            iters=5, warmup=1),
        "library_dx_ms": cs.time_ms(lambda: torch.autograd.grad(
            out, (xl,), g, retain_graph=True)),
        "library_dw_ms": cs.time_ms(lambda: torch.autograd.grad(
            out, (wl, bl), g, retain_graph=True)),
        "noact_ms": {
            "dx": cs.time_ms(lambda: ops.matmul_bwd_dx(g, None, w)),
            "dw": cs.time_ms(lambda: ops.matmul_bwd_dw(x, g, None))},
        "variant_ms": {p: [cs.time_ms(c[0]), cs.time_ms(c[1])]
                       for p, c in calls.items()},
        "bound_ms": cs.bound((2 * m * n + n * k + m * k) * 4, 2 * m * n * k,
                             torch.float32)})
    del out
    dx = torch.empty(m, k, device="cuda")
    dw = torch.empty(n, k, device="cuda")
    db = torch.empty(n, device="cuda")
    for tag, depth, launch in (
            ("dx", n, lambda s, c: mm._launch_dx(g, res, w, dx, "gelu",
                                                 False, s, c)),
            ("dw", m, lambda s, c: mm._launch_dw(x, g, res, dw, db, "gelu",
                                                 False, s, c))):
        stages = -(-depth // mm.F32_BWD_DEPTH)
        row[tag + "_ms_by_split"] = {}
        for s in SWEEP_SPLITS:
            per = -(-stages // s) * mm.F32_BWD_DEPTH
            s_eff = -(-depth // per)
            row[tag + "_ms_by_split"][s_eff] = cs.time_ms(
                lambda: launch(s_eff, per))
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_tf32x3_probe: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["matmul_bias_act", "matmul_bwd"])
    cs.emit({"phase": "build", "ptxas": cs.ptxas_summary(
        _build.build_logs, ("tf32x3", "matmul_dw_merge_f32"))})
    libs = build_variants(_build)
    ops = ptt.ops
    gen = torch.Generator(device="cuda").manual_seed(12)
    acts = cs.MM_ACTS if not args.quick else (("none", False),
                                              ("gelu", False))
    failed = 0
    for m, k, n in SHAPES:
        for act, approx in acts:
            for has_bias in (False, True):
                row, _ = case(ops, gen, m, k, n, act, approx, has_bias)
                failed += not row["ok"]
                cs.emit({"phase": "case", **row})
    row = path_row(ops, gen, libs, args.quick)
    failed += not row["ok"]
    cs.emit({"phase": "path", **row})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cs.emit({"phase": "summary", "failed": failed, "nvidia_smi": smi})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
