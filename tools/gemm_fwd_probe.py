#!/usr/bin/env python3
"""Runs the fused-epilogue GEMM's forward kernel (y = act(x wᵀ + bias)
and z: `paddle_tpu_torch.ops.matmul_bias_act_fwd`) alone on the card
and holds each output against its plain version.

    python3 tools/gemm_fwd_probe.py [--stage A|B|C]

Cases: `chip_smoke.py`'s `check_matmul` shapes (M, K, N = 256, 128, 384
and the ragged 777, 264, 200), M = 1 and M = 63, (4000, 256, 512) and
the BERT FFN's shape (30720, 768, 3072); bf16 (f32 too at the small
shapes).  `--stage A` takes act none without a bias or z; B and C every
activation, with and without a bias, z emitted or not.  Each case
launches the forward twice on each grid schedule ("tiles": one CTA a
128 x 256 tile; "persistent": one CTA an SM walking `fwd_tile_plan`'s
tiles) and fails unless all four launches are bitwise equal, and holds
y and z to `chip_smoke.gemm_tol`'s limits against the plain version on
the same inputs.

One JSON line a case, then the FFN shape's times (bf16, gelu, bias, z)
on both schedules, with no activation, bias or z, by activation,
cuBLAS's bare product, the library call (F.gelu(F.linear)) and the
bound.  Exits 1 on any failure and 2 without a card.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

SHAPES = ((256, 128, 384), (777, 264, 200), (1, 768, 3072),
          (63, 264, 200), (4000, 256, 512))
FFN = (cs.FFN_M, cs.FFN_K, cs.FFN_N)
# the grid schedules: one CTA a tile, or one an SM (`fwd_schedule`)
SCHEDULES = ("tiles", "persistent")


def operands(gen, m, k, n, dt, has_bias, scale=1.0):
    x = torch.randn(m, k, device="cuda", generator=gen).to(dt)
    w = (torch.randn(n, k, device="cuda", generator=gen) * scale
         * k ** -0.5).to(dt)
    b = (torch.randn(n, device="cuda", generator=gen) * 0.1).to(dt) \
        if has_bias else None
    return x, w, b


def ctas(mm, m, n, schedule):
    return (mm.fwd_tiles(m, n) if schedule == "tiles"
            else mm.fwd_schedule(m, n, mm._sm_count(torch.device("cuda"))))


def run_fwd(mm, x, w, b, act, approx, emit_z, schedule):
    """One forward launch on ``schedule``'s grid: (y, z)."""
    m, n = x.shape[0], w.shape[0]
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    z = torch.empty_like(y) if emit_z else None
    mm._launch_fwd(x, w, b, y, z, act, approx, ctas(mm, m, n, schedule))
    return y, z


def case(ops, gen, m, k, n, dt, act, approx, has_bias, emit_z, scale=1.0):
    mm = ops.matmul
    x, w, b = operands(gen, m, k, n, dt, has_bias, scale)
    outs = [run_fwd(mm, x, w, b, act, approx, emit_z, s)
            for s in SCHEDULES for _ in range(2)]
    torch.cuda.synchronize()
    y, z = outs[0]
    bitwise = all(torch.equal(y, o[0]) and (
        z is None or torch.equal(z, o[1])) for o in outs[1:])
    row = {"M": m, "K": k, "N": n, "dtype": str(dt).replace("torch.", ""),
           "act": act + ("_tanh" if approx else ""), "bias": has_bias,
           "z": emit_z, "bitwise": bitwise}
    xf, wf, bf = cs.upcast(x, w, b)
    y_ref, z_ref = ops.matmul_bias_act_reference(xf, wf, bf, act, approx,
                                                 emit_z=True)
    checks = [("y", y, y_ref)] + ([("z", z, z_ref)] if emit_z else [])
    row["max_abs_err"], row["limit_share"] = {}, {}
    failures = [] if bitwise else ["launches or schedules differ"]
    for tag, got, want in checks:
        tol = cs.gemm_tol(dt, want)
        got_f, want_f = got.float(), want.float()
        diff = (got_f - want_f).abs()
        row["max_abs_err"][tag] = diff.max().item()
        row["limit_share"][tag] = (diff / (tol["atol"] + tol["rtol"]
                                           * want_f.abs())).max().item()
        if not (row["limit_share"][tag] <= 1.0
                and torch.isfinite(got_f).all()):
            failures.append(tag)
    row["ok"] = not failures
    if failures:
        row["failed"] = failures
    return row


def ffn_times(ops, gen):
    """The forward at the FFN shape (bf16, gelu, bias, z) on both
    schedules, beside the same product with no epilogue, each other
    activation, cuBLAS's bare product, the library call and the bound."""
    import torch.nn.functional as F

    mm = ops.matmul
    m, k, n = FFN
    dt = torch.bfloat16
    x, w, b = operands(gen, m, k, n, dt, True, scale=0.02 * k ** 0.5)
    row = {
        "M": m, "K": k, "N": n, "dtype": "bfloat16", "act": "gelu",
        "tile": [mm.FWD_ROWS, mm.FWD_COLS],
        "ctas": {s: ctas(mm, m, n, s) for s in SCHEDULES},
        "fwd_ms": {s: cs.time_ms(lambda: run_fwd(
            mm, x, w, b, "gelu", False, True, s)) for s in SCHEDULES},
        "noact_ms": {s: cs.time_ms(lambda: run_fwd(
            mm, x, w, None, "none", False, False, s)) for s in SCHEDULES},
        "ms_by_act": {},
        "cublas_gemm_ms": cs.time_ms(lambda: torch.matmul(x, w.t())),
        "library_ms": cs.time_ms(lambda: F.gelu(F.linear(x, w, b))),
        "bound_ms": cs.bound((m * k + n * k + n + 2 * m * n) * 2,
                             2 * m * n * k, dt)}
    for act, approx in cs.MM_ACTS:
        tag = act + ("_tanh" if approx else "")
        row["ms_by_act"][tag] = cs.time_ms(lambda: ops.matmul_bias_act_fwd(
            x, w, b, act, approx, emit_z=True))
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=("A", "B", "C"), default="C")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_fwd_probe: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["matmul_bias_act"])
    cs.emit({"phase": "build", "ptxas": [
        ln.strip() for ln in _build.build_logs.get("matmul_bias_act", "")
        .splitlines() if "registers" in ln or "spill" in ln
        or "Compiling entry" in ln]})
    ops = ptt.ops
    gen = torch.Generator(device="cuda").manual_seed(12)
    acts = cs.MM_ACTS if args.stage != "A" else (("none", False),)
    variants = ((False, False), (True, False), (True, True), (False, True)) \
        if args.stage != "A" else ((False, False),)
    failed = 0
    for m, k, n in SHAPES + (FFN,):
        for dt in (torch.float32, torch.bfloat16):
            if dt == torch.float32 and m * n > 1e7:
                continue
            for act, approx in acts:
                for has_bias, emit_z in variants:
                    scale = 0.02 * k ** 0.5 if (m, k, n) == FFN else 1.0
                    row = case(ops, gen, m, k, n, dt, act, approx, has_bias,
                               emit_z, scale)
                    failed += not row["ok"]
                    cs.emit({"phase": "case", **row})
    cs.emit({"phase": "ffn_times", **ffn_times(ops, gen)})
    cs.emit({"phase": "summary", "stage": args.stage, "failed": failed,
             "card": torch.cuda.get_device_name(0)})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
