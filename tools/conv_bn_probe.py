#!/usr/bin/env python3
"""Runs the bf16 1x1-conv + BN kernels alone on the card, kernel 10
(`ops.conv1x1_bn_relu`: y = relu(x wᵀ · scale + shift)) and kernel 11
(`ops.conv1x1_bn_stats`: y = x wᵀ with its columns' mean and variance),
holds each output against its plain version, and sweeps their tile
widths.

    python3 tools/conv_bn_probe.py [--stage A|B|C|D | --wrappers]

Shapes: `chip_smoke.py`'s `CONV_PATH` (kernel 10, one ResNet-50 eval
forward at B = 128) and `CONV_STATS_PATH` (kernel 11, one train step),
each path's experiment shape, the ragged (777, 200, 264), an M below
one tile (100, 64, 64) and a shape with fewer tiles than SMs (2048,
256, 512).  `--stage A` runs kernel 10 at width 256 only; B kernel 10
at every width of `conv_bn.TILE_WIDTHS`; C and D kernel 11 too.

Each case launches the kernel twice at every width on each grid
("persistent": one CTA an SM walking `matmul.fwd_tile_plan`'s tiles;
"tiles": one CTA a tile) and fails unless the launches of a width are
bitwise equal (y, and kernel 11's mean and variance), and unless y is
within `chip_smoke.gemm_tol` and the statistics within
`chip_smoke.STATS_RTOL` of the plain version on the same inputs.  At the
path shapes it times every (width, grid) and the wrapper
(`conv_schedule`'s pick) with CUDA events around back-to-back calls and
queued behind a sleep (`chip_smoke.queued_ms`: the card's time, where
the events read the host's at small shapes), cuBLAS's bare
``torch.matmul(x, w.t())``, and gives the bound.  One JSON line a
case, the ptxas report of every instantiation first, the path-weighted
sums last.  Exits 1 on any
failure and 2 without a card.

``--wrappers`` only times the public wrappers at the path shapes (CUDA
events and `queued_ms`) and sums them over each path.  It uses no name
younger than the kernels' first port, so a copy of this file in another
tree's ``tools/`` times that tree's kernels: two trees compared in one
call, shape by shape, on the card's time.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

GRIDS = ("persistent", "tiles")
EDGE_SHAPES = (cs.CONV_RAGGED, (100, 64, 64), (2048, 256, 512))


def _grid(cb, m, n, bn, grid, sms):
    from paddle_tpu_torch.ops.matmul import fwd_tiles

    tiles = fwd_tiles(m, n, bn)
    return min(tiles, sms) if grid == "persistent" else tiles


def _relu_run(cb, t, bn, ctas):
    m, n = t["x"].shape[0], t["w"].shape[0]
    y = torch.empty(m, n, dtype=t["x"].dtype, device="cuda")
    cb._launch_conv_bn_relu(t["x"], t["w"], t["scale"], t["shift"], y, bn,
                            ctas)
    return (y,)


def _stats_run(cb, t, bn, ctas):
    return cb._launch_conv_bn_stats(t["x"], t["w"], bn, ctas)


def _operands(gen, m, k, n, kernel):
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn(n, k, device="cuda", generator=gen)
         * (2.0 / k) ** 0.5).to(torch.bfloat16)
    t = {"x": x, "w": w}
    if kernel == "conv_bn_relu":
        import paddle_tpu_torch as ptt
        t["scale"], t["shift"] = ptt.ops.fold_bn(*cs._bn_vectors(gen, n),
                                                 1e-5)
    return t


def case(cb, gen, kernel, m, k, n, widths, per, sms, timed):
    """One shape of one kernel: every width on both grids, twice each;
    errors against the plain version; times when ``timed``."""
    t = _operands(gen, m, k, n, kernel)
    run = _relu_run if kernel == "conv_bn_relu" else _stats_run
    row = {"kernel": kernel, "M": m, "K": k, "N": n, "per_path": per,
           "schedule": list(cb.conv_schedule(m, n, sms)), "widths": {}}
    failures = []
    xf, wf = cs.upcast(t["x"], t["w"])
    if kernel == "conv_bn_relu":
        want = (cb.conv1x1_bn_relu_reference(xf, wf, t["scale"],
                                             t["shift"]),)
    else:
        want = cb.conv1x1_bn_stats_reference(xf, wf)
    first = None
    for bn in widths:
        outs = [run(cb, t, bn, _grid(cb, m, n, bn, g, sms))
                for g in GRIDS for _ in range(2)]
        torch.cuda.synchronize()
        same = all(all(torch.equal(a, b) for a, b in zip(outs[0], o))
                   for o in outs[1:])
        wrow = {"bitwise_grids_and_launches": same}
        if not same:
            failures.append("bn=%d: launches or grids differ" % bn)
        got = outs[0]
        tol = cs.gemm_tol(torch.bfloat16, want[0])
        diff = (got[0].float() - want[0].float()).abs()
        wrow["max_abs_err"] = diff.max().item()
        wrow["limit_share"] = (diff / (tol["atol"] + tol["rtol"]
                                       * want[0].float().abs())).max().item()
        if not (wrow["limit_share"] <= 1.0
                and torch.isfinite(got[0].float()).all()):
            failures.append("bn=%d: y" % bn)
        if kernel == "conv_bn_stats":
            em, ev = cs.stats_errors(got[1], got[2], want[1], want[2])
            wrow["mean_rel_err"], wrow["var_rel_err"] = em, ev
            if not (em <= cs.STATS_RTOL[torch.bfloat16]
                    and ev <= cs.STATS_RTOL[torch.bfloat16]):
                failures.append("bn=%d: statistics" % bn)
        if first is None:
            first = got
        else:
            wrow["same_bits_as_first_width"] = all(
                torch.equal(a, b) for a, b in zip(first, got))
        if timed:   # events read the host's time at small shapes
            for key, timer in (("ms", cs.time_ms),
                               ("queued_ms", cs.queued_ms)):
                wrow[key] = {g: timer(lambda: run(
                    cb, t, bn, _grid(cb, m, n, bn, g, sms))) for g in GRIDS}
            wrow["ctas"] = {g: _grid(cb, m, n, bn, g, sms) for g in GRIDS}
        row["widths"][bn] = wrow
        del outs, got
    if timed:
        import paddle_tpu_torch as ptt
        ops = ptt.ops
        if kernel == "conv_bn_relu":
            fn = lambda: ops.conv1x1_bn_relu(  # noqa: E731
                t["x"], t["w"], t["scale"], t["shift"])
            work = cs.conv_bn_work(m, k, n, torch.bfloat16)
        else:
            fn = lambda: ops.conv1x1_bn_stats(t["x"], t["w"])  # noqa: E731
            work = cs.conv_stats_work(m, k, n, torch.bfloat16)
        row["ms"] = cs.time_ms(fn)
        row["queued_ms"] = cs.queued_ms(fn)
        row["cublas_gemm_ms"] = cs.time_ms(
            lambda: torch.matmul(t["x"], t["w"].t()))
        row["bound_ms"], row["bound_by"] = cs.bound(*work, torch.bfloat16)
        best = min((wr["queued_ms"]["persistent"], bn)
                   for bn, wr in row["widths"].items())
        row["fastest_persistent_width"] = best[1]
    row["ok"] = not failures
    if failures:
        row["failed"] = failures
    return row


def path_sums(rows, kernel):
    """The path-weighted times of one kernel: each path shape's time
    times its launches on the path, summed."""
    path = [r for r in rows if r["kernel"] == kernel and r["per_path"]]
    out = {"launches": sum(r["per_path"] for r in path)}
    for key in ("ms", "queued_ms", "cublas_gemm_ms", "bound_ms"):
        out[key] = sum(r[key] * r["per_path"] for r in path)
    widths = sorted(path[0]["widths"])
    out["persistent_queued_ms_by_width"] = {
        bn: sum(r["widths"][bn]["queued_ms"]["persistent"] * r["per_path"]
                for r in path) for bn in widths}
    out["best_width_each_queued_ms"] = sum(
        min(wr["queued_ms"]["persistent"] for wr in r["widths"].values())
        * r["per_path"] for r in path)
    out["scheduled_width_queued_ms"] = sum(
        r["widths"][r["schedule"][0]]["queued_ms"]["persistent"]
        * r["per_path"] for r in path)
    return out


def wrapper_times(ops, gen):
    """The public wrappers of kernels 10 and 11, bf16, at every path
    shape: one row a shape, and each kernel's path-weighted sums."""
    rows, sums = [], {}
    paths = (("conv_bn_relu", [(b * hw * hw, k, n, per) for b, hw, k, n, per
                               in cs.CONV_PATH], cs.conv_bn_work),
             ("conv_bn_stats", list(cs.CONV_STATS_PATH), cs.conv_stats_work))
    for kernel, shapes, work in paths:
        for m, k, n, per in shapes:
            t = _operands(gen, m, k, n, kernel)
            if kernel == "conv_bn_relu":
                fn = lambda: ops.conv1x1_bn_relu(  # noqa: E731
                    t["x"], t["w"], t["scale"], t["shift"])
            else:
                fn = lambda: ops.conv1x1_bn_stats(t["x"], t["w"])  # noqa
            row = {"kernel": kernel, "M": m, "K": k, "N": n, "per_path": per,
                   "ms": cs.time_ms(fn), "queued_ms": cs.queued_ms(fn),
                   "bound_ms": cs.bound(*work(m, k, n, torch.bfloat16),
                                        torch.bfloat16)[0]}
            rows.append(row)
            cs.emit({"phase": "wrapper", **row})
            for key in ("ms", "queued_ms", "bound_ms"):
                sums.setdefault(kernel, {}).setdefault(key, 0.0)
                sums[kernel][key] += row[key] * per
            del t
    return rows, sums


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=("A", "B", "C", "D"), default="D")
    ap.add_argument("--wrappers", action="store_true",
                    help="time the public wrappers at the path shapes only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_bn_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.wrappers:
        import paddle_tpu_torch as ptt

        torch.backends.cuda.matmul.allow_tf32 = False
        _, sums = wrapper_times(ptt.ops,
                                torch.Generator(device="cuda").manual_seed(16))
        cs.emit({"phase": "wrapper_sums", **sums,
                 "card": torch.cuda.get_device_name(0)})
        return 0
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import conv_bn as cb
    from paddle_tpu_torch.ops.matmul import _sm_count

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = ["conv_bn_relu", "conv_bn_stats", "matmul_bias_act"]
    _build.build(libs)
    cs.emit({"phase": "build", "ptxas": cs.ptxas_summary(
        _build.build_logs, ("conv_bn_relu_tc", "conv_bn_stats_tc",
                            "matmul_fwd_tc"))})
    sms = _sm_count(torch.device("cuda"))
    widths = (256,) if args.stage == "A" else cb.TILE_WIDTHS
    kernels = [("conv_bn_relu", [
        (b * hw * hw, k, n, per)
        for b, hw, k, n, per in (cs.CONV_EXPERIMENT,) + cs.CONV_PATH])]
    if args.stage in ("C", "D"):
        kernels.append(("conv_bn_stats", [
            (m, k, n, per) for m, k, n, per in
            (cs.CONV_STATS_EXPERIMENT,) + cs.CONV_STATS_PATH]))
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows, failed = [], 0
    for kernel, shapes in kernels:
        shapes = shapes + [(m, k, n, 0) for m, k, n in EDGE_SHAPES]
        for m, k, n, per in shapes:
            timed = (m, k, n) not in EDGE_SHAPES
            row = case(cb, gen, kernel, m, k, n, widths, per, sms, timed)
            failed += not row["ok"]
            rows.append(row)
            cs.emit({"phase": "case", **row})
            torch.cuda.empty_cache()
    cs.emit({"phase": "path_sums", "sms": sms, **{
        kernel: path_sums(rows, kernel) for kernel, _ in kernels}})
    cs.emit({"phase": "summary", "stage": args.stage, "failed": failed,
             "card": torch.cuda.get_device_name(0)})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
