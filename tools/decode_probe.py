#!/usr/bin/env python3
"""Runs the decode-attention kernels (dense: `paddle_tpu_torch.ops.
decode_attention`; paged: `paged_decode_attention`, one body that splits
each slot's key range into chunks) alone on the card and holds each
output against its plain version.

    python3 tools/decode_probe.py [--stage A|B|C]

Cases: `chip_smoke.py`'s serving shape (8 slots, lengths 0, 1, 17, 1024,
300, 511, 64, 900 of a 1024-position cache in 16-row blocks, 12 heads),
one slot of 1024, and lengths at the chunk plan's edges (0, 1, bs - 1,
a chunk +- 1, T - 1, T) with stale table entries past each length.
`--stage A` takes f32 at head dim 64; B and C f32 and bf16 at 64 and
128.  Each case launches both kernels twice and fails unless the four
outputs are bitwise equal and lie within `chip_smoke.TOL` of the plain
version.

One JSON line a case, then the serving shape's and the one slot's times
(f32, D = 64, and with B and C bf16 and D = 128: the card's time queued
behind a sleep, `chip_smoke.queued_ms`; the paged wrapper's call time,
host included; each kernel's device time from the profiler) beside the
plain version, SDPA with a mask (dense) and the bound; `--stage C` adds the
paged kernel's device time over chunk plans (at most 16, 32, 64 or 128 chunks
a slot) and heads a CTA (12, 6, 4, 3).  Exits 1 on any failure and 2
without a card.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

SWEEP_CHUNKS = (16, 32, 64, 128)
SWEEP_HEADS = (12, 6, 4, 3)


def times(ops, gen, lengths_l, d, dt):
    """Dense and paged ms on one step, with the plain versions, SDPA
    masked and the bound."""
    import torch.nn.functional as F

    q, k_pool, v_pool, tables, k_dense, v_dense, lengths = cs.decode_inputs(
        ops, gen, lengths_l, d, dt)
    scale = d ** -0.5
    t = k_dense.shape[1]
    mask = (torch.arange(t, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    nbytes, flops = cs.decode_bytes(lengths_l, d, dt)
    return {
        "N": len(lengths_l), "D": d, "dtype": str(dt).replace("torch.", ""),
        "dense_ms": cs.queued_ms(lambda: ops.decode_attention(
            q, k_dense, v_dense, lengths, scale=scale)),
        "paged_ms": cs.queued_ms(lambda: ops.paged_decode_attention(
            q, k_pool, v_pool, tables, lengths, scale=scale)),
        "paged_call_ms": cs.time_ms(lambda: ops.paged_decode_attention(
            q, k_pool, v_pool, tables, lengths, scale=scale)),
        "dense_device_ms": cs.device_ms(lambda: ops.decode_attention(
            q, k_dense, v_dense, lengths, scale=scale), "decode_attention"),
        "paged_device_ms": cs.device_ms(lambda: ops.paged_decode_attention(
            q, k_pool, v_pool, tables, lengths, scale=scale),
            "paged_attention"),
        "plain_paged_ms": cs.queued_ms(
            lambda: ops.paged_decode_attention_reference(
                q, k_pool, v_pool, tables, lengths, scale)),
        "sdpa_masked_ms": cs.queued_ms(
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], k_dense.transpose(1, 2),
                v_dense.transpose(1, 2), attn_mask=mask, scale=scale)),
        "bound_ms": cs.bound(nbytes, flops, dt)[0]}


def sweep(ops, gen):
    """The paged kernel's device time at the serving shape (f32, D = 64)
    and at one slot of 1024 over chunk plans and heads a CTA."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.decode_attention import decode_split_plan

    out = {}
    for lengths_l in (list(cs.DECODE_LENGTHS), [cs.DECODE_T]):
        q, k_pool, v_pool, tables, _, _, lengths = cs.decode_inputs(
            ops, gen, lengths_l)
        bs = k_pool.shape[1]
        cap = tables.shape[1] * bs
        row = out["N=%d" % len(lengths_l)] = {}
        for mc in SWEEP_CHUNKS:
            chunk, chunks = decode_split_plan(cap, bs, mc)
            for hg in SWEEP_HEADS:
                row["chunk=%d heads=%d" % (chunk, hg)] = cs.device_ms(
                    lambda: pa._launch_paged(q, k_pool, v_pool, tables,
                                             lengths, 0.125, chunk, chunks,
                                             hg), "paged_attention")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=("A", "B", "C"), default="C")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["decode_attention", "paged_attention"])
    cs.emit({"phase": "build", "ptxas": {
        name: [ln.strip() for ln in _build.build_logs.get(name, "")
               .splitlines() if "registers" in ln or "spill" in ln
               or "Compiling entry" in ln]
        for name in ("decode_attention", "paged_attention")}})
    ops = ptt.ops
    gen = torch.Generator(device="cuda").manual_seed(13)
    kinds = ((cs.D, torch.float32),) if args.stage == "A" else (
        (cs.D, torch.float32), (cs.D, torch.bfloat16), (128, torch.float32),
        (128, torch.bfloat16))
    t, bs = cs.DECODE_T, cs.DECODE_BS
    edge = [0, 1, bs - 1, bs, bs + 1, 63, 64, 65, t - 1, t]
    failed = 0
    for d, dt in kinds:
        for lengths_l, stale in ((list(cs.DECODE_LENGTHS), False),
                                 ([t], False), (edge, True)):
            row = {"lengths": lengths_l, "D": d,
                   "dtype": str(dt).replace("torch.", ""), "stale": stale}
            try:
                row["max_abs_err"], row["limit_share"], _ = cs.decode_case(
                    ops, gen, lengths_l, d, dt, stale)
                row["ok"] = True
            except AssertionError as e:
                row["ok"], row["failed"] = False, str(e)
                failed += 1
            cs.emit({"phase": "case", **row})
    for d, dt in kinds:
        for lengths_l in (list(cs.DECODE_LENGTHS), [t]):
            cs.emit({"phase": "times", **times(ops, gen, lengths_l, d, dt)})
    if args.stage == "C":
        cs.emit({"phase": "sweep", "paged_device_ms": sweep(ops, gen)})
    cs.emit({"phase": "summary", "stage": args.stage, "failed": failed,
             "card": torch.cuda.get_device_name(0)})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
