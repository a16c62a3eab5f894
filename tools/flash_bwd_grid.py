"""The bf16 flash backward's two schedules over a grid of B and S on the
card: the fused kernel against the dQ + dK/dV pair, each as
`flash_attention_bwd` runs it (the fused kernel's wrapper, or the
pair's two launches from one parameter block under
PADDLE_TPU_FLASH_FUSED_BWD=0), H=12, D=64, no mask, and what
`_use_fused_bwd` picks.  The bf16 constants of that rule
(`FUSED_WAVE_BF16`, `PAIR_WAVE_BF16`, `PAIR_MIN_BF16` in
`paddle_tpu_torch/ops/attention.py`) are fitted to this grid; the times
are CUDA events over 20 calls after 3 warm-ups (`chip_smoke.time_ms`).

    python3 tools/flash_bwd_grid.py [--reps 3]

Prints one JSON line a (B, S, rep) and, last, each (B, S) where the
rule's choice was the slower one on the mean of the reps, with what
that choice costs.  Needs one CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

H, D = 12, 64
SEQS = (128, 256, 384, 448, 512)
BATCHES = (1, 2, 4, 6, 8, 10, 11, 12, 16, 22, 33, 44, 60)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_grid: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops.attention import _use_fused_bwd

    ops = ptt.ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(6)
    sums = {}
    for rep in range(args.reps):
        for s in SEQS:
            for b in BATCHES:
                q, k, v, do = (torch.randn(b, s, H, D, device="cuda",
                                           generator=gen).to(torch.bfloat16)
                               for _ in range(4))
                o, lse = ops.flash_fwd(q, k, v, with_lse=True)
                fused = cs.time_ms(
                    lambda: ops.flash_bwd_fused(q, k, v, o, do, lse))
                with cs._env("PADDLE_TPU_FLASH_FUSED_BWD", "0"):
                    pair = cs.time_ms(
                        lambda: ops.flash_attention_bwd(q, k, v, o, do, lse))
                rule = _use_fused_bwd(b * H, s, s, D, sms, torch.bfloat16)
                print(json.dumps({"rep": rep, "B": b, "S": s,
                                  "fused_ms": fused, "pair_ms": pair,
                                  "rule": "fused" if rule else "pair"}),
                      flush=True)
                acc = sums.setdefault((b, s), [0.0, 0.0, rule])
                acc[0] += fused / args.reps
                acc[1] += pair / args.reps
    wrong = [{"B": b, "S": s, "fused_ms": f, "pair_ms": p,
              "rule": "fused" if rule else "pair",
              "rule_costs": abs(f - p) / min(f, p)}
             for (b, s), (f, p, rule) in sorted(sums.items())
             if (f < p) != rule]
    print(json.dumps({"sms": sms, "cases": len(sums),
                      "rule_slower_on_mean": wrong}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
