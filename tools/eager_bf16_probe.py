#!/usr/bin/env python3
"""Where the eager Transformer-base's bf16 step gradients stand, on the
card: `chip_smoke._bf16_grads`'s one `ShardedTrainStep` pass (B = 32,
128 / 120 tokens, `chip_smoke.py`'s batches and weights) through the
flash kernels ("kernel"), their plain versions ("plain"), autograd over
the plain forward ("autograd"), and the kernels in f32 with amp off
("f32"), all on the kernel run's relu decisions and one dropout seed,
at the initial weights and after ``--steps`` AdamW steps.  For each
pair, over every parameter's gradient (`chip_smoke._grad_distances`,
b the second of the pair): the worst and the median ``max |a - b| /
scale``, the worst ``||a - b|| / ||b||``, the five worst tensors and
the two word tables.

    python3 tools/eager_bf16_probe.py [--steps 10]

Needs one CUDA device; prints one JSON line a state, then the card's
name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

PAIRS = (("kernel", "plain"), ("kernel", "autograd"), ("plain", "autograd"),
         ("kernel", "f32"), ("plain", "f32"), ("autograd", "f32"))


def probe(ptt, step, state, batch):
    relus = cs._relu_decisions()
    runs = {"kernel": cs._bf16_grads(ptt, step, state, batch, "kernel",
                                     relus)}
    for tag, amp in (("plain", "bf16"), ("autograd", "bf16"),
                     ("f32", None)):
        runs[tag] = cs._bf16_grads(
            ptt, step, state, batch, "kernel" if tag == "f32" else tag,
            cs._relu_decisions(force=relus.masks), amp)
    scales = cs._key_bias_scales(runs["f32"][1])
    res = {"losses": {k: v[0] for k, v in runs.items()}}
    for a, b in PAIRS:
        d = cs._grad_distances(runs[a][1], runs[b][1], scales)
        worst = sorted(d, key=lambda n: d[n][0])[::-1][:5]
        res["%s_vs_%s" % (a, b)] = {
            "max_of_scale": d[worst[0]][0],
            "median_max_of_scale": float(np.median([v[0]
                                                    for v in d.values()])),
            "max_norm": max(v[1] for v in d.values() if v[1] is not None),
            "worst": [[n, *d[n]] for n in worst],
            "word_tables": {n: d[n] for n in d
                            if n.endswith("_emb.word.weight")}}
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("eager_bf16_probe: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    cfg, model = cs.eager_transformer_model(ptt, 0.1)

    def loss_fn(m, batch):
        return m.loss(m(*[batch[k] for k in (
            "src_ids", "src_pos", "tgt_ids", "tgt_pos", "src_pad_mask")]),
            batch["labels"], 0.1)

    step = ptt.distributed.ShardedTrainStep(
        model, ptt.optimizer.AdamWOptimizer(cs.ETR_BF16_LR), loss_fn,
        amp="bf16")
    batches = [step.place_batch(cs.wmt_batch(cfg, s)) for s in (0, 1)]
    state = step.init()
    print(json.dumps({"state": "init", **probe(ptt, step, state,
                                                batches[0])}), flush=True)
    for i in range(args.steps):
        state, _ = step(state, batches[i % 2])
    print(json.dumps({"state": "after %d steps" % args.steps,
                      **probe(ptt, step, state, batches[0])}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
