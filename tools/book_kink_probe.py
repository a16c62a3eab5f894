#!/usr/bin/env python3
"""How far one dropout-free step of the Fluid book's VGG-16-BN program
(`chip_smoke.book_vgg16_bn`, on `dataset.cifar.train10`) moves its
gradients when its forward moves by rounding alone, on the CPU.

    python3 tools/book_kink_probe.py [--batch 16]

The step runs twice from one seeded startup: in f32 as built, and in
float64 (the feed and every state tensor cast, the port's batch_norm
replaced by the same formula in float64, since its statistics are
reduced in f32).  Printed: the loss of each run; for each max pool, the
windows whose argmax differs between the two runs' inputs, and their
inputs' largest distance over scale; for each relu, the inputs on the
other side of 0; for each parameter, its f32 gradient's largest
distance from the float64 one over the float64 one's scale.  A window
whose two largest inputs lie within rounding of each other, or a relu
input within rounding of 0, sends its gradient elsewhere, and every
gradient below it moves with it: a card and the CPU, whose forwards
differ at 1e-7, can disagree there by percents with neither at fault.
"""

import argparse
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch.ops import nn_ops as _nn  # noqa: E402

SHAPE = (3, 32, 32)


class _BatchNormTrain64:
    """`_BatchNormTrain.apply` for float64 x (statistics and the
    normalize in float64, autograd for the backward); other dtypes go to
    the port's own."""
    port = _nn._BatchNormTrain

    @classmethod
    def apply(cls, x, weight, bias, mean, var, eps):
        if x.dtype != torch.float64:
            return cls.port.apply(x, weight, bias, mean, var, eps)
        m = x.mean((0, 2, 3))
        rstd = torch.rsqrt((x - m.view(1, -1, 1, 1)).square().mean(
            (0, 2, 3)) + eps)
        y = ((x - m.view(1, -1, 1, 1)) * (weight * rstd).view(1, -1, 1, 1)
             + bias.view(1, -1, 1, 1))
        return y, m.detach(), rstd.detach()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()
    torch.manual_seed(0)
    fluid = ptt.fluid
    main_p, startup, _, loss, _, _ = cs.book_program(
        ptt, cs.book_vgg16_bn, SHAPE, dropout=False)
    feed = cs.book_feeds(ptt, ptt.dataset.cifar.train10(), args.batch,
                         SHAPE)[0]
    block = main_p.global_block
    pools = [op.input("X")[0] for op in block.ops
             if op.type == "pool2d" and op.attrs.get("op_role") is None]
    relus = [op.input("X")[0] for op in block.ops if op.type == "relu"]
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    start = {v.name: scope.find_var(v.name).clone()
             for v in main_p.list_vars() if v.persistable and not v.is_data}
    params = [p.name for p in main_p.all_parameters() if p.trainable]
    fetch = [loss.name] + [n + "@GRAD" for n in params] + pools + relus
    _nn._BatchNormTrain = _BatchNormTrain64
    runs = {}
    for dt in (torch.float32, torch.float64):
        sc = fluid.Scope()
        for n, t in start.items():
            sc.set(n, t.clone().to(dt) if t.is_floating_point()
                   else t.clone())
        f = {k: v.astype(np.float64) if dt == torch.float64
             and v.dtype == np.float32 else v for k, v in feed.items()}
        runs[dt] = [o.double() for o in exe.run(
            main_p, feed=f, fetch_list=fetch, scope=sc, return_numpy=False)]
    _nn._BatchNormTrain = _BatchNormTrain64.port
    a, b = runs[torch.float32], runs[torch.float64]
    print("batch %d; loss f32 %.9g, float64 %.12g" % (
        args.batch, a[0].item(), b[0].item()))
    k = 1 + len(params)
    for j, name in enumerate(pools):
        x, y = a[k + j], b[k + j]
        _, ix = F.max_pool2d(x, 2, 2, return_indices=True)
        _, iy = F.max_pool2d(y, 2, 2, return_indices=True)
        print("pool %d %s: %d of %d windows flip; input %.2e of scale" % (
            j, tuple(x.shape), (ix != iy).sum().item(), ix.numel(),
            (x - y).abs().max().item() / y.abs().max().item()))
    k += len(pools)
    print("relu inputs across 0: %s" % [
        int(((a[k + j] > 0) != (b[k + j] > 0)).sum().item())
        for j in range(len(relus))])
    for i, n in enumerate(params):
        g, w = a[1 + i], b[1 + i]
        scale = w.abs().max().item()
        print("%-16s %-18s f32 vs float64 %.2e of scale %.2e" % (
            n, tuple(w.shape), (g - w).abs().max().item() / scale, scale))


if __name__ == "__main__":
    main()
