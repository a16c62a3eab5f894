"""How finely float32 resolves ResNet-50's train-step gradients (CPU).

One Momentum(1e-3, 0.9) step of ResNet-50 at 10 classes, B=4, 64x64,
weights from `init_resnet_params(50, 10, seed, bn_stats)`, run three
ways on the same relu decisions (those of the port's f32 forward):

* the port in f32 (`paddle_tpu_torch.distributed.ShardedTrainStep`);
* the JAX package's `ShardedTrainStep`, its ``relu`` lowering replaced
  for the step by a multiplication with the port's masks;
* the same model in float64, in plain PyTorch (`F.batch_norm` in train
  mode, the 1x1 convs as matmuls, the relus as the port's masks).

It prints each f32 step's distance from float64 over the gradient
tensors (the largest max |Δ| / max |g64| and the largest relative
norm), and the port's distance from the JAX step.  Then it scales the
weights by 1 + 1e-7·N(0, 1), runs float64 again with its own relus, and
prints how many of float64's own relu decisions that flipped and how
far its gradients moved.  Last, the loss of the same step with
``amp="bf16"`` in each package, against the f32 loss.
`tests/test_torch_resnet_train.py` sets its limits from these, and
imports the relu recorders and the float64 run from here.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/resnet_grad_resolution.py
"""

import argparse
import contextlib

import numpy as np
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from paddle_tpu import distributed as jax_dist
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph, layers
from paddle_tpu.fluid import optimizer as jax_opt
from paddle_tpu.fluid.core.registry import get_op_def
from paddle_tpu_torch import distributed, models, ops, optimizer
from paddle_tpu_torch.ops import nn_ops

LR, MU, CLASSES = 1e-3, 0.9, 10


@contextlib.contextmanager
def relus(force=None):
    """The port's relus: record each `Tensor.relu_`'s mask (x > 0, NCHW)
    in call order, or, given ``force``, multiply by those masks instead,
    so that two runs take the same branch at every relu."""
    real, masks, it = torch.Tensor.relu_, [], iter(force or ())

    def relu_(t):
        if force is not None:
            return t.mul_(next(it).to(t.dtype))
        masks.append(t > 0)
        return real(t)

    torch.Tensor.relu_ = relu_
    try:
        yield masks
    finally:
        torch.Tensor.relu_ = real


@contextlib.contextmanager
def jax_relus(force=None):
    """The JAX ``relu`` op's lowering: record its input (NHWC numpy; eager
    runs only), or multiply by the port's ``force`` masks in call order."""
    opdef = get_op_def("relu")
    real, seen, it = opdef.lower, [], iter(force or ())

    def lower(ctx, ins, attrs):
        x = ins["X"][0]
        if force is not None:
            mask = next(it).permute(0, 2, 3, 1).numpy()
            return {"Out": [x * jnp.asarray(mask, x.dtype)]}
        seen.append(np.asarray(x))
        return real(ctx, ins, attrs)

    opdef.lower = lower
    try:
        yield seen
    finally:
        opdef.lower = real


@contextlib.contextmanager
def float64_model():
    """The port's ResNet in float64: BatchNorm in train mode and the 1x1
    convs by plain PyTorch, with no f32 rounding anywhere."""
    def bn(x, w, b, mean, var, momentum=0.9, eps=1e-5, batch_stats=None):
        y = F.batch_norm(x, None, None, w.to(x.dtype), b.to(x.dtype), True,
                         0.0, eps)
        return y, mean, var

    def stats(x2d, w2d):
        y = x2d @ w2d.t()
        return y, y.mean(0), y.var(0, unbiased=False)

    old = (nn_ops.batch_norm_train, ops.conv1x1_bn_stats)
    nn_ops.batch_norm_train, ops.conv1x1_bn_stats = bn, stats
    try:
        yield
    finally:
        nn_ops.batch_norm_train, ops.conv1x1_bn_stats = old


def grads64(params, batch, noise=0.0, force=None):
    """The float64 gradients of the step's loss for ResNet-50 at
    ``params``, each weight scaled by 1 + noise·N(0, 1), on the relu
    masks ``force`` if given: ({name: gradient}, the relu masks)."""
    m = models.ResNet(50, CLASSES, device="cpu")
    sd = models.from_jax_state_dict(params)
    gen = torch.Generator().manual_seed(1)
    m.load_state_dict({k: v * (1 + noise * torch.randn(v.shape,
                                                       generator=gen))
                       for k, v in sd.items()})
    m = m.double().train()
    with float64_model(), relus(force) as masks:
        loss = F.cross_entropy(m(torch.from_numpy(batch["image"]).double()),
                               torch.from_numpy(batch["label"][:, 0]).long())
    loss.backward()
    return {n: p.grad.numpy() for n, p in m.named_parameters()}, masks


def distance(got, want):
    """(largest max |Δ| / max |want|, largest relative norm) over tensors."""
    rel = [np.abs(got[n] - w).max() / np.abs(w).max()
           for n, w in want.items()]
    nrm = [np.linalg.norm(got[n] - w) / np.linalg.norm(w)
           for n, w in want.items()]
    return max(rel), max(nrm)


def port_step(params, batch, amp=None):
    tm = models.ResNet(50, CLASSES, device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(params))
    step = distributed.ShardedTrainStep(
        tm, optimizer.MomentumOptimizer(LR, MU),
        lambda m, b: nn_ops.softmax_with_cross_entropy(
            m(b["image"]), b["label"]).mean(), amp=amp)
    state, loss = step(step.init(), batch)
    return state, float(loss)


def jax_step(params, batch, amp=None):
    with dygraph.guard():
        jm = jax_models.ResNet(50, num_classes=CLASSES)
        jm.set_state_dict(params)
        step = jax_dist.ShardedTrainStep(
            jm, jax_opt.MomentumOptimizer(learning_rate=LR, momentum=MU),
            lambda m, b: layers.mean(layers.softmax_with_cross_entropy(
                m(b["image"]), b["label"])),
            jax_dist.auto_mesh(1), zero_stage=0, amp=amp)
        state, loss = step(step.init(), batch)
    return state, float(loss)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--bn-stats", default="random",
                    choices=["random", "unit"])
    args = ap.parse_args()
    params = models.init_resnet_params(50, CLASSES, seed=args.seed,
                                       bn_stats=args.bn_stats)
    rng = np.random.RandomState(0)
    batch = {"image": rng.standard_normal((4, 3, 64, 64)).astype(np.float32),
             "label": rng.randint(0, CLASSES, (4, 1)).astype(np.int32)}

    with relus() as masks:
        ts, loss32 = port_step(params, batch)
    port = {n: st["Velocity"].double().numpy() for n, st in ts["opt"].items()}
    with jax_relus(force=masks):
        js, _ = jax_step(params, batch)
    jax_g = {n: np.asarray(st["Velocity"], np.float64) for n, st in
             js["opt"].items()}
    jax_g["fc.weight"] = jax_g["fc.weight"].T

    exact, _ = grads64(params, batch, force=masks)
    for name, g in (("port f32", port), ("JAX f32", jax_g)):
        print("%s vs float64: max %.3g, norm %.3g" % ((name,)
                                                      + distance(g, exact)))
    print("port vs JAX: max %.3g" % distance(port, {
        n: jax_g[n] for n in port})[0])
    base, masks0 = grads64(params, batch)
    moved, masks1 = grads64(params, batch, noise=1e-7)
    flips = sum(int((a != b).sum()) for a, b in zip(masks0, masks1))
    print("weights x (1 + 1e-7 N): %d of %d relu decisions flip; float64 "
          "gradients move max %.3g, norm %.3g"
          % ((flips, sum(m.numel() for m in masks)) + distance(moved, base)))
    _, port16 = port_step(params, batch, amp="bf16")
    _, jax16 = jax_step(params, batch, amp="bf16")
    print("loss: f32 %.6f, bf16 port %.6f (%+.2f%%), bf16 JAX %.6f (%+.2f%%)"
          % (loss32, port16, 100 * (port16 / loss32 - 1), jax16,
             100 * (jax16 / loss32 - 1)))


if __name__ == "__main__":
    main()
