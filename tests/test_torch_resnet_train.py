"""ResNet training in `paddle_tpu_torch` (the train-mode forward,
`ShardedTrainStep` with `MomentumOptimizer`) held against
`paddle_tpu` on the CPU, on the same numpy weights and batches.

ResNet-50 and ResNet-18 at 10 classes, B=4, 64x64 f32 images, weights
from `init_resnet_params(bn_stats="random")` loaded into both packages
(the port's through `from_jax_state_dict`), one Momentum(1e-3, 0.9) step
from zero velocity, so the step's Velocity is its gradient.

Relu decisions.  A relu whose input lies within rounding of zero takes
one branch in one framework and the other branch in the other, and at
this size a few such units move step-1 gradients by up to a fifth of
their scale (`tools/resnet_grad_resolution.py`: a 1e-7 relative change
of the weights flips 4 of a float64 run's 3.1M relu decisions and moves
its gradients by 14-19% of their scale, seeds 3 and 50).  So the JAX step
runs on the port's relu decisions: for the length of the step its
``relu`` op lowering multiplies by the masks the port's forward took, in
call order.  `test_train_forward_...` checks on the eager forward that
the two frameworks' own decisions differ only at units within 1e-3 of
their layer's scale of zero (measured: 25 of 3.1M units, each within
9e-5).

Train-mode ResNet-50 at initialization amplifies rounding: BatchNorm
over batch statistics makes each block's output more sensitive to its
input, over 16 blocks.  So the limits are set from measurements, each
with room:
* the loss 1e-4 (relative; measured 8e-6) and new parameters 1e-4 of
  their scale (1.3e-5);
* ResNet-18 gradients 1e-4 of their scale, the repo's f32 gradient
  policy (1.6e-5);
* ResNet-50 gradients 2e-3 of their scale: against float64 on the same
  relu decisions the JAX step's own f32 gradients stand 4.6-5.7e-4 of
  their scale off at the last block (the port's 2.0-2.7e-4), and the two
  5.0-5.7e-4 apart (`tools/resnet_grad_resolution.py`, seeds 3 and 50).
  So the port's gradients are also held to that float64 run of the
  step (the tool's `grads64`, on the port's relu decisions): no further
  from it than the JAX step's gradients stand, by the largest
  max |Δ| / max |g64| over the tensors;
* the eager train forward: logits 1e-3 of their scale (1.8e-4),
  running statistics 2e-4 (4e-5);
* ``amp="bf16"`` against f32, on one bottleneck block in train mode
  (kernel 11's path for conv0, conv2 and the shortcut, BN from x for
  the 3x3): the output 2e-2 and every gradient 5e-2 in relative norm,
  the repo's bf16 policy (measured 7.5e-3 and at most 1.6e-2).  The
  whole ResNet-50 bf16 step's loss stands 2.9-4.7% from the f32 step's
  in the port and 1.1-5.8% in the JAX package at this size
  (`tools/resnet_grad_resolution.py`, seeds 3 and 50), by the
  amplification above, so it is checked for its dtypes and finiteness
  only.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import distributed as jax_dist
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph, layers
from paddle_tpu.fluid import optimizer as jax_opt
from paddle_tpu_torch import distributed, models, ops, optimizer
from paddle_tpu_torch.ops import nn_ops
from tools.resnet_grad_resolution import distance, grads64, jax_relus, relus

N_CLASSES, B, HW, LR, MU = 10, 4, 64, 1e-3, 0.9
REL = {50: 2e-3, 18: 1e-4}
KINK = 1e-3   # a unit whose two frameworks' relu decisions may differ


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.standard_normal((B, 3, HW, HW)).astype(np.float32),
            "label": rng.randint(0, N_CLASSES, (B, 1)).astype(np.int32)}


def _jax_loss(m, batch):
    return layers.mean(layers.softmax_with_cross_entropy(m(batch["image"]),
                                                         batch["label"]))


def _port_loss(m, batch):
    return nn_ops.softmax_with_cross_entropy(m(batch["image"]),
                                             batch["label"]).mean()


def _port_model(depth, params, device="cpu"):
    m = models.ResNet(depth, N_CLASSES, device=device)
    m.load_state_dict(models.from_jax_state_dict(params))
    return m


def _port_step(model, amp=None, donate=True):
    return distributed.ShardedTrainStep(
        model, optimizer.MomentumOptimizer(LR, MU), _port_loss, amp=amp,
        donate=donate)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _both_steps(depth, params, batch):
    """One port step (recording its relu masks), then one JAX step on
    those masks, from the same weights: (port state, port loss, JAX
    state, JAX loss, the port model, kernel 11's calls, the relu
    masks)."""
    tm = _port_model(depth, params)
    calls = []
    real = ops.conv1x1_bn_stats

    def counting(x2d, w2d):
        calls.append(tuple(x2d.shape))
        return real(x2d, w2d)

    step = _port_step(tm)
    with relus() as masks, pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "conv1x1_bn_stats", counting)
        ts, tl = step(step.init(), batch)
    with dygraph.guard(), jax_relus(force=masks):
        jm = jax_models.ResNet(depth, num_classes=N_CLASSES)
        jm.set_state_dict(params)
        jstep = jax_dist.ShardedTrainStep(
            jm, jax_opt.MomentumOptimizer(learning_rate=LR, momentum=MU),
            _jax_loss, jax_dist.auto_mesh(1), zero_stage=0)
        js, jl = jstep(jstep.init(), batch)
        js = {"params": {k: np.asarray(v) for k, v in js["params"].items()},
              "opt": {k: {s: np.asarray(a) for s, a in st.items()}
                      for k, st in js["opt"].items()},
              "step": int(js["step"])}
    return ts, tl.item(), js, float(jl), tm, calls, masks


@pytest.fixture(scope="module")
def params():
    return {d: models.init_resnet_params(d, N_CLASSES, seed=d,
                                         bn_stats="random")
            for d in (50, 18)}


@pytest.fixture(scope="module")
def steps(params):
    batch = _batch()
    return {d: _both_steps(d, params[d], batch) for d in (50, 18)}


@pytest.mark.parametrize("depth", [50, 18])
def test_momentum_step_matches_the_jax_sharded_train_step(steps, depth):
    ts, tl, js, jl, tm, calls, _ = steps[depth]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    port = models.train_state_from_jax(tm, js)   # JAX layout -> the port's
    assert set(port["params"]) == set(ts["params"])
    assert len(ts["params"]) + len(ts["buffers"]) == len(js["params"])
    bn = [n for n in ts["params"] if "._bn." in n]
    assert len(bn) == 2 * len([m for m in tm.modules()
                               if isinstance(m, models.ConvBNLayer)])
    for name in ts["params"]:
        grad = ts["opt"][name]["Velocity"]        # from zero velocity
        assert _rel(grad, port["opt"][name]["Velocity"]) <= REL[depth], name
        assert _rel(ts["params"][name], port["params"][name]) <= 1e-4, name
        assert ts["params"][name].dtype == torch.float32
    # kernel 11's wrapper: every 1x1 stride-1 conv of ResNet-50, none of
    # ResNet-18's
    assert len(calls) == (33 if depth == 50 else 0)


def test_resnet50_gradients_no_further_from_float64_than_the_jax_steps(
        steps, params):
    ts, _, js, _, tm, _, masks = steps[50]
    exact, _ = grads64(params[50], _batch(), force=masks)
    port = {n: st["Velocity"].double().numpy()
            for n, st in ts["opt"].items()}
    ref = {n: np.asarray(st["Velocity"], np.float64) for n, st in
           models.train_state_from_jax(tm, js)["opt"].items()}
    assert set(port) == set(ref) == set(exact)
    port_err, jax_err = distance(port, exact)[0], distance(ref, exact)[0]
    assert port_err <= jax_err, (port_err, jax_err)


def test_step_carries_running_statistics_and_leaves_inputs_alone(steps,
                                                                 params):
    """The step returns the BN running statistics updated (the JAX step
    throws the op's update away, so its state still holds the initial
    ones); the model and the input state are not modified."""
    ts, _, js, _, tm, _, _ = steps[50]
    init = models.from_jax_state_dict(params[50])
    for name, buf in ts["buffers"].items():
        np.testing.assert_array_equal(js["params"][name],
                                      init[name].numpy())
        np.testing.assert_array_equal(tm.state_dict()[name].numpy(),
                                      init[name].numpy())
        assert not torch.equal(buf, init[name]), name
    step = _port_step(tm, donate=False)
    s0 = step.init()
    before = {k: v.clone() for k, v in s0["buffers"].items()}
    s1, _ = step(s0, _batch(1))
    for k, v in s0["buffers"].items():
        assert torch.equal(v, before[k])
        assert s1["buffers"][k] is not v


def test_train_forward_logits_and_running_statistics_match_jax_eager(params):
    """One eager train-mode forward of ResNet-50 in each package: the
    logits and every running statistic written back (mean 0.9 old + 0.1
    batch, the biased variance likewise), and where the two frameworks'
    relu decisions differ."""
    x = _batch(2)["image"]
    with dygraph.guard(), jax_relus() as seen:
        jm = jax_models.ResNet(50, num_classes=N_CLASSES)
        jm.set_state_dict(params[50])
        jm.train()
        want = np.asarray(jm(dygraph.to_variable(x)).numpy())
        want_sd = {k: np.asarray(v.numpy())
                   for k, v in jm.state_dict().items()}
    tm = _port_model(50, params[50]).train()
    with relus() as masks:
        got = tm(torch.from_numpy(x)).detach().numpy()
    assert _rel(got, want) <= 1e-3
    for name, buf in tm.named_buffers():
        assert _rel(buf.numpy(), want_sd[name]) <= 2e-4, name
        assert not np.array_equal(want_sd[name], params[50][name])
    assert len(seen) == len(masks) == 49
    differ = 0
    for jx, mask in zip(seen, masks):
        odd = (jx > 0) != mask.permute(0, 2, 3, 1).numpy()
        differ += int(odd.sum())
        assert np.all(np.abs(jx[odd]) <= KINK * np.abs(jx).max())
    assert differ <= 100


def test_resnet18_trains_without_the_stats_kernel_and_loss_falls(params):
    tm = _port_model(18, params[18])
    step = _port_step(tm)
    state = step.init()
    batch = _batch(3)
    ops.reset_launch_counts()
    losses = []
    for _ in range(3):
        state, loss = step(state, batch)
        losses.append(loss.item())
    assert ops.launch_counts()["conv_bn_stats"] == 0   # CPU: never
    assert losses[-1] < losses[0]
    assert state["step"] == 3


def _bottleneck_grads(dtype, masks=None):
    """One BottleneckBlock (64 -> 256 channels, a stride-1 shortcut conv)
    in train mode at B=4, 16x16, its parameters and input cast to
    ``dtype``: (output, gradients of input and parameters, relu masks)."""
    blk = models.BottleneckBlock(64, 64, shortcut=False, device="cpu")
    rng = np.random.default_rng(20)
    names, vals = [], []
    for name, p in blk.named_parameters():
        if p.dim() == 4:
            v = rng.standard_normal(p.shape) * np.sqrt(2.0 / p[0].numel())
        elif name.endswith("weight"):
            v = rng.uniform(0.5, 1.5, p.shape)
        else:
            v = rng.standard_normal(p.shape) * 0.1
        names.append(name)
        vals.append(torch.tensor(v, dtype=dtype).contiguous(
            memory_format=torch.channels_last if p.dim() == 4
            else torch.contiguous_format).requires_grad_())
    x = torch.tensor(rng.standard_normal((4, 64, 16, 16)), dtype=dtype)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    dy = torch.tensor(rng.standard_normal((4, 256, 16, 16)), dtype=dtype)
    with relus(force=masks) as seen:
        out = torch.func.functional_call(blk.train(), dict(zip(names, vals)),
                                         (x,))
    grads = torch.autograd.grad(out, [x] + vals, dy)
    return out.float(), [g.float() for g in grads], seen


def test_bf16_bottleneck_block_follows_the_f32_block():
    """The train-mode bf16 path (kernel 11's plain version rounding y to
    bf16, BN normalizing in bf16 from f32 statistics) against f32, on
    the f32 block's relu decisions."""
    o32, g32, masks = _bottleneck_grads(torch.float32)
    o16, g16, _ = _bottleneck_grads(torch.bfloat16, masks)
    assert ((o16 - o32).norm() / o32.norm()).item() <= 2e-2
    for a, b in zip(g16, g32):
        assert ((a - b).norm() / b.norm()).item() <= 5e-2


def test_bf16_amp_step_keeps_f32_masters_and_statistics(params):
    tm = _port_model(50, params[50])
    step = _port_step(tm, amp="bf16", donate=False)
    s0 = step.init()
    ops.reset_launch_counts()
    s1, loss = step(s0, _batch())
    assert np.isfinite(loss.item())
    for kind in ("params", "buffers"):
        assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
                   for v in s1[kind].values())
    assert all(torch.isfinite(st["Velocity"]).all()
               for st in s1["opt"].values())
    assert any(not torch.equal(s1["buffers"][k], v)
               for k, v in s0["buffers"].items())
