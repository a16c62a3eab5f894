"""`distributed.ShardedTrainStep`'s knobs (``remat``, ``accumulate_steps``,
``donate``), its SGD and LAMB adapters and ``cost_analysis``, held
against the JAX package's `ShardedTrainStep` on the CPU and against
themselves.

Tolerances: the tiny BERT's f32 loss trajectory and final parameters
after 3 steps atol 1e-4 (rtol 1e-4), as `tests/test_torch_train_step.py`
(three forward/backward passes and updates compound the cross-framework
summation error).  Within the port, runs that must take the same
arithmetic are held bitwise (losses, donation) or at 1e-6 (parameters
after the recompute, which reruns the same ops).  FLOP counts are
integers and held exactly.
"""

import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu import distributed as jax_dist
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph
from paddle_tpu.fluid import optimizer as jax_opt
from paddle_tpu_torch import distributed, models, ops, optimizer
from paddle_tpu_torch.ops import nn_ops

STEP_TOL = dict(atol=1e-4, rtol=1e-4)
B, S, P = 4, 16, 4


def _batch(seed, unequal=False):
    rng = np.random.RandomState(seed)
    v = jax_models.BertConfig.tiny().vocab_size
    w = np.ones((B, P), np.float32)
    if unequal:
        # micro-batch 1 (rows 2-3 at k=2) weighs 4 masked tokens against
        # micro-batch 0's 8: the mean of the two ratios is not the ratio
        # of the sums
        w[B // 2:, : P // 2] = 0.0
    return {
        "input_ids": rng.randint(0, v, (B, S)).astype(np.int32),
        "token_type_ids": np.zeros((B, S), np.int32),
        "position_ids": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
        "masked_positions": np.stack([np.sort(rng.choice(S, P, replace=False))
                                      for _ in range(B)]).astype(np.int32),
        "mlm_labels": rng.randint(0, v, (B, P)).astype(np.int32),
        "mlm_weights": w,
        "nsp_labels": rng.randint(0, 2, (B, 1)).astype(np.int32),
    }


def _loss_fn(m, batch):
    logits, nsp = m(batch["input_ids"], batch["token_type_ids"],
                    batch["position_ids"],
                    masked_positions=batch["masked_positions"])
    return m.loss(logits, nsp, batch["mlm_labels"], batch["mlm_weights"],
                  batch["nsp_labels"])


_OPTS = {
    "adamw": lambda mod: mod.AdamWOptimizer(learning_rate=1e-3,
                                            weight_decay=0.01),
    "lamb": lambda mod: mod.LambOptimizer(learning_rate=1e-3,
                                          lamb_weight_decay=0.01),
    "sgd": lambda mod: mod.SGDOptimizer(learning_rate=0.5),
}


def _jax_params():
    with dygraph.guard():
        np.random.seed(0)
        jm = jax_models.BertForPretraining(jax_models.BertConfig.tiny())
        return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _run_jax(params, opt, batches, **knobs):
    """(losses, final params, XLA's flops of the step)."""
    with dygraph.guard():
        jm = jax_models.BertForPretraining(jax_models.BertConfig.tiny())
        jm.set_state_dict(params)
        jstep = jax_dist.ShardedTrainStep(
            jm, _OPTS[opt](jax_opt), _loss_fn, jax_dist.auto_mesh(1),
            zero_stage=0, **knobs)
        js = jstep.init()
        losses = []
        for b in batches:
            js, loss = jstep(js, b)
            losses.append(float(loss))
        cost = jstep.cost_analysis(js, batches[0])
        return (losses, {k: np.asarray(v) for k, v in js["params"].items()},
                cost)


def _port_model(params, cfg=None):
    tm = models.BertForPretraining(cfg or models.BertConfig.tiny(),
                                   device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(params))
    return tm


def _run_port(params, opt, batches, **knobs):
    tm = _port_model(params)
    step = distributed.ShardedTrainStep(tm, _OPTS[opt](optimizer), _loss_fn,
                                        **knobs)
    state = step.init()
    losses = []
    for b in batches:
        state, loss = step(state, b)
        losses.append(loss.item())
    return losses, state, tm, step


def _assert_params_match(tp, jp, tm):
    linear_weights = {n + ".weight" for n, m in tm.named_modules()
                      if isinstance(m, nn.Linear)}
    for name, p in tp.items():
        want = jp[name].T if name in linear_weights else jp[name]
        np.testing.assert_allclose(p.numpy(), want, **STEP_TOL, err_msg=name)


@pytest.fixture(scope="module")
def jax_params():
    return _jax_params()


# ---------------------------------------------------------------------------
# against JAX's ShardedTrainStep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt, knobs, unequal", [
    ("adamw", dict(remat=True), False),
    ("adamw", dict(accumulate_steps=2), False),
    ("adamw", dict(accumulate_steps=2), True),
    ("lamb", dict(), False),
    ("sgd", dict(), False),
    ("lamb", dict(remat=True, accumulate_steps=2), True),
], ids=["remat", "accumulate", "accumulate-unequal-weights", "lamb", "sgd",
        "lamb-remat-accumulate"])
def test_three_steps_match_jax(jax_params, opt, knobs, unequal):
    batches = [_batch(i, unequal) for i in range(3)]
    jl, jp, _ = _run_jax(jax_params, opt, batches, **knobs)
    tl, state, tm, _ = _run_port(jax_params, opt, batches, **knobs)
    np.testing.assert_allclose(tl, jl, **STEP_TOL)
    _assert_params_match(state["params"], jp, tm)
    assert state["step"] == 3
    if opt != "sgd":
        assert tl[-1] < tl[0]


def test_unequal_micro_batch_weights_take_the_mean_of_ratios(jax_params):
    """At k = 2 the MLM loss is the mean of the two micro-batches' ratios,
    which differs from the one ratio of k = 1 when their weight sums
    differ (the reference's convention, `train_step.py:212-221`)."""
    b = [_batch(0, unequal=True)]
    one, _, _, _ = _run_port(jax_params, "adamw", b)
    two, _, _, _ = _run_port(jax_params, "adamw", b, accumulate_steps=2)
    port = _port_model(jax_params)
    halves = [{k: torch.from_numpy(v[i * 2:(i + 1) * 2])
               for k, v in b[0].items()} for i in range(2)]
    with torch.no_grad():
        mean_of_ratios = sum(_loss_fn(port, h).item() for h in halves) / 2
    assert abs(one[0] - two[0]) > 1e-3
    assert two[0] == pytest.approx(mean_of_ratios, abs=1e-6)


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


def test_indivisible_batch_raises(jax_params):
    tm = _port_model(jax_params)
    step = distributed.ShardedTrainStep(tm, _OPTS["adamw"](optimizer),
                                        _loss_fn, accumulate_steps=3)
    with pytest.raises(ValueError, match="accumulate_steps=3 does not "
                                         "divide batch dim"):
        step(step.init(), _batch(0))
    with pytest.raises(ValueError, match=">= 1"):
        distributed.ShardedTrainStep(tm, _OPTS["adamw"](optimizer),
                                     _loss_fn, accumulate_steps=0)


def test_remat_draws_the_same_dropout_masks():
    """Dropout 0.1: the recompute restores the step's generator, so the
    losses are bitwise equal and the new parameters and moments agree."""
    cfg = models.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.1
    tm = models.BertForPretraining(cfg, device="cpu")
    out = {}
    for remat in (False, True):
        step = distributed.ShardedTrainStep(
            tm, _OPTS["lamb"](optimizer), _loss_fn, remat=remat, seed=3)
        state = step.init()
        losses = []
        for i in range(2):
            state, loss = step(state, _batch(i))
            losses.append(loss)
        out[remat] = (losses, state)
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b)
    for kind in ("params", "opt"):
        flat = {k: v for k, v in out[False][1][kind].items()}
        for name, v in flat.items():
            other = out[True][1][kind][name]
            pairs = v.items() if isinstance(v, dict) else [(None, v)]
            for slot, t in pairs:
                u = other if slot is None else other[slot]
                torch.testing.assert_close(u, t, atol=1e-6, rtol=0)
    # the masks are live: another step's stream moves the loss
    step = distributed.ShardedTrainStep(tm, _OPTS["lamb"](optimizer),
                                        _loss_fn, remat=True, seed=3)
    _, other = step(dict(step.init(), step=1), _batch(0))
    assert not torch.equal(other, out[True][0][0])


def test_the_seed_reaches_cpu_dropout_masks():
    """A CPU generator keeps only the low 32 bits of its seed: the step's
    seed, step and micro-batch index must all reach them.  Seeds 3 and 4
    draw different keep masks and losses; one seed draws the same twice
    (``accumulate_steps=1`` stays deterministic)."""
    from paddle_tpu_torch.distributed.train_step import _step_generator

    def mask(*args, **kw):
        g = _step_generator(*args, torch.device("cpu"), **kw)
        return torch.rand(64, 64, generator=g) < 0.9

    assert not torch.equal(mask(3, 0), mask(4, 0))
    assert not torch.equal(mask(3, 0), mask(3, 1))
    assert not torch.equal(mask(3, 0, micro=0), mask(3, 0, micro=1))
    assert not torch.equal(mask(3, 0), mask(3, 0, micro=0))
    assert torch.equal(mask(3, 5), mask(3, 5))
    cfg = models.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.1
    tm = models.BertForPretraining(cfg, device="cpu")
    losses = {}
    for seed in (3, 4, 3):
        step = distributed.ShardedTrainStep(
            tm, _OPTS["sgd"](optimizer), _loss_fn, seed=seed, donate=False)
        _, loss = step(step.init(), _batch(0))
        losses.setdefault(seed, []).append(loss)
    assert not torch.equal(losses[3][0], losses[4][0])
    assert torch.equal(losses[3][0], losses[3][1])


def _resnet_batch(seed):
    rng = np.random.RandomState(seed)
    return {"image": rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int32)}


def _resnet_loss(m, batch):
    return nn_ops.softmax_with_cross_entropy(m(batch["image"]),
                                             batch["label"]).mean()


@pytest.mark.parametrize("knobs", [dict(remat=True),
                                   dict(remat=True, accumulate_steps=2)],
                         ids=["remat", "remat-accumulate"])
def test_resnet18_remat_updates_running_statistics_once(knobs):
    params = models.init_resnet_params(18, 10, seed=5, bn_stats="random")
    out = {}
    for remat in (False, True):
        kw = dict(knobs, remat=remat)
        tm = models.ResNet(18, 10, device="cpu")
        tm.load_state_dict(models.from_jax_state_dict(params))
        step = distributed.ShardedTrainStep(
            tm, optimizer.MomentumOptimizer(0.01, 0.9), _resnet_loss, **kw)
        state, loss = step(step.init(), _resnet_batch(0))
        out[remat] = (loss, state)
    init = models.from_jax_state_dict(params)
    assert torch.equal(out[False][0], out[True][0])
    for name, buf in out[True][1]["buffers"].items():
        assert torch.equal(buf, out[False][1]["buffers"][name]), name
        assert not torch.equal(buf, init[name]), name


def test_accumulation_carries_buffers_through_the_micro_batches():
    """k = 2 updates the running statistics twice, micro-batch 0's first:
    the same as two eager train forwards over the halves."""
    params = models.init_resnet_params(18, 10, seed=6, bn_stats="random")
    tm = models.ResNet(18, 10, device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(params))
    step = distributed.ShardedTrainStep(
        tm, optimizer.MomentumOptimizer(0.01, 0.9), _resnet_loss,
        accumulate_steps=2)
    batch = _resnet_batch(1)
    state, _ = step(step.init(), batch)
    eager = models.ResNet(18, 10, device="cpu")
    eager.load_state_dict(models.from_jax_state_dict(params))
    eager.train()
    with torch.no_grad():
        for i in range(2):
            eager(torch.from_numpy(batch["image"][i * 2:(i + 1) * 2]))
    for name, buf in eager.named_buffers():
        torch.testing.assert_close(state["buffers"][name], buf, atol=1e-6,
                                   rtol=1e-6)


def test_donation_writes_in_place_and_matches_the_copying_step(jax_params):
    cfg = models.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.1
    tm = models.BertForPretraining(cfg, device="cpu")
    batch = _batch(0)
    steps = {d: distributed.ShardedTrainStep(
        tm, _OPTS["lamb"](optimizer), _loss_fn, donate=d) for d in (0, 1)}
    s0 = steps[1].init()
    keep = {k: v.clone() for k, v in s0["params"].items()}
    kept_opt = {k: {s: v.clone() for s, v in st.items()}
                for k, st in s0["opt"].items()}
    copied, loss_c = steps[0](s0, batch)
    for k, v in s0["params"].items():         # donate=False: untouched
        assert torch.equal(v, keep[k])
        assert copied["params"][k] is not v
    donated, loss_d = steps[1](s0, batch)
    assert torch.equal(loss_c, loss_d)
    for k, v in s0["params"].items():         # the same tensors, updated
        assert donated["params"][k] is v
        assert torch.equal(v, copied["params"][k])
        assert not torch.equal(v, keep[k])
        for slot, t in s0["opt"][k].items():
            assert donated["opt"][k][slot] is t
            assert torch.equal(t, copied["opt"][k][slot])
            if slot.startswith("Moment"):
                assert not torch.equal(t, kept_opt[k][slot])
    assert donated["step"] == copied["step"] == 1


def test_functional_optimizer_raises_for_the_eight_minimize_optimizers():
    others = [optimizer.LarsMomentumOptimizer(0.1),
              optimizer.AdagradOptimizer(0.1),
              optimizer.AdamaxOptimizer(),
              optimizer.DecayedAdagradOptimizer(0.1),
              optimizer.AdadeltaOptimizer(0.1),
              optimizer.RMSPropOptimizer(0.1),
              optimizer.FtrlOptimizer(0.1),
              optimizer.DpsgdOptimizer(0.1)]
    for opt in others:
        with pytest.raises(NotImplementedError, match="minimize"):
            distributed.FunctionalOptimizer(opt)
    for opt in (optimizer.SGDOptimizer(0.1),
                optimizer.MomentumOptimizer(0.1, momentum=0.9),
                optimizer.AdamOptimizer(), optimizer.AdamWOptimizer(),
                optimizer.LambOptimizer()):
        distributed.FunctionalOptimizer(opt)


def test_reference_signature_is_accepted_and_multi_gpu_knobs_raise(
        jax_params):
    tm = _port_model(jax_params)
    opt = _OPTS["sgd"](optimizer)
    step = distributed.ShardedTrainStep(
        tm, opt, _loss_fn, None, None, None, 0, False, True, None, "rbg", 2,
        None)
    assert (step.donate, step.remat, step.accumulate_steps,
            step.prng_impl) == (False, True, 2, "rbg")
    for kw in (dict(param_rule=object()), dict(batch_specs={"x": (None,)}),
               dict(gather_chunk_bytes=1 << 20)):
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            distributed.ShardedTrainStep(tm, opt, _loss_fn, **kw)


# ---------------------------------------------------------------------------
# cost_analysis
# ---------------------------------------------------------------------------


def _forward_flops(cfg, b, s, p):
    """Matmul FLOPs of one tiny-BERT forward of ``_loss_fn``: per layer
    the QKV, output and FFN projections and attention (torch's SDPA
    formula, 4 B H S S Dh), then the pooler, the MLM transform and tied
    decoder on the P masked rows, and the NSP head."""
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h = cfg.num_attention_heads
    tokens = b * s
    layer = (2 * tokens * d * 3 * d + 2 * tokens * d * d
             + 2 * tokens * d * f + 2 * tokens * f * d
             + 4 * b * h * s * s * (d // h))
    return (cfg.num_hidden_layers * layer + 2 * b * d * d
            + 2 * b * p * d * d + 2 * b * p * d * v + 2 * b * d * 2)


def test_cost_analysis_counts_forward_and_backward(jax_params):
    cfg = models.BertConfig.tiny()
    fwd = _forward_flops(cfg, B, S, P)
    batch = _batch(0)
    tm = _port_model(jax_params)
    step = distributed.ShardedTrainStep(tm, _OPTS["adamw"](optimizer),
                                        _loss_fn)
    state = step.init()
    assert step.cost_analysis(state, batch) is None
    state, _ = step(state, batch)
    base = step.cost_analysis(state, batch)["flops"]
    # every matmul has both gradients (dX and dW), attention's backward
    # is twice its forward: three forwards in all
    assert base == 3 * fwd
    # numpy batch or tensors: one signature
    placed = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert step.cost_analysis(state, placed)["flops"] == base
    other = dict(batch, mlm_weights=batch["mlm_weights"].astype(np.float64))
    assert step.cost_analysis(state, other) is None
    counts = {}
    for knobs in (dict(remat=True), dict(accumulate_steps=2),
                  dict(remat=True, accumulate_steps=2)):
        s = distributed.ShardedTrainStep(tm, _OPTS["adamw"](optimizer),
                                         _loss_fn, **knobs)
        st, _ = s(s.init(), batch)
        counts[tuple(knobs.items())] = s.cost_analysis(st, batch)["flops"]
    assert counts[(("remat", True),)] == base + fwd
    assert counts[(("accumulate_steps", 2),)] == base
    assert counts[(("remat", True), ("accumulate_steps", 2))] == base + fwd


def test_cost_analysis_is_no_greater_than_xla_s(jax_params):
    """XLA's count of the same step adds the elementwise work and the
    update; the port's is the matmul-class part of it."""
    batches = [_batch(0)]
    _, _, jcost = _run_jax(jax_params, "adamw", batches)
    _, state, _, step = _run_port(jax_params, "adamw", batches)
    ours = step.cost_analysis(state, batches[0])["flops"]
    assert jcost is not None and jcost["flops"] > 0
    assert 0 < ours <= jcost["flops"]


def test_kernel_wrappers_count_their_own_work_once():
    """A counted wrapper adds its formula and hides the aten ops of its
    plain version: the flash forward is 4 B H Sq Sk D however the plain
    einsums compute it, and a nested counted call adds nothing."""
    from paddle_tpu_torch.observability.cost import FlopCounter

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, 4, 16, generator=gen) for _ in range(3))
    with FlopCounter() as c:
        ops.flash_fwd(q, k, v, layout="BSHD")
    assert c.flops == 4 * 2 * 4 * 8 * 8 * 16
    q.requires_grad_()
    with FlopCounter() as c:
        ops.flash_attention(q, k, v, layout="BSHD").sum().backward()
    assert c.flops == (4 + 8) * 2 * 4 * 8 * 8 * 16
    x = torch.randn(6, 8, generator=gen, requires_grad=True)
    w = torch.randn(5, 8, generator=gen, requires_grad=True)
    with FlopCounter() as c:
        ops.matmul_bias_act(x, w, activation="relu").sum().backward()
    assert c.flops == 3 * 2 * 6 * 8 * 5
    with FlopCounter() as c:
        torch.matmul(x, w.t())
    assert c.flops == 2 * 6 * 8 * 5
