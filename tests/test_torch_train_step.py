"""`paddle_tpu_torch.optimizer` (Adam, AdamW, Momentum with and without
Nesterov) and `distributed.ShardedTrainStep` held against the JAX
package's `FunctionalOptimizer` and `ShardedTrainStep` on the CPU, on
the same numpy parameters, gradients and batches.

Tolerances: the optimizer state after 3 steps atol 1e-6 (rtol 1e-6),
the same f32 formulas evaluated in another order; the tiny BERT's f32
loss trajectory and final parameters after 3 steps atol 1e-4 (rtol
1e-4), three forward/backward passes and updates compound the
cross-framework summation error; ``amp="bf16"`` loss 2e-2, the repo's
bf16 policy (the two frameworks round bf16 at different places).
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from paddle_tpu import distributed as jax_dist
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph
from paddle_tpu.fluid import optimizer as jax_opt
from paddle_tpu_torch import distributed, models, optimizer

OPT_TOL = dict(atol=1e-6, rtol=1e-6)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
B, S, P = 4, 16, 4


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["adamw", "adam", "momentum", "nesterov"])
def test_optimizer_state_after_three_steps_matches_jax(kind):
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 3), "b": (3,), "e": (7, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    if kind == "adamw":
        ours = optimizer.AdamWOptimizer(learning_rate=0.01, weight_decay=0.1)
        theirs = jax_opt.AdamWOptimizer(learning_rate=0.01, weight_decay=0.1)
    elif kind == "adam":
        ours = optimizer.AdamOptimizer(learning_rate=0.01, epsilon=1e-6)
        theirs = jax_opt.AdamOptimizer(learning_rate=0.01, epsilon=1e-6)
    else:
        nesterov = kind == "nesterov"
        ours = optimizer.MomentumOptimizer(learning_rate=0.01, momentum=0.9,
                                           use_nesterov=nesterov)
        theirs = jax_opt.MomentumOptimizer(learning_rate=0.01, momentum=0.9,
                                           use_nesterov=nesterov)
    jf = jax_dist.train_step.FunctionalOptimizer(theirs)
    tf = distributed.FunctionalOptimizer(ours)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jf.init_state(jp), tf.init_state(tp)
    for g in grads:
        jp, js = jf.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                          js, 0.01)
        tp, ts = tf.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          ts, 0.01)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   **OPT_TOL, err_msg=k)
        for slot, want in js[k].items():
            np.testing.assert_allclose(ts[k][slot].numpy(), np.asarray(want),
                                       **OPT_TOL, err_msg=k + slot)


def test_list_op_equals_the_per_parameter_formula_bitwise():
    """`optimizer.adamw` runs over parameter lists with multi-tensor
    ops; it keeps the reference's order of operations, so it equals
    the formula evaluated one parameter at a time, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(5, 3), (7,), (64, 32)]

    def randn(s, pos=False):
        x = torch.randn(s, generator=gen)
        return x.abs() if pos else x

    p, g = [randn(s) for s in shapes], [randn(s) for s in shapes]
    m1, m2 = [randn(s, True) for s in shapes], [randn(s, True) for s in shapes]
    b1p = [torch.full((1,), 0.9 ** (i + 1)) for i in range(3)]
    b2p = [torch.full((1,), 0.999 ** (i + 1)) for i in range(3)]
    got = optimizer.adamw(p, g, 1e-3, m1, m2, b1p, b2p, coeff=0.1)
    for i in range(3):
        m1o = 0.9 * m1[i] + (1 - 0.9) * g[i]
        m2o = 0.999 * m2[i] + (1 - 0.999) * g[i] * g[i]
        lr_t = 1e-3 * torch.sqrt(1 - b2p[i]) / (1 - b1p[i])
        po = p[i] - lr_t * m1o / (torch.sqrt(m2o) + 1e-8)
        po = po - 1e-3 * 0.1 * p[i]
        want = (po, m1o, m2o, b1p[i] * 0.9, b2p[i] * 0.999)
        for w, out in zip(want, got):
            assert torch.equal(out[i], w)


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_list_op_equals_the_per_parameter_formula_bitwise(nesterov):
    """`optimizer.momentum` over parameter lists keeps the reference's
    order of operations (`optimizer_ops.py:45-51`): ``v = mu v + g``,
    then ``p - lr v`` or ``p - (g + mu v) lr``."""
    gen = torch.Generator().manual_seed(1)
    shapes = [(5, 3), (7,), (64, 32)]
    p, g, v = ([torch.randn(s, generator=gen) for s in shapes]
               for _ in range(3))
    p_out, v_out = optimizer.momentum(p, g, 0.1, v, mu=0.9,
                                      use_nesterov=nesterov)
    for i in range(3):
        vo = 0.9 * v[i] + g[i]
        po = p[i] - (g[i] + 0.9 * vo) * 0.1 if nesterov else p[i] - 0.1 * vo
        assert torch.equal(v_out[i], vo)
        assert torch.equal(p_out[i], po)


def test_functional_optimizer_slots_follow_the_optimizer():
    """Momentum carries one ``Velocity`` shaped and laid out like its
    parameter; Adam its two moments and two ``[1]`` beta powers; an
    optimizer the port lacks raises."""
    w = torch.zeros(4, 3, 2, 2).contiguous(memory_format=torch.channels_last)
    st = distributed.FunctionalOptimizer(
        optimizer.MomentumOptimizer(0.1)).init_state({"w": w})
    assert list(st["w"]) == ["Velocity"]
    assert st["w"]["Velocity"].is_contiguous(
        memory_format=torch.channels_last)
    st = distributed.FunctionalOptimizer(
        optimizer.AdamOptimizer(beta1=0.8)).init_state({"w": w})
    assert list(st["w"]) == ["Moment1", "Moment2", "Beta1Pow", "Beta2Pow"]
    assert st["w"]["Beta1Pow"].tolist() == [pytest.approx(0.8)]
    with pytest.raises(NotImplementedError, match="Momentum"):
        distributed.FunctionalOptimizer(torch.optim.SGD([w], lr=0.1))


def test_optimizer_conventions_differ_from_torch_adamw():
    """eps unscaled and beta-pows starting at beta: the first step moves
    a parameter by lr * sqrt(1 - b2^1) / (1 - b1^1) * m1 / (sqrt(m2) +
    eps), which is not `torch.optim.AdamW`'s step."""
    p = torch.tensor([1.0])
    g = torch.tensor([1e-4])
    ours = optimizer.AdamWOptimizer(learning_rate=0.1, weight_decay=0.0,
                                    epsilon=1e-3)
    f = distributed.FunctionalOptimizer(ours)
    new, _ = f.apply({"p": p}, {"p": g}, f.init_state({"p": p}), 0.1)
    m1, m2 = 0.1 * 1e-4, 0.001 * 1e-8
    lr_t = 0.1 * np.sqrt(1 - 0.999) / (1 - 0.9)
    want = 1.0 - lr_t * m1 / (np.sqrt(m2) + 1e-3)
    np.testing.assert_allclose(new["p"].item(), want, rtol=1e-6)
    ref = torch.nn.Parameter(torch.tensor([1.0]))
    opt = torch.optim.AdamW([ref], lr=0.1, eps=1e-3, weight_decay=0.0)
    ref.grad = g.clone()
    opt.step()
    assert abs(ref.item() - want) > 1e-3


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _batch(seed):
    rng = np.random.RandomState(seed)
    v = jax_models.BertConfig.tiny().vocab_size
    return {
        "input_ids": rng.randint(0, v, (B, S)).astype(np.int32),
        "token_type_ids": np.zeros((B, S), np.int32),
        "position_ids": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
        "masked_positions": np.stack([np.sort(rng.choice(S, P, replace=False))
                                      for _ in range(B)]).astype(np.int32),
        "mlm_labels": rng.randint(0, v, (B, P)).astype(np.int32),
        "mlm_weights": np.ones((B, P), np.float32),
        "nsp_labels": rng.randint(0, 2, (B, 1)).astype(np.int32),
    }


def _loss_fn(m, batch):
    logits, nsp = m(batch["input_ids"], batch["token_type_ids"],
                    batch["position_ids"],
                    masked_positions=batch["masked_positions"])
    return m.loss(logits, nsp, batch["mlm_labels"], batch["mlm_weights"],
                  batch["nsp_labels"])


def _run_both(amp, n=3):
    """n steps of each package's train step from the same weights and
    batches: (jax losses, jax final params, port losses, port params,
    the port model)."""
    batches = [_batch(i) for i in range(n)]
    with dygraph.guard():
        np.random.seed(0)
        jm = jax_models.BertForPretraining(jax_models.BertConfig.tiny())
        params = {k: np.asarray(v.numpy())
                  for k, v in jm.state_dict().items()}
        jstep = jax_dist.ShardedTrainStep(
            jm, jax_opt.AdamWOptimizer(learning_rate=1e-3, weight_decay=0.01),
            _loss_fn, jax_dist.auto_mesh(1), zero_stage=0, amp=amp)
        js = jstep.init()
        jl = []
        for b in batches:
            js, loss = jstep(js, b)
            jl.append(float(loss))
        jp = {k: np.asarray(v) for k, v in js["params"].items()}
    tm = models.BertForPretraining(models.BertConfig.tiny(), device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(params))
    tstep = distributed.ShardedTrainStep(
        tm, optimizer.AdamWOptimizer(learning_rate=1e-3, weight_decay=0.01),
        _loss_fn, mesh=None, zero_stage=0, amp=amp)
    ts = tstep.init()
    tl = []
    for b in batches:
        ts, loss = tstep(ts, b)
        tl.append(loss.item())
    assert ts["step"] == n
    return jl, jp, tl, ts["params"], tm


def test_f32_loss_trajectory_and_final_params_match_jax():
    jl, jp, tl, tp, tm = _run_both(None)
    np.testing.assert_allclose(tl, jl, **STEP_TOL)
    assert tl[-1] < tl[0]
    linear_weights = {n + ".weight" for n, m in tm.named_modules()
                      if isinstance(m, nn.Linear)}
    for name, p in tp.items():
        want = jp[name].T if name in linear_weights else jp[name]
        np.testing.assert_allclose(p.numpy(), want, **STEP_TOL,
                                   err_msg=name)
        assert p.dtype == torch.float32


def test_fused_ffn_f32_trajectory_and_final_params_match_jax(monkeypatch):
    """``PADDLE_TPU_FUSED_FFN=1`` in both packages: the port's FFN runs
    through `fused_linear` (its GEMM kernels' plain versions on the
    CPU), the reference's through its ``matmul_bias_act`` op."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_FFN", "1")
    jl, jp, tl, tp, tm = _run_both(None)
    np.testing.assert_allclose(tl, jl, **STEP_TOL)
    linear_weights = {n + ".weight" for n, m in tm.named_modules()
                      if isinstance(m, nn.Linear)}
    for name, p in tp.items():
        want = jp[name].T if name in linear_weights else jp[name]
        np.testing.assert_allclose(p.numpy(), want, **STEP_TOL,
                                   err_msg=name)


def test_bf16_amp_loss_matches_jax_at_the_bf16_policy():
    jl, _, tl, tp, _ = _run_both("bf16")
    np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in tp.values())   # masters


def test_step_leaves_the_model_alone_and_dropout_follows_seed_and_step():
    cfg = models.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.1
    tm = models.BertForPretraining(cfg, device="cpu")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    step = distributed.ShardedTrainStep(
        tm, optimizer.AdamWOptimizer(1e-3), _loss_fn, seed=5)
    s0 = step.init()
    batch = _batch(0)
    _, a = step(s0, batch)
    _, b = step(s0, batch)
    _, c = step(dict(s0, step=1), batch)
    assert a.item() == b.item() != c.item()
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k])
    assert all(m.generator is None for m in step._dropouts)
    placed = step.place_batch(batch)
    assert placed["input_ids"].dtype == torch.int32
    assert placed["mlm_weights"].dtype == torch.float32


def test_unported_train_step_options_raise():
    tm = models.BertForPretraining(models.BertConfig.tiny(), device="cpu")
    opt = optimizer.AdamWOptimizer()
    with pytest.raises(NotImplementedError, match="zero_stage"):
        distributed.ShardedTrainStep(tm, opt, _loss_fn, zero_stage=1)
    with pytest.raises(NotImplementedError, match="mesh"):
        distributed.ShardedTrainStep(tm, opt, _loss_fn, mesh=object())
    with pytest.raises(ValueError):
        distributed.ShardedTrainStep(tm, opt, _loss_fn, amp="fp16")
