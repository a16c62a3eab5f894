"""Static training in `paddle_tpu_torch.fluid` held against
`paddle_tpu.fluid` on the CPU: the 13 update ops through the static
optimizers, the BERT pretraining program and its training run.

* Each of the 13 optimizers' ``minimize`` on a small fc net builds the
  JAX program dict for dict (accumulators and learning rate included),
  and one step from the same weights gives the JAX parameters and
  accumulators within 1e-4.
* `models.bert_pretraining_program` with ``AdamWOptimizer.minimize``
  equals the traced JAX ``BertForPretraining`` + ``.loss`` + minimize,
  fused FFN on and off; three steps of the tiny config (dropout 0) from
  the same weights give JAX's losses (1e-5) and parameters (1e-4).
* A step lowers kernel 1's and kernel 5's ops once each a layer (the
  tape: no recomputation); ``save_persistables`` after step 2 and
  ``load_persistables`` into a fresh scope make step 3 bitwise the
  straight run's.
* The sampling repair: seeds 3 and 4 draw different noise at one step.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu_torch import fluid, models, ops
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.fluid import layers, unique_name
from paddle_tpu_torch.generation import sampling
from paddle_tpu_torch.models import bert_program

from torch_static_common import FEEDS, S, jax_state_unchanged

P = 4           # masked positions a row
B = 3
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


def _copy_persistables(jmain, jscope, scope):
    for v in jmain.list_vars():
        if v.persistable and jscope.has(v.name):
            scope.set(v.name, torch.from_numpy(
                np.array(jscope.find_var(v.name))))


# ---------------------------------------------------------------------------
# the 13 update ops
# ---------------------------------------------------------------------------

# optimizer -> constructor kwargs (Dpsgd without noise: torch's generators
# are not JAX's)
OPTIMIZERS = {
    "SGDOptimizer": dict(learning_rate=0.05),
    "MomentumOptimizer": dict(learning_rate=0.05, momentum=0.9,
                              use_nesterov=True),
    "AdamOptimizer": dict(learning_rate=0.01),
    "AdamWOptimizer": dict(learning_rate=0.01, weight_decay=0.1),
    "LambOptimizer": dict(learning_rate=0.01),
    "AdagradOptimizer": dict(learning_rate=0.05,
                             initial_accumulator_value=0.1),
    "AdadeltaOptimizer": dict(learning_rate=1.0),
    "RMSPropOptimizer": dict(learning_rate=0.01, momentum=0.5,
                             centered=True),
    "AdamaxOptimizer": dict(learning_rate=0.01),
    "DecayedAdagradOptimizer": dict(learning_rate=0.05),
    "FtrlOptimizer": dict(learning_rate=0.05, l1=0.01, l2=0.01),
    "LarsMomentumOptimizer": dict(learning_rate=0.05),
    "DpsgdOptimizer": dict(learning_rate=0.05, clip=1.0, batch_size=8.0,
                           sigma=0.0),
}


def _fc_net(pkg, L, opt):
    x = L.data("x", shape=[8, 4], append_batch_size=False)
    label = L.data("y", shape=[8, 1], dtype="int64", append_batch_size=False)
    h = L.fc(x, size=6, act="tanh")
    logits = L.fc(h, size=3)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    opt.minimize(loss)
    return loss


def _build(pkg, L, guard, make_opt):
    """The fc net and ``make_opt()``'s minimize, in a fresh name space
    (the JAX optimizer takes a unique name when it is made)."""
    main, startup = pkg.Program(), pkg.Program()
    with guard(), pkg.program_guard(main, startup):
        loss = _fc_net(pkg, L, make_opt())
    return main, startup, loss


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_op_step_matches_jax(name):
    kw = OPTIMIZERS[name]
    jmain, jstart, jloss = _build(
        jfluid, jlayers, jun.guard,
        lambda: getattr(jfluid.optimizer, name)(**kw))
    main, start, loss = _build(fluid, layers, unique_name.guard,
                               lambda: getattr(fluid.optimizer, name)(**kw))
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()
    op_type = getattr(topt, name).op_type
    assert [o.type for o in main.global_block.ops].count(op_type) == 4
    rs = np.random.RandomState(3)
    feed = {"x": rs.randn(8, 4).astype(np.float32),
            "y": rs.randint(0, 3, (8, 1)).astype(np.int64)}
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        _copy_persistables(jmain, jscope, scope)
        for _ in range(2):
            jl, = jexe.run(jmain, feed=feed, fetch_list=[jloss])
            tl, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    state = [v.name for v in jmain.list_vars() if v.persistable]
    assert len(state) > 4
    for n in state:
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)), **GRAD,
                                   err_msg=n)


def test_static_minimize_refuses_regularization():
    from paddle_tpu_torch import regularizer

    with pytest.raises(NotImplementedError, match=r"3 \(b\) 3"):
        _build(fluid, layers, unique_name.guard,
               lambda: fluid.optimizer.SGDOptimizer(
                   0.1, regularization=regularizer.L2Decay(1e-4)))


def test_eager_minimize_still_updates_tensors():
    """The eager path of the same class is untouched by the static one."""
    p = torch.nn.Parameter(torch.ones(3))
    (p * torch.arange(3.0)).sum().backward()
    opt = fluid.optimizer.SGDOptimizer(0.5)
    opt.minimize(None, parameter_list=[p])
    np.testing.assert_allclose(p.detach().numpy(), [1.0, 0.5, 0.0])


# ---------------------------------------------------------------------------
# BERT pretraining
# ---------------------------------------------------------------------------


def jax_bert_pretraining(lr=1e-3):
    """The JAX ``BertForPretraining`` (tiny) with masked positions, its
    loss and ``AdamWOptimizer(lr).minimize``, traced in static mode in
    fresh guards: ``(main, startup, loss)``."""
    cfg = jax_models.BertConfig.tiny()
    main, startup = jfluid.Program(), jfluid.Program()
    with jun.guard(), jfluid.program_guard(main, startup):
        feeds = [jfluid.data(n, [-1, S], "int64") for n in FEEDS]
        pos = jfluid.data("masked_positions", [-1, P], "int64")
        labels = jfluid.data("mlm_labels", [-1, P], "int64")
        weights = jfluid.data("mlm_weights", [-1, P], "float32")
        nsp = jfluid.data("nsp_labels", [-1, 1], "int64")
        model = jax_models.BertForPretraining(cfg)
        logits, nsp_logits = model(*feeds, masked_positions=pos)
        loss = model.loss(logits, nsp_logits, labels, weights, nsp)
        jfluid.optimizer.AdamWOptimizer(lr).minimize(loss)
    return main, startup, loss


def port_bert_pretraining(lr=1e-3):
    return bert_program.bert_pretraining_program(
        models.BertConfig.tiny(), S, P,
        optimizer=topt.AdamWOptimizer(lr))


def pretraining_feed(seed=0, b=B, vocab=128):
    rng = np.random.RandomState(seed)
    feed = {
        "input_ids": rng.randint(0, vocab, (b, S)).astype(np.int64),
        "token_type_ids": rng.randint(0, 2, (b, S)).astype(np.int64),
        "position_ids": np.tile(np.arange(S, dtype=np.int64), (b, 1)),
        "attention_mask": np.ones((b, S), np.int64),
        "masked_positions": np.stack([rng.choice(S - 4, P, replace=False)
                                      for _ in range(b)]).astype(np.int64),
        "mlm_labels": rng.randint(0, vocab, (b, P)).astype(np.int64),
        "mlm_weights": np.ones((b, P), np.float32),
        "nsp_labels": rng.randint(0, 2, (b, 1)).astype(np.int64),
    }
    feed["attention_mask"][0, S - 4:] = 0
    feed["mlm_weights"][1, P - 1] = 0.0
    return feed


@pytest.mark.parametrize("fused_ffn", [False, True])
def test_bert_pretraining_program_is_the_traced_jax_one(monkeypatch,
                                                         fused_ffn):
    monkeypatch.setenv("PADDLE_TPU_FUSED_FFN", "1" if fused_ffn else "0")
    jmain, jstart, jloss = jax_bert_pretraining()
    main, start, feeds, loss = port_bert_pretraining()
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()
    assert loss.name == jloss.name and loss.shape == ()
    assert feeds == list(FEEDS) + ["masked_positions", "mlm_labels",
                                   "mlm_weights", "nsp_labels"]
    types = [o.type for o in main.global_block.ops]
    assert types.count("adamw") == len(main.all_parameters())
    assert types.count("matmul_bias_act") == (2 if fused_ffn else 0)
    # the attention bias gets a gradient, as in the reference
    fa = [o for o in main.global_block.ops if o.type == "vjp_grad"
          and o.attrs["fwd_type"] == "flash_attention"]
    assert len(fa) == 2 and all(o.attrs["grad_in_slots"] ==
                                ["Q", "K", "V", "Bias"] for o in fa)


def _train_both(steps, feed_seeds, fused_ffn, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_FFN", "1" if fused_ffn else "0")
    jmain, jstart, jloss = jax_bert_pretraining()
    main, start, _, loss = port_bert_pretraining()
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jl, tl = [], []
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        # unit LayerNorm scales and zero biases carry no signal: perturb
        # every parameter so the comparison sees them
        rng = np.random.RandomState(9)
        for p in jmain.all_parameters():
            v = np.asarray(jscope.find_var(p.name))
            jscope.set(p.name, (v + 0.05 * rng.standard_normal(v.shape))
                       .astype(np.float32))
        _copy_persistables(jmain, jscope, scope)
        for i in range(steps):
            feed = pretraining_feed(feed_seeds[i % len(feed_seeds)])
            jl.append(float(jexe.run(jmain, feed=feed,
                                     fetch_list=[jloss])[0]))
            tl.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
    return jl, tl, jmain, jscope, main, scope


@pytest.mark.parametrize("fused_ffn", [False, True])
def test_three_steps_of_tiny_bert_match_jax(monkeypatch, fused_ffn):
    jl, tl, jmain, jscope, main, scope = _train_both(3, [0, 1], fused_ffn,
                                                     monkeypatch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    assert tl[2] < tl[0]
    for v in jmain.list_vars():
        if v.persistable and jscope.has(v.name):
            np.testing.assert_allclose(scope.find_var(v.name).numpy(),
                                       np.asarray(jscope.find_var(v.name)),
                                       **GRAD, err_msg=v.name)


class _Spy:
    """Counts the calls of kernel 1's and kernel 5's wrappers (the static
    ops reach them through their modules)."""

    def __init__(self, monkeypatch):
        self.calls = {"flash": 0, "mba": 0}
        sdpa = ops.attention.scaled_dot_product_attention
        mba = ops.matmul.matmul_bias_act

        def count_sdpa(*a, **kw):
            self.calls["flash"] += 1
            return sdpa(*a, **kw)

        def count_mba(*a, **kw):
            self.calls["mba"] += 1
            return mba(*a, **kw)

        monkeypatch.setattr(ops.attention, "scaled_dot_product_attention",
                            count_sdpa)
        monkeypatch.setattr(ops.matmul, "matmul_bias_act", count_mba)


def test_a_step_lowers_each_kernel_op_once(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_FFN", "1")
    main, start, _, loss = port_bert_pretraining()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(start, scope=scope)
    spy = _Spy(monkeypatch)
    for step in range(2):
        exe.run(main, feed=pretraining_feed(step), fetch_list=[loss],
                scope=scope)
    layers_n = models.BertConfig.tiny().num_hidden_layers
    assert spy.calls == {"flash": 2 * layers_n, "mba": 2 * layers_n}


def test_resume_from_saved_persistables_is_bitwise(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FUSED_FFN", raising=False)
    main, start, _, loss = port_bert_pretraining()
    feeds = [pretraining_feed(s) for s in range(3)]

    def straight():
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        start.random_seed = 11
        exe.run(start, scope=scope)
        return exe, scope

    exe, want_scope = straight()
    want = [exe.run(main, feed=f, fetch_list=[loss], scope=want_scope)[0]
            for f in feeds]
    exe, scope = straight()
    for f in feeds[:2]:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, str(tmp_path), main)
    fresh = fluid.Scope()
    exe2 = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fresh):
        fluid.io.load_persistables(exe2, str(tmp_path), main)
    got, = exe2.run(main, feed=feeds[2], fetch_list=[loss], scope=fresh)
    assert got.tobytes() == want[2].tobytes()
    state = [v.name for v in main.list_vars() if v.persistable]
    assert "learning_rate_0" in state and \
        "embedding.w_0_beta1_pow_acc_0" in state
    for n in state:
        assert torch.equal(fresh.find_var(n), want_scope.find_var(n)), n


def test_bert_pretraining_clone_for_test_serves_the_training_forward(
        monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FUSED_FFN", raising=False)
    main, start, _, loss = port_bert_pretraining()
    test_prog = main.clone(for_test=True)
    assert not {"vjp_grad", "adamw", "sum", "assign", "dropout_grad"} & {
        o.type for o in test_prog.global_block.ops}
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(start, scope=scope)
    feed = pretraining_feed(4)
    served, = exe.run(test_prog, feed=feed, fetch_list=[loss], scope=scope)
    trained, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    np.testing.assert_allclose(served, trained, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the sampling repair (ROADMAP Queue C)
# ---------------------------------------------------------------------------


def test_stream_seeds_reach_the_noise():
    def noise(seed, step):
        return torch.rand(64, generator=sampling.stream_generator(seed, step))

    assert not torch.equal(noise(3, 0), noise(4, 0))
    assert not torch.equal(noise(3, 0), noise(3, 1))
    assert torch.equal(noise(3, 5), noise(3, 5))
    # two requests at the same steps over uniform logits: the seeds
    # alone tell their tokens apart
    logits = torch.zeros(2, 50)
    draws = [sampling.sample_tokens(logits, [3, 4], [s, s], [1.0] * 2,
                                    [0, 0], [1.0] * 2).tolist()
             for s in range(8)]
    assert sum(x != y for x, y in draws) >= 4
