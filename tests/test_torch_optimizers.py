"""The eager optimizer library of `paddle_tpu_torch` (the 13 update ops,
the optimizers' ``minimize`` with regularization and gradient clipping,
and the nine learning-rate schedulers) held against the JAX package on
the CPU, on the same numpy parameters, gradients and batches.

Tolerances: each op after 3 steps atol/rtol 1e-6 (the same f32 formulas
in the reference's order; norms and powers reduced in another order);
the eager tiny-BERT loop's losses and parameters after 3 steps atol/rtol
1e-4, as `tests/test_torch_train_step.py` (three forward/backward
passes and updates compound the cross-framework summation error); the
schedulers exactly (the same pure-Python arithmetic).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu import models as jax_models
from paddle_tpu.fluid import clip as jax_clip
from paddle_tpu.fluid import dygraph
from paddle_tpu.fluid import optimizer as jax_opt
from paddle_tpu.fluid import regularizer as jax_reg
from paddle_tpu.fluid.core.registry import LowerContext, get_op_def
from paddle_tpu.fluid.dygraph import learning_rate_scheduler as jax_lrs
from paddle_tpu.fluid.dygraph import to_variable
from paddle_tpu_torch import clip, learning_rate_scheduler, models, optimizer
from paddle_tpu_torch import regularizer

OP_TOL = dict(atol=1e-6, rtol=1e-6)
LOOP_TOL = dict(atol=1e-4, rtol=1e-4)
SHAPES = {"w": (5, 3), "b": (3,), "e": (7, 2), "z": (4,)}
LR = 0.01

# op -> (port in-place op, [(slot, JAX output slot, init)], attrs); init
# "zeros", "pos" (|N(0, 1)|), "randn", or a number filling a [1] scalar
_OPS = {
    "sgd": (optimizer.sgd_, [], {}),
    "momentum": (optimizer.momentum_, [("Velocity", "VelocityOut", "randn")],
                 {"mu": 0.9, "use_nesterov": True}),
    "adam": (optimizer.adam_, [
        ("Moment1", "Moment1Out", "randn"), ("Moment2", "Moment2Out", "pos"),
        ("Beta1Pow", "Beta1PowOut", 0.9 ** 2),
        ("Beta2Pow", "Beta2PowOut", 0.999 ** 2)],
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adamw": (optimizer.adamw_, [
        ("Moment1", "Moment1Out", "randn"), ("Moment2", "Moment2Out", "pos"),
        ("Beta1Pow", "Beta1PowOut", 0.9), ("Beta2Pow", "Beta2PowOut", 0.999)],
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "coeff": 0.1}),
    "lamb": (optimizer.lamb_, [
        ("Moment1", "Moment1Out", "randn"), ("Moment2", "Moment2Out", "pos"),
        ("Beta1Pow", "Beta1PowOut", 0.9), ("Beta2Pow", "Beta2PowOut", 0.999)],
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
         "weight_decay": 0.01}),
    "adagrad": (optimizer.adagrad_, [("Moment", "MomentOut", "pos")],
                {"epsilon": 1e-6}),
    "adadelta": (optimizer.adadelta_, [
        ("AvgSquaredGrad", "AvgSquaredGradOut", "pos"),
        ("AvgSquaredUpdate", "AvgSquaredUpdateOut", "pos")],
        {"rho": 0.95, "epsilon": 1e-6}),
    "rmsprop": (optimizer.rmsprop_, [
        ("Moment", "MomentOut", "randn"), ("MeanSquare", "MeanSquareOut",
                                           "pos"),
        ("MeanGrad", "MeanGradOut", "zeros")],
        {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.9, "centered": True}),
    "adamax": (optimizer.adamax_, [
        ("Moment", "MomentOut", "randn"), ("InfNorm", "InfNormOut", "pos"),
        ("Beta1Pow", None, 0.9)],
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "decayed_adagrad": (optimizer.decayed_adagrad_,
                        [("Moment", "MomentOut", "pos")],
                        {"decay": 0.95, "epsilon": 1e-6}),
    "ftrl": (optimizer.ftrl_, [
        ("SquaredAccumulator", "SquaredAccumOut", "pos"),
        ("LinearAccumulator", "LinearAccumOut", "randn")],
        {"l1": 0.05, "l2": 0.01, "lr_power": -0.5}),
    "lars_momentum": (optimizer.lars_momentum_,
                      [("Velocity", "VelocityOut", "randn")],
                      {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005, "epsilon": 0.0}),
    "dpsgd": (optimizer.dpsgd_, [],
              {"clip": 1.0, "batch_size": 4.0, "sigma": 0.0}),
}


def _init(rng, spec, shape):
    if spec == "zeros":
        return np.zeros(shape, np.float32)
    if spec == "pos":
        return np.abs(rng.standard_normal(shape)).astype(np.float32)
    if spec == "randn":
        return rng.standard_normal(shape).astype(np.float32)
    return np.full((1,), spec, np.float32)


def _jax_steps(name, params, grads, state, lr, rng_key=None):
    _, slots, attrs = _OPS[name]
    opdef = get_op_def(name)
    ctx = LowerContext(base_key=rng_key, is_test=False)
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = {k: {s: jnp.asarray(v) for s, v in st.items()}
             for k, st in state.items()}
    for g in grads:
        for k in params:
            ins = {"Param": [params[k]], "Grad": [jnp.asarray(g[k])]}
            if name != "adadelta":       # its op takes no learning rate
                ins["LearningRate"] = [jnp.asarray([lr], jnp.float32)]
            for slot, _, _ in slots:
                ins[slot] = [state[k][slot]]
            outs = opdef.lower(ctx, ins, attrs)
            params[k] = outs["ParamOut"][0]
            for slot, out, _ in slots:
                if out is not None:
                    state[k][slot] = outs[out][0]
            if name == "adamax":         # the optimizer's _finish_update
                state[k]["Beta1Pow"] = state[k]["Beta1Pow"] * attrs["beta1"]
    return params, state


def _port_steps(name, params, grads, state, lr, **extra):
    op, slots, attrs = _OPS[name]
    names = list(params)
    p = [torch.from_numpy(params[k].copy()) for k in names]
    st = [[torch.from_numpy(state[k][s].copy()) for k in names]
          for s, _, _ in slots]
    for g in grads:
        op(p, [torch.from_numpy(g[k]) for k in names], lr, *st, **attrs,
           **extra)
        if name == "adamax":
            torch._foreach_mul_(st[2], attrs["beta1"])
    return ({k: x for k, x in zip(names, p)},
            {k: {s: st[i][j] for i, (s, _, _) in enumerate(slots)}
             for j, k in enumerate(names)})


def _problem(name, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    params["z"][:] = 0.0     # a zero tensor: LAMB's and LARS's ratio is 1
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    _, slots, _ = _OPS[name]
    state = {k: {s: _init(rng, spec, shape) for s, _, spec in slots}
             for k, shape in SHAPES.items()}
    return params, grads, state


@pytest.mark.parametrize("name", sorted(_OPS))
def test_update_op_matches_the_jax_lowering_over_three_steps(name):
    params, grads, state = _problem(name)
    jp, js = _jax_steps(name, params, grads, state, LR,
                        jax.random.key(0) if name == "dpsgd" else None)
    gen = torch.Generator().manual_seed(0)
    extra = {"generator": gen} if name == "dpsgd" else {}
    tp, ts = _port_steps(name, params, grads, state, LR, **extra)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   **OP_TOL, err_msg=k)
        assert not np.array_equal(tp[k].numpy(), params[k]) or k == "z"
        for slot, want in js[k].items():
            np.testing.assert_allclose(ts[k][slot].numpy(), np.asarray(want),
                                       **OP_TOL, err_msg=k + slot)


def test_functional_ops_leave_their_inputs_alone():
    params, grads, state = _problem("lamb")
    names = list(params)
    p = [torch.from_numpy(params[k]) for k in names]
    g = [torch.from_numpy(grads[0][k]) for k in names]
    st = [[torch.from_numpy(state[k][s]) for k in names]
          for s, _, _ in _OPS["lamb"][1]]
    before = [x.clone() for x in p] + [x.clone() for s in st for x in s]
    out = optimizer.lamb(p, g, LR, *st, **_OPS["lamb"][2])
    after = p + [x for s in st for x in s]
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert len(out) == 5 and not torch.equal(out[0][0], p[0])


def test_dpsgd_noise_has_its_std_and_follows_the_seed():
    """Zero gradients: the step is ``-lr noise / batch_size``, noise
    N(0, (sigma clip)^2) from the generator; mean and std within three
    standard errors, and one seed gives one update."""
    n, lr, clip_, sigma, bs = 40000, 0.5, 2.0, 1.5, 4.0

    def run(seed):
        p = [torch.zeros(n), torch.zeros(10, 10)]
        optimizer.dpsgd_(p, [torch.zeros(n), torch.zeros(10, 10)], lr,
                         clip=clip_, batch_size=bs, sigma=sigma,
                         generator=torch.Generator().manual_seed(seed))
        return p

    a, b, c = run(7), run(7), run(8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    noise = (-a[0] * bs / lr).double()
    std = sigma * clip_
    assert abs(noise.mean().item()) <= 3 * std / math.sqrt(n)
    assert abs(noise.std().item() - std) <= 3 * std / math.sqrt(2 * n)
    opt = optimizer.DpsgdOptimizer(0.1, sigma=1.0, seed=3)
    w = nn.Parameter(torch.ones(5))
    w.grad = torch.ones(5)
    opt.minimize(None, parameter_list=[w])
    w2 = nn.Parameter(torch.ones(5))
    w2.grad = torch.ones(5)
    optimizer.DpsgdOptimizer(0.1, sigma=1.0, seed=3).minimize(
        None, parameter_list=[w2])
    assert torch.equal(w, w2)


# ---------------------------------------------------------------------------
# the eager minimize loop on tiny BERT
# ---------------------------------------------------------------------------

B, S, P = 4, 16, 4


def _batch(seed):
    rng = np.random.RandomState(seed)
    v = jax_models.BertConfig.tiny().vocab_size
    return {
        "input_ids": rng.randint(0, v, (B, S)).astype(np.int64),
        "token_type_ids": np.zeros((B, S), np.int64),
        "position_ids": np.tile(np.arange(S, dtype=np.int64), (B, 1)),
        "masked_positions": np.stack([np.sort(rng.choice(S, P, replace=False))
                                      for _ in range(B)]).astype(np.int64),
        "mlm_labels": rng.randint(0, v, (B, P)).astype(np.int64),
        "mlm_weights": np.ones((B, P), np.float32),
        "nsp_labels": rng.randint(0, 2, (B, 1)).astype(np.int64),
    }


def _loss_fn(m, batch):
    logits, nsp = m(batch["input_ids"], batch["token_type_ids"],
                    batch["position_ids"],
                    masked_positions=batch["masked_positions"])
    return m.loss(logits, nsp, batch["mlm_labels"], batch["mlm_weights"],
                  batch["nsp_labels"])


@pytest.fixture(scope="module")
def bert_params():
    with dygraph.guard():
        np.random.seed(1)
        jm = jax_models.BertForPretraining(jax_models.BertConfig.tiny())
        return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


# name -> (constructor keyword arguments, learning rate values)
_LOOP = {
    "Lamb": (dict(lamb_weight_decay=0.01), (1e-2, 1e-3)),
    "LarsMomentum": (dict(momentum=0.9, lars_coeff=0.01,
                          lars_weight_decay=5e-4), (1.0, 0.1)),
    "RMSProp": (dict(rho=0.9, momentum=0.9, centered=True), (1e-3, 1e-4)),
    "Adagrad": (dict(initial_accumulator_value=0.1), (1e-2, 1e-3)),
    # the key third of each qkv bias has an exact gradient of 0 (softmax
    # is shift-invariant), so each framework computes rounding noise
    # there (~1e-9), which Adamax's default eps 1e-8 would turn into
    # steps of +-lr; at 1e-6 they stay below 1e-3 lr.  The op test holds
    # the default eps.
    "Adamax": (dict(epsilon=1e-6), (1e-2, 1e-3)),
    "Ftrl": (dict(l1=1e-4, l2=1e-3), (1e-2, 1e-3)),
}


class _KeepClipVars:
    """Keep the JAX clips' intermediate vars alive for the length of a
    block.  `paddle_tpu.fluid.clip.GradientClipByGlobalNorm` keeps only
    the names of its per-gradient squared norms, and the dygraph
    tracer's weak var table (`tracer.py:50`) can drop them before its
    ``sum`` op reads them (a reference fault, ROADMAP Queue C).  Holding
    a reference changes none of its arithmetic."""

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        self.kept = []
        real = jax_clip._new_var_like

        def keep(*args, **kw):
            var = real(*args, **kw)
            self.kept.append(var)
            return var

        self.mp.setattr(jax_clip, "_new_var_like", keep)
        return self

    def __exit__(self, *exc):
        self.mp.undo()
        self.kept.clear()
        return False


def _eager(pkg, name, kw, lrs, reg, clip_, params, batches, per_param=None):
    """3 eager steps of tiny BERT: (losses, state dict, the model)."""
    (opt_mod, reg_mod, clip_mod, lrs_mod) = pkg
    optim = getattr(opt_mod, name + "Optimizer")(
        learning_rate=lrs_mod.PiecewiseDecay([2], list(lrs)),
        regularization=reg(reg_mod), grad_clip=clip_(clip_mod), **kw)
    losses = []
    if opt_mod is jax_opt:
        with dygraph.guard(), _KeepClipVars():
            m = jax_models.BertForPretraining(jax_models.BertConfig.tiny())
            m.set_state_dict(params)
            if per_param:
                per_param(m.state_dict(), reg_mod)
            for b in batches:
                loss = _loss_fn(m, {k: to_variable(v) for k, v in b.items()})
                loss.backward()
                optim.minimize(loss, parameter_list=m.parameters())
                m.clear_gradients()
                losses.append(float(loss.numpy()))
            return losses, {k: np.asarray(v.numpy())
                            for k, v in m.state_dict().items()}, None
    m = models.BertForPretraining(models.BertConfig.tiny(), device="cpu")
    m.load_state_dict(models.from_jax_state_dict(params))
    if per_param:
        per_param(dict(m.named_parameters()), reg_mod)
    for b in batches:
        loss = _loss_fn(m, {k: torch.from_numpy(v) for k, v in b.items()})
        loss.backward()
        optim.minimize(loss, parameter_list=m.parameters())
        m.zero_grad(set_to_none=True)
        losses.append(loss.item())
    return losses, {k: v.detach().numpy() for k, v in
                    m.state_dict().items()}, m


JAX = (jax_opt, jax_reg, jax_clip, jax_lrs)
PORT = (optimizer, regularizer, clip, learning_rate_scheduler)


def _compare(jax_run, port_run):
    jl, jsd, _ = jax_run
    tl, tsd, tm = port_run
    np.testing.assert_allclose(tl, jl, **LOOP_TOL)
    linear = {n + ".weight" for n, m in tm.named_modules()
              if isinstance(m, nn.Linear)}
    for name, v in tsd.items():
        want = jsd[name].T if name in linear else jsd[name]
        np.testing.assert_allclose(v, want, **LOOP_TOL, err_msg=name)


def _l2(mod):
    return mod.L2Decay(1e-2)


def _global(mod):
    return mod.GradientClipByGlobalNorm(1.0)


@pytest.mark.parametrize("name", sorted(_LOOP))
def test_eager_minimize_loop_matches_jax_dygraph(name, bert_params):
    kw, lrs = _LOOP[name]
    batches = [_batch(i) for i in range(3)]
    args = (name, kw, lrs, _l2, _global, bert_params, batches)
    jax_run, port_run = _eager(JAX, *args), _eager(PORT, *args)
    _compare(jax_run, port_run)
    # the step moved the weights
    moved = max(np.abs(port_run[1][k] - v.numpy()).max()
                for k, v in models.from_jax_state_dict(bert_params).items())
    assert moved > 0


def test_clip_comes_before_regularization(bert_params):
    """A tight global-norm clip and a large L2 decay: clipping first (the
    reference's order) and regularizing first give different weights;
    the port matches JAX's."""
    batches = [_batch(0)]

    def tight(mod):
        return mod.GradientClipByGlobalNorm(0.01)

    def big(mod):
        return mod.L2Decay(0.5)

    args = ("SGD", {}, (0.5, 0.5), big, tight, bert_params, batches)
    port_run = _eager(PORT, *args)
    _compare(_eager(JAX, *args), port_run)
    # the reverse order, by hand on the port: regularize, then clip
    m = models.BertForPretraining(models.BertConfig.tiny(), device="cpu")
    m.load_state_dict(models.from_jax_state_dict(bert_params))
    _loss_fn(m, {k: torch.from_numpy(v) for k, v in batches[0].items()}
             ).backward()
    pg = [(p, p.grad) for p in m.parameters()]
    pg = tight(clip)(regularizer.append_regularization_ops(pg, big(
        regularizer)))
    with torch.no_grad():
        for p, g in pg:
            p.sub_(0.5 * g)
    gap = max(np.abs(v.detach().numpy() - port_run[1][k]).max()
              for k, v in m.state_dict().items())
    assert gap > 1e-3


def test_a_parameters_own_regularizer_wins(bert_params):
    """L1Decay on the LayerNorm weights overrides the optimizer's L2Decay
    there, in both packages."""

    def per_param(named, reg_mod):
        for name, p in named.items():
            if name.endswith("ln.weight") or ".ln1." in name:
                p.regularizer = reg_mod.L1Decay(0.2)

    batches = [_batch(i) for i in range(2)]
    args = ("Adagrad", dict(initial_accumulator_value=0.1), (1e-2, 1e-3),
            _l2, _global, bert_params, batches)
    port_run = _eager(PORT, *args, per_param=per_param)
    _compare(_eager(JAX, *args, per_param=per_param), port_run)
    plain = _eager(PORT, *args)
    name = "bert.embeddings.ln.weight"
    assert np.abs(plain[1][name] - port_run[1][name]).max() > 1e-4


def test_minimize_contract():
    """parameter_list is required; parameters without a gradient are
    skipped; ``need_clip`` False keeps a gradient out of the clip; the
    learning rate is read once per minimize."""
    opt = optimizer.SGDOptimizer(learning_rate=1.0,
                                 grad_clip=clip.GradientClipByValue(0.5))
    a, b, c = (nn.Parameter(torch.zeros(3)) for _ in range(3))
    a.grad, b.grad = torch.full((3,), 2.0), torch.full((3,), 2.0)
    b.need_clip = False
    with pytest.raises(ValueError, match="parameter_list"):
        opt.minimize(None)
    _, pg = opt.minimize(None, parameter_list=[a, b, c])
    assert [p is q for (p, _), q in zip(pg, (a, b))] == [True, True]
    assert torch.equal(a, torch.full((3,), -0.5))
    assert torch.equal(b, torch.full((3,), -2.0))
    assert torch.equal(c, torch.zeros(3))
    sched = learning_rate_scheduler.PiecewiseDecay([2], [1.0, 0.1])
    opt = optimizer.SGDOptimizer(learning_rate=sched)
    assert opt.current_step_lr() == 1.0
    seen = []
    for _ in range(3):
        a.grad = torch.ones(3)
        opt.minimize(None, parameter_list=[a])
        seen.append(opt.current_step_lr())
    assert seen == [1.0, 0.1, 0.1]
    opt.set_lr(0.25)
    assert opt.current_step_lr() == 0.25
    w = nn.Parameter(torch.ones(2))
    w.grad = torch.ones(2)
    ada = optimizer.AdagradOptimizer(0.1, initial_accumulator_value=0.5)
    ada.minimize(None, parameter_list=[w])
    assert ada._accumulators[w]["Moment"].tolist() == [1.5, 1.5]


def test_clips_match_jax_op_by_op():
    """Value, norm and global-norm clips on lists with one parameter
    opted out, against the JAX clips' ops run eagerly."""
    rng = np.random.default_rng(3)
    gs = [rng.standard_normal(s).astype(np.float32) * 3 for s in
          ((4, 3), (5,), (2, 2))]

    def run(pkg_clip, make, wrap, unwrap):
        ps = [wrap(np.zeros_like(g)) for g in gs]
        ps[1].need_clip = False
        out = make(pkg_clip)(list(zip(ps, [wrap(g) for g in gs])))
        return [unwrap(g) for _, g in out]

    makers = [lambda m: m.GradientClipByValue(1.0, -0.5),
              lambda m: m.GradientClipByNorm(2.0),
              lambda m: m.GradientClipByGlobalNorm(2.0)]
    for make in makers:
        port = run(clip, make, lambda a: nn.Parameter(torch.from_numpy(a)),
                   lambda t: t.detach().numpy())
        with dygraph.guard(), _KeepClipVars():
            from paddle_tpu.fluid.dygraph.varbase import ParamBase

            want = run(jax_clip, make, lambda a: ParamBase(jnp.asarray(a)),
                       lambda v: np.asarray(v.numpy()))
        for a, b in zip(port, want):
            np.testing.assert_allclose(a, b, **OP_TOL)
        np.testing.assert_array_equal(port[1], gs[1])


# ---------------------------------------------------------------------------
# the learning-rate schedulers
# ---------------------------------------------------------------------------

_SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(64, 5, learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 7], [0.1, 0.05, 0.01]),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, 4, 0.5,
                                                     staircase=True),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, 3, 0.3),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, 2, 0.5,
                                                     staircase=True),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, 6, 0.001, power=2.0,
                                                   cycle=True),
    "CosineDecay": lambda m: m.CosineDecay(0.1, 3, 5),
    "LinearLrWarmup": lambda m: m.LinearLrWarmup(
        m.PiecewiseDecay([10], [0.1, 0.01]), 5, 0.0, 0.1),
    "ReduceLROnPlateau": lambda m: m.ReduceLROnPlateau(
        0.1, decay_rate=0.5, patience=2, cooldown=1, min_lr=0.01),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULERS))
def test_scheduler_matches_jax_over_twenty_steps(name):
    ours, theirs = (_SCHEDULERS[name](m) for m in (learning_rate_scheduler,
                                                   jax_lrs))
    assert ours.get_lr() == theirs.get_lr()
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8] * 2
    got, want = [], []
    for i in range(20):
        if name == "ReduceLROnPlateau":
            ours.step(metrics[i])
            theirs.step(metrics[i])
            got.append((ours(), ours.get_lr()))
            want.append((theirs(), theirs.get_lr()))
        elif i % 5 == 4:
            ours.step()
            theirs.step()
            got.append(ours.get_lr())
            want.append(theirs.get_lr())
        else:
            got.append(ours())
            want.append(theirs())
    assert got == want
    assert len(set(map(str, got))) > 1
