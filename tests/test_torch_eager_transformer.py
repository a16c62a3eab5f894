"""The eager WMT Transformer of `paddle_tpu_torch.models` (and the cross
attention of its `MultiHeadAttention`) held against `paddle_tpu.models`
on the CPU, and against the port's own static `transformer_program`.

The JAX package builds `Transformer` at its tiny config (d_model 16, 2
heads, 2 + 2 layers, vocabularies 64, dropout 0); its parameters, each
moved by seeded noise so that a dropped or transposed weight shows, go
across through `from_jax_state_dict`, and the same numpy batches go
through both.  Tolerances (f32): logits of `encode` + `decode` and
`forward` atol/rtol 1e-5 (the two frameworks sum in another order); the
loss, label-smoothed (ε = 0.1) and hard (ε = 0), 1e-5; one-step
gradients of every parameter 1e-4 (a gradient sums over the batch and
every layer); three eager Adam + noam steps (the reference's recipe:
``loss.backward()``, ``minimize``, clear the gradients) against the JAX
dygraph's, losses and parameters 1e-4 as `test_torch_optimizers.py`'s
loop; the eager forward against the port's static program from the same
weights 1e-6 (the same ops of one package).
"""

import contextlib

import numpy as np
import pytest
import torch
from torch import nn

import jax

from paddle_tpu import distributed as jax_dist
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph, framework
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu.fluid import optimizer as jax_opt
from paddle_tpu.fluid.dygraph import learning_rate_scheduler as jax_lrs
from paddle_tpu_torch import fluid, learning_rate_scheduler, models
from paddle_tpu_torch import optimizer

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
LOOP_TOL = dict(atol=1e-4, rtol=1e-4)
STATIC_TOL = dict(atol=1e-6, rtol=1e-6)
B, S, T = 3, 12, 10
FEEDS = ("src_ids", "src_pos", "tgt_ids", "tgt_pos", "src_pad_mask")


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    from torch_static_common import jax_state_unchanged

    with jax_state_unchanged():
        yield


@contextlib.contextmanager
def _jax():
    """Dygraph mode under a fresh name space: the JAX layers built here
    leave the package's unique names as they found them."""
    with jun.guard(), dygraph.guard():
        yield


def _noisy(state, seed=1):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v.numpy()) + 0.05 * rng.standard_normal(
        v.shape).astype(np.float32) for k, v in state.items()}


@pytest.fixture(scope="module")
def params():
    """The tiny JAX Transformer's parameters, every one moved by noise
    (the biases start at zero and the LayerNorms at one)."""
    with _jax():
        np.random.seed(0)
        jm = jax_models.Transformer(jax_models.TransformerConfig.tiny())
        return _noisy(jm.state_dict())


def _jax_model(params):
    """A tiny JAX Transformer holding ``params`` (build it under
    `_jax()`)."""
    jm = jax_models.Transformer(jax_models.TransformerConfig.tiny())
    for k, v in jm.state_dict().items():
        v.data = jax.numpy.asarray(params[k])
    return jm


def _port_model(params, cfg=None):
    tm = models.Transformer(cfg or models.TransformerConfig.tiny(),
                            device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(params))
    return tm


def _batch(seed, pad=True):
    """A batch by `dataset.wmt14`'s token law: <s>=0, <e>=1, words from 3;
    rows 0 and 2 pad their sources' tails when ``pad``."""
    rng = np.random.RandomState(seed)
    b = {"src_ids": rng.randint(3, 64, (B, S)).astype(np.int64),
         "src_pos": np.tile(np.arange(S, dtype=np.int64), (B, 1)),
         "tgt_ids": rng.randint(3, 64, (B, T)).astype(np.int64),
         "tgt_pos": np.tile(np.arange(T, dtype=np.int64), (B, 1)),
         "labels": rng.randint(0, 64, (B, T)).astype(np.int64)}
    if pad:
        m = np.ones((B, S), np.int64)
        m[0, 7:] = 0
        m[2, 10:] = 0
        b["src_pad_mask"] = m
    return b


def _loss_fn(eps):
    def loss_fn(m, batch):
        logits = m(*[batch.get(k) for k in FEEDS])
        return m.loss(logits, batch["labels"], eps)
    return loss_fn


def _jax_eval(jm, batch, eps=0.1):
    """(logits, encode + decode logits, loss) of the JAX model in eval."""
    with _jax():
        framework._dygraph_tracer.train_mode = False
        for vb in jm.state_dict().values():
            framework._dygraph_tracer.register_var(vb)
        v = {k: dygraph.to_variable(a) for k, a in batch.items()}
        args = [v.get(k) for k in FEEDS]
        logits = jm(*args)
        mem = jm.encode(args[0], args[1], args[4])
        split = jm.decode(args[2], args[3], mem, args[4])
        loss = jm.loss(logits, v["labels"], eps)
        return (np.asarray(logits.numpy()), np.asarray(split.numpy()),
                float(np.asarray(loss.numpy())))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_config_and_keys_match_jax(params):
    for name in ("tiny", "__init__"):
        mk = (getattr(models.TransformerConfig, name) if name == "tiny"
              else models.TransformerConfig)
        jmk = (getattr(jax_models.TransformerConfig, name) if name == "tiny"
               else jax_models.TransformerConfig)
        assert vars(mk()) == vars(jmk())
        assert vars(mk()._bert_cfg()) == vars(jmk()._bert_cfg())
    tm = _port_model(params)
    assert list(tm.state_dict()) == list(params)
    # the static program's config is this module's, one definition
    assert models.transformer_program.__globals__[
        "TransformerConfig"] is models.TransformerConfig


def test_init_transformer_params_follows_the_reference_laws(params):
    cfg = models.TransformerConfig.tiny()
    got = models.init_transformer_params(cfg, seed=3)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in params.items()}
    again = models.init_transformer_params(cfg, seed=3)
    assert all(np.array_equal(got[k], again[k]) for k in got)
    w = got["decoder.1.cross_attn.k_proj.weight"]
    assert w.dtype == np.float32 and 0.015 < w.std() < 0.025
    assert 0.015 < got["src_emb.word.weight"].std() < 0.025
    assert (got["enc_ln.weight"] == 1).all()
    assert not got["out_proj.bias"].any()


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("eps", [0.1, 0.0])
def test_forward_encode_decode_and_loss_match_jax(params, pad, eps):
    batch = _batch(7, pad)
    with _jax():
        jm = _jax_model(params)
    want, want_split, want_loss = _jax_eval(jm, batch, eps)
    tm = _port_model(params).eval()
    tb = _t(batch)
    args = [tb.get(k) for k in FEEDS]
    with torch.no_grad():
        logits = tm(*args)
        split = tm.decode(args[2], args[3], tm.encode(args[0], args[1],
                                                      args[4]), args[4])
        loss = tm.loss(logits, tb["labels"], eps)
    assert logits.shape == (B, T, 64)
    np.testing.assert_allclose(logits.numpy(), want, **FWD_TOL)
    np.testing.assert_allclose(split.numpy(), want_split, **FWD_TOL)
    np.testing.assert_allclose(loss.item(), want_loss, **FWD_TOL)


def test_pad_bias_is_the_references():
    m = np.array([[1, 1, 0], [1, 0, 0]], np.int64)
    got = models.Transformer._pad_bias(torch.from_numpy(m), 3)
    assert got.shape == (2, 1, 1, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy()[:, 0, 0],
                                  (m - 1.0) * 10000.0)
    assert models.Transformer._pad_bias(None, 3) is None


@pytest.mark.parametrize("eps", [0.1, 0.0])
def test_one_step_gradients_of_every_parameter_match_jax(params, eps):
    """jax.grad of the reference's loss (its train step's grad function)
    against autograd through the port."""
    batch = _batch(8)
    with _jax():
        jm = _jax_model(params)
        step = jax_dist.ShardedTrainStep(
            jm, jax_opt.AdamOptimizer(learning_rate=1e-3), _loss_fn(eps),
            jax_dist.auto_mesh(1), zero_stage=0)
        jloss, jgrads = step._make_grad_fn()(
            {k: jax.numpy.asarray(v) for k, v in params.items()},
            {k: jax.numpy.asarray(v) for k, v in batch.items()},
            jax.random.key(0))
    tm = _port_model(params).train()
    loss = _loss_fn(eps)(tm, _t(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD_TOL)
    linear = {n + ".weight" for n, m in tm.named_modules()
              if isinstance(m, nn.Linear)}
    named = dict(tm.named_parameters())
    assert set(named) == set(jgrads)
    for name, p in named.items():
        want = np.asarray(jgrads[name])
        np.testing.assert_allclose(p.grad.numpy(),
                                   want.T if name in linear else want,
                                   **GRAD_TOL, err_msg=name)


def _adam(pkg_opt, pkg_lrs):
    # the key third of each qkv bias and the cross attention's k_proj
    # bias have an exact gradient of 0 (softmax is shift-invariant), so
    # each framework computes rounding noise there (~1e-9), which the
    # recipe's eps 1e-9 would turn into steps of +-lr; at 1e-6 they stay
    # near 1e-3 lr, as `test_torch_optimizers.py` holds Adamax
    return pkg_opt.AdamOptimizer(
        learning_rate=pkg_lrs.NoamDecay(16, 4), beta1=0.9, beta2=0.98,
        epsilon=1e-6)


def test_three_eager_adam_steps_match_the_jax_dygraph(params):
    """The reference's eager recipe, ``loss = model.loss(model(...),
    labels, 0.1); loss.backward(); opt.minimize(loss, parameter_list=
    model.parameters())``, under Adam(0.9, 0.98, 1e-6) on NoamDecay(16,
    4), three batches, both packages."""
    batches = [_batch(20 + i) for i in range(3)]
    loss_fn = _loss_fn(0.1)
    with _jax():
        jm = _jax_model(params)
        opt = _adam(jax_opt, jax_lrs)
        jl = []
        for b in batches:
            loss = loss_fn(jm, {k: dygraph.to_variable(v)
                                for k, v in b.items()})
            loss.backward()
            opt.minimize(loss, parameter_list=jm.parameters())
            jm.clear_gradients()
            jl.append(float(np.asarray(loss.numpy())))
        jsd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = _port_model(params)
    opt = _adam(optimizer, learning_rate_scheduler)
    tl = []
    for b in batches:
        loss = loss_fn(tm, _t(b))
        loss.backward()
        opt.minimize(loss, parameter_list=list(tm.parameters()))
        tm.zero_grad(set_to_none=True)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, **LOOP_TOL)
    linear = {n + ".weight" for n, m in tm.named_modules()
              if isinstance(m, nn.Linear)}
    moved = 0.0
    for name, v in tm.state_dict().items():
        want = jsd[name].T if name in linear else jsd[name]
        np.testing.assert_allclose(v.numpy(), want, **LOOP_TOL,
                                   err_msg=name)
        moved = max(moved, np.abs(jsd[name] - params[name]).max())
    assert moved > 1e-3


@pytest.mark.parametrize("eps", [0.1, 0.0])
def test_eager_forward_equals_the_static_program(params, eps):
    """The tiny eager model and the port's tiny `transformer_program`
    (dropout 0) from the same weights, mapped in the reference's
    creation order (`program_params_from_eager`): logits and loss."""
    cfg = models.TransformerConfig.tiny()
    tm = _port_model(params).eval()
    main, startup, feeds, loss, logits = models.transformer_program(
        cfg, S, T, label_smooth_eps=eps)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for name, t in models.program_params_from_eager(tm, main).items():
        scope.set(name, t)
    batch = _batch(9)
    want_logits, want_loss = exe.run(main, feed=batch,
                                     fetch_list=[logits, loss], scope=scope)
    tb = _t(batch)
    with torch.no_grad():
        got = tm(*[tb[k] for k in FEEDS])
        got_loss = tm.loss(got, tb["labels"], eps)
    np.testing.assert_allclose(got.numpy(), want_logits, **STATIC_TOL)
    np.testing.assert_allclose(got_loss.item(), float(want_loss),
                               **STATIC_TOL)


def test_program_params_from_eager_checks_shapes(params):
    tm = _port_model(params)
    main, *_ = models.transformer_program(models.TransformerConfig(
        src_vocab_size=64, tgt_vocab_size=64, d_model=16, n_head=2,
        num_encoder_layers=2, num_decoder_layers=2, d_inner=48,
        max_length=32, dropout=0.0), S, T)
    with pytest.raises(ValueError, match="lands on"):
        models.program_params_from_eager(tm, main)


def test_cross_attention_matches_jax_with_a_bias_and_a_segment_pair():
    """`MultiHeadAttention(self_attention=False)` over a memory of another
    length (Sq 5, Sk 9), with a padding bias and packed (q_seg, kv_seg)
    ids: output and every gradient against the JAX layer's."""
    cfg = jax_models.BertConfig.tiny()
    rng = np.random.RandomState(3)
    q = rng.standard_normal((2, 5, 32)).astype(np.float32)
    mem = rng.standard_normal((2, 9, 32)).astype(np.float32)
    # every query keeps a visible key (a row whose keys are all masked
    # would compare two roundings of -10000 + s)
    bias = np.zeros((2, 1, 1, 9), np.float32)
    bias[1, ..., 7:] = -10000.0
    qseg = np.array([[0, 0, 1, 1, 1], [0, 0, 0, 0, 1]], np.int32)
    kseg = np.array([[0] * 4 + [1] * 5, [0] * 6 + [1] * 3], np.int32)
    with _jax():
        np.random.seed(2)
        jl = jax_models.bert.MultiHeadAttention(cfg)
        p = _noisy(jl.state_dict())
        for k, v in jl.state_dict().items():
            v.data = jax.numpy.asarray(p[k])

        def jout(pv, qv, mv):
            for k, v in jl.state_dict().items():
                v.data = pv[k]
            return jl(dygraph.to_variable(qv), key=dygraph.to_variable(mv),
                      attn_bias=dygraph.to_variable(bias),
                      segment_ids=(dygraph.to_variable(qseg),
                                   dygraph.to_variable(kseg))).data

        want = np.asarray(jout({k: jax.numpy.asarray(v)
                                for k, v in p.items()}, q, mem))
        cot = rng.standard_normal(want.shape).astype(np.float32)
        jgrads = jax.grad(lambda pv, qv, mv: (jout(pv, qv, mv) * cot).sum(),
                          argnums=(0, 1, 2))(
            {k: jax.numpy.asarray(v) for k, v in p.items()},
            jax.numpy.asarray(q), jax.numpy.asarray(mem))
    tl = models.MultiHeadAttention(models.BertConfig.tiny(), device="cpu")
    tl.load_state_dict(models.from_jax_state_dict(p))
    qt, mt = (torch.from_numpy(a).requires_grad_() for a in (q, mem))
    got = tl(qt, key=mt, attn_bias=torch.from_numpy(bias),
             segment_ids=(torch.from_numpy(qseg), torch.from_numpy(kseg)))
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(jgrads[1]),
                               **GRAD_TOL)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(jgrads[2]),
                               **GRAD_TOL)
    for name, prm in tl.named_parameters():
        want_g = np.asarray(jgrads[0][name])
        if name.endswith("proj.weight"):
            want_g = want_g.T
        np.testing.assert_allclose(prm.grad.numpy(), want_g, **GRAD_TOL,
                                   err_msg=name)


def test_the_references_two_errors_in_both_packages():
    cfg = jax_models.BertConfig.tiny()
    q = np.zeros((1, 3, 32), np.float32)
    mem = np.zeros((1, 4, 32), np.float32)
    seg = np.zeros((1, 3), np.int32)
    with _jax():
        fused = jax_models.bert.MultiHeadAttention(cfg, self_attention=True)
        cross = jax_models.bert.MultiHeadAttention(cfg)
        with pytest.raises(ValueError, match="self-attention only"):
            fused(dygraph.to_variable(q), key=dygraph.to_variable(mem))
        with pytest.raises(ValueError, match="pair"):
            cross(dygraph.to_variable(q), key=dygraph.to_variable(mem),
                  segment_ids=dygraph.to_variable(seg))
    tcfg = models.BertConfig.tiny()
    fused = models.MultiHeadAttention(tcfg, self_attention=True,
                                      device="cpu")
    cross = models.MultiHeadAttention(tcfg, device="cpu")
    with pytest.raises(ValueError, match="self-attention only"):
        fused(torch.from_numpy(q), key=torch.from_numpy(mem))
    with pytest.raises(ValueError, match="pair"):
        cross(torch.from_numpy(q), key=torch.from_numpy(mem),
              segment_ids=torch.from_numpy(seg))


def test_bad_ids_give_nan_logits_not_an_error(params):
    """The embeddings are the repaired row take: a source id past the
    vocabulary gives NaN logits in both packages (JAX's ``take``), not an
    IndexError; an id in [-V, 0) counts from the end."""
    batch = _batch(11, pad=False)
    batch["src_ids"][1, 3] = 64 + 5
    batch["tgt_ids"][0, 2] = -1
    with _jax():
        jm = _jax_model(params)
    want, _, _ = _jax_eval(jm, batch)
    tm = _port_model(params).eval()
    tb = _t(batch)
    with torch.no_grad():
        got = tm(*[tb.get(k) for k in FEEDS]).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and not np.isnan(got[0]).any()
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_dropout_trains_under_the_sharded_step_in_bf16(params):
    """Dropout 0.1 under `ShardedTrainStep(amp="bf16")`: each `Dropout`'s
    generator is seeded from (seed, step), so two runs of a step from
    one state give the same loss, and two steps give finite losses."""
    from paddle_tpu_torch import distributed

    cfg = models.TransformerConfig.tiny()
    cfg.dropout = 0.1
    tm = _port_model(params, cfg)
    assert sum(isinstance(m, models.bert.Dropout)
               for m in tm.modules()) == 2 + 2 * 2 + 2 * 3
    step = distributed.ShardedTrainStep(
        tm, optimizer.AdamWOptimizer(1e-3), _loss_fn(0.1), amp="bf16",
        donate=False)
    state = step.init()
    batch = _batch(12)
    _, a = step(state, batch)
    state2, b = step(state, batch)
    _, c = step(state2, _batch(13))
    assert a.item() == b.item() and np.isfinite([a.item(), c.item()]).all()
