"""`paddle_tpu_torch.models` BERT pretraining held against
`paddle_tpu.models` on the CPU.

The JAX package builds `BertForPretraining` at its tiny config (hidden
32, 4 heads, 2 layers, vocab 128, dropout 0); its parameters are carried
across with `from_jax_state_dict`, and the same numpy inputs go through
both.  Tolerances (f32): logits, NSP logits and loss atol 1e-5 (rtol
1e-5), the two frameworks sum in another order; one-step gradients of
every parameter atol 1e-4 (rtol 1e-4), a gradient sums over the whole
batch and both layers.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax

from paddle_tpu import distributed as jax_dist
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import dygraph, framework
from paddle_tpu.fluid.optimizer import AdamWOptimizer as JaxAdamW
from paddle_tpu_torch import models

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
B, S, P = 3, 16, 5


@pytest.fixture(scope="module")
def pair():
    """(jax model, torch model, jax-layout params) with the same weights."""
    with dygraph.guard():
        np.random.seed(0)
        jm = jax_models.BertForPretraining(jax_models.BertConfig.tiny())
    params = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    # the heads start at zero bias; give every parameter a value so a
    # transposed or dropped weight shows
    rng = np.random.default_rng(1)
    params = {k: v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()}
    for k, v in jm.state_dict().items():
        v.data = jax.numpy.asarray(params[k])
    tm = models.BertForPretraining(models.BertConfig.tiny(), device="cpu")
    tm.load_state_dict(models.from_jax_state_dict(params))
    return jm, tm, params


def _batch(seed, mask=False, segs=False, positions=True):
    rng = np.random.RandomState(seed)
    cfg = jax_models.BertConfig.tiny()
    b = {"input_ids": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "token_type_ids": rng.randint(0, 2, (B, S)).astype(np.int32),
         "position_ids": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
         "nsp_labels": rng.randint(0, 2, (B, 1)).astype(np.int32)}
    if mask:
        m = np.ones((B, S), np.int32)
        m[0, S - 5:] = 0
        m[2, S - 2:] = 0
        b["attention_mask"] = m
    if segs:
        sg = np.zeros((B, S), np.int32)
        sg[1, S // 2:] = 1
        sg[2, 3:9] = 2
        b["segment_ids"] = sg
    n = P if positions else S
    if positions:
        b["masked_positions"] = np.stack([
            np.sort(rng.choice(S, P, replace=False))
            for _ in range(B)]).astype(np.int32)
    b["mlm_labels"] = rng.randint(0, cfg.vocab_size, (B, n)).astype(np.int32)
    w = np.ones((B, n), np.float32)
    w[0, :2] = 0.0
    b["mlm_weights"] = w
    return b


_MODEL_KEYS = ("attention_mask", "segment_ids", "masked_positions")


def _loss_fn(m, batch):
    """The loss of either package's model (same call surface)."""
    kw = {k: batch[k] for k in _MODEL_KEYS if k in batch}
    logits, nsp = m(batch["input_ids"], batch["token_type_ids"],
                    batch["position_ids"], **kw)
    return m.loss(logits, nsp, batch["mlm_labels"], batch["mlm_weights"],
                  batch["nsp_labels"])


def _jax_forward(jm, batch):
    with dygraph.guard():
        framework._dygraph_tracer.train_mode = False
        for vb in jm.state_dict().values():
            framework._dygraph_tracer.register_var(vb)
        v = {k: dygraph.to_variable(a) for k, a in batch.items()}
        kw = {k: v[k] for k in _MODEL_KEYS if k in v}
        logits, nsp = jm(v["input_ids"], v["token_type_ids"],
                         v["position_ids"], **kw)
        loss = jm.loss(logits, nsp, v["mlm_labels"], v["mlm_weights"],
                       v["nsp_labels"])
        return (np.asarray(logits.numpy()), np.asarray(nsp.numpy()),
                float(np.asarray(loss.numpy())))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("mask,segs,positions", [
    (False, False, False), (True, False, True), (False, True, True),
    (True, True, False), (True, True, True)])
def test_forward_logits_and_loss_match_jax(pair, mask, segs, positions):
    jm, tm, _ = pair
    batch = _batch(7, mask, segs, positions)
    want_logits, want_nsp, want_loss = _jax_forward(jm, batch)
    tb = _t(batch)
    kw = {k: tb[k] for k in _MODEL_KEYS if k in tb}
    with torch.no_grad():
        logits, nsp = tm.eval()(tb["input_ids"], tb["token_type_ids"],
                                tb["position_ids"], **kw)
        loss = tm.loss(logits, nsp, tb["mlm_labels"], tb["mlm_weights"],
                       tb["nsp_labels"])
    assert logits.shape == (B, P if positions else S, 128)
    np.testing.assert_allclose(logits.numpy(), want_logits, **FWD_TOL)
    np.testing.assert_allclose(nsp.numpy(), want_nsp, **FWD_TOL)
    np.testing.assert_allclose(loss.item(), want_loss, **FWD_TOL)


def _check_one_step_grads(jm, tm, params, batch):
    """jax.grad of the reference's loss (its train step's grad function)
    against autograd through the port: loss and every parameter's
    gradient."""
    with dygraph.guard():
        step = jax_dist.ShardedTrainStep(
            jm, JaxAdamW(learning_rate=1e-4, weight_decay=0.01),
            _loss_fn, jax_dist.auto_mesh(1), zero_stage=0)
        jloss, jgrads = step._make_grad_fn()(
            {k: jax.numpy.asarray(v) for k, v in params.items()},
            {k: jax.numpy.asarray(v) for k, v in batch.items()},
            jax.random.key(0))
    tm.zero_grad()
    loss = _loss_fn(tm.train(), _t(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD_TOL)
    linear_weights = {n + ".weight" for n, m in tm.named_modules()
                      if isinstance(m, nn.Linear)}
    named = dict(tm.named_parameters())
    assert set(named) == set(jgrads)
    for name, p in named.items():
        want = np.asarray(jgrads[name])
        if name in linear_weights:
            want = want.T
        np.testing.assert_allclose(p.grad.numpy(), want, **GRAD_TOL,
                                   err_msg=name)


def test_one_step_gradients_of_every_parameter_match_jax(pair):
    """jax.grad of the reference's loss (its train step's grad function)
    against autograd through the port, bias and segment paths on."""
    jm, tm, params = pair
    _check_one_step_grads(jm, tm, params, _batch(8, mask=True, segs=True))


def test_every_key_lands_transposed_exactly_where_it_is_a_linear(pair):
    jm, tm, params = pair
    sd = models.from_jax_state_dict(params)
    assert set(sd) == set(tm.state_dict())
    linear_weights = {n + ".weight" for n, m in tm.named_modules()
                      if isinstance(m, nn.Linear)}
    assert {"bert.pooler.weight", "mlm_transform.weight",
            "nsp.weight"} <= linear_weights
    for key, val in params.items():
        want = val.T if key in linear_weights else val
        assert tuple(sd[key].shape) == want.shape, key
        np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)
        np.testing.assert_array_equal(tm.state_dict()[key].numpy(), want)


def test_init_bert_params_has_the_jax_keys_and_shapes(pair):
    _, _, params = pair
    got = models.init_bert_params(models.BertConfig.tiny(), seed=3)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in params.items()}
    again = models.init_bert_params(models.BertConfig.tiny(), seed=3)
    assert all(np.array_equal(got[k], again[k]) for k in got)
    assert not got["mlm_bias"].any() and (got["mlm_ln.weight"] == 1).all()


def test_convert_legacy_qkv_state_dict_round_trips(pair):
    """A pre-fusion checkpoint (separate q/k/v projections) loads into
    the fused model; the port's conversion agrees with the reference's
    applied in the JAX layout."""
    _, tm, params = pair
    d = models.BertConfig.tiny().hidden_size
    legacy = dict(params)
    for i in range(2):
        base = "bert.encoder.%d.attn." % i
        w = legacy.pop(base + "qkv_proj.weight")
        bias = legacy.pop(base + "qkv_proj.bias")
        for j, p in enumerate("qkv"):
            legacy[base + p + "_proj.weight"] = w[:, j * d:(j + 1) * d]
            legacy[base + p + "_proj.bias"] = bias[j * d:(j + 1) * d]
    want = models.from_jax_state_dict(
        jax_models.bert.convert_legacy_qkv_state_dict(legacy, params.keys()))
    got = models.convert_legacy_qkv_state_dict(
        models.from_jax_state_dict(legacy), tm.state_dict().keys())
    assert set(got) == set(want) == set(tm.state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    fresh = models.BertForPretraining(models.BertConfig.tiny(), device="cpu")
    fresh.load_state_dict(models.from_jax_state_dict(legacy))
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, atol=0, rtol=0)


def test_cross_attention_raises():
    """Cross attention builds separate q / k / v projections and raises
    where the reference does: a fused-QKV layer given a distinct key,
    packed cross attention given one id array instead of a pair."""
    cfg = models.BertConfig.tiny()
    cross = models.MultiHeadAttention(cfg, device="cpu")
    assert {"q_proj.weight", "k_proj.weight", "v_proj.weight"} <= set(
        cross.state_dict())
    q, mem = torch.randn(2, 3, 32), torch.randn(2, 5, 32)
    assert cross(q, key=mem).shape == (2, 3, 32)
    fused = models.MultiHeadAttention(cfg, self_attention=True, device="cpu")
    with pytest.raises(ValueError, match="cross attention"):
        fused(q, key=mem)
    with pytest.raises(ValueError, match="pair"):
        cross(q, key=mem, segment_ids=torch.zeros(2, 3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the reference's environment knobs: PADDLE_TPU_FUSED_FFN and
# PADDLE_TPU_BERT_HEAD_LAYOUT (both read at call time, by both packages)
# ---------------------------------------------------------------------------


def _port_forward(tm, batch):
    tb = _t(batch)
    kw = {k: tb[k] for k in _MODEL_KEYS if k in tb}
    with torch.no_grad():
        logits, nsp = tm.eval()(tb["input_ids"], tb["token_type_ids"],
                                tb["position_ids"], **kw)
        loss = tm.loss(logits, nsp, tb["mlm_labels"], tb["mlm_weights"],
                       tb["nsp_labels"])
    return logits.numpy(), nsp.numpy(), loss.item()


def test_fused_ffn_logits_loss_and_grads_match_jax(pair, monkeypatch):
    """``PADDLE_TPU_FUSED_FFN=1``: the port's FFN runs fc1 + gelu through
    `fused_linear` (on the CPU, the plain versions of the GEMM kernels),
    the reference's through its ``matmul_bias_act`` op (on the CPU, the
    naive composition)."""
    jm, tm, params = pair
    monkeypatch.setenv("PADDLE_TPU_FUSED_FFN", "1")
    batch = _batch(9, mask=True, segs=True)
    got, want = _port_forward(tm, batch), _jax_forward(jm, batch)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **FWD_TOL)
    _check_one_step_grads(jm, tm, params, _batch(10, mask=True, segs=True))


def test_fused_ffn_equals_the_unfused_ffn(pair, monkeypatch):
    _, tm, _ = pair
    batch = _batch(11, mask=True)
    runs = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("PADDLE_TPU_FUSED_FFN", knob)
        fwd = _port_forward(tm, batch)
        tm.zero_grad()
        _loss_fn(tm.train(), _t(batch)).backward()
        runs[knob] = fwd, {n: p.grad.clone()
                           for n, p in tm.named_parameters()}
    for a, b in zip(runs["0"][0], runs["1"][0]):
        np.testing.assert_allclose(a, b, **FWD_TOL)
    for name, g in runs["0"][1].items():
        torch.testing.assert_close(runs["1"][1][name], g, **GRAD_TOL)


def test_bhsd_head_layout_matches_bshd_and_jax(pair, monkeypatch):
    """``PADDLE_TPU_BERT_HEAD_LAYOUT=BHSD`` materializes the head
    transposes around the flash op; the logits equal the default BSHD
    run's and the reference's BHSD run's."""
    jm, tm, _ = pair
    batch = _batch(12, mask=True, segs=True)
    default = _port_forward(tm, batch)
    monkeypatch.setenv("PADDLE_TPU_BERT_HEAD_LAYOUT", "bhsd")
    got, want = _port_forward(tm, batch), _jax_forward(jm, batch)
    for a, b, c in zip(got, default, want):
        np.testing.assert_allclose(a, b, **FWD_TOL)
        np.testing.assert_allclose(a, c, **FWD_TOL)


def test_bad_head_layout_raises_as_the_reference_does(pair, monkeypatch):
    jm, tm, _ = pair
    batch = _batch(13)
    monkeypatch.setenv("PADDLE_TPU_BERT_HEAD_LAYOUT", "SBHD")
    match = "PADDLE_TPU_BERT_HEAD_LAYOUT must be BSHD or BHSD, got 'SBHD'"
    with pytest.raises(ValueError, match=match):
        _jax_forward(jm, batch)
    with pytest.raises(ValueError, match=match):
        _port_forward(tm, batch)


def test_config_matches_jax():
    for name in ("tiny", "base"):
        assert vars(getattr(models.BertConfig, name)()) == \
            vars(getattr(jax_models.BertConfig, name)())


# ---------------------------------------------------------------------------
# device defaults: the card unless the caller asks for the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("build", [
    lambda dev: models.MultiHeadAttention(models.BertConfig.tiny(),
                                          self_attention=True, device=dev),
    lambda dev: models.TransformerLMBlock(models.TransformerLMConfig.tiny(),
                                          device=dev),
    lambda dev: models.TransformerEncoderLayer(models.BertConfig.tiny(),
                                               device=dev),
    lambda dev: models.BertForPretraining(models.BertConfig.tiny(),
                                          device=dev),
], ids=["MultiHeadAttention", "TransformerLMBlock", "TransformerEncoderLayer",
        "BertForPretraining"])
def test_modules_default_to_the_card_and_raise_without_one(build,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(None)
    module = build("cpu")
    assert all(p.device.type == "cpu" for p in module.parameters())
