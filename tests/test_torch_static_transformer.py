"""`models.transformer_program` (the WMT encoder-decoder Transformer as a
static program) and the BHSD form of `models.bert_program` held against
the JAX package on the CPU.

* The tiny Transformer (``TransformerConfig.tiny()``, 8 source and 6
  target tokens, padded source rows), with and without Adam on
  ``noam_decay``, is the traced JAX ``Transformer`` + ``.loss`` (+
  minimize) dict for dict.
* Three dropout-0 Adam + noam steps, each from the JAX scope's state
  carried across: the loss within 1e-5, every gradient within 1e-4 of
  its scale (a cross-attention key bias's, zero in exact arithmetic,
  of its key weight's: `chip_smoke.key_bias_weights`), every parameter within 1e-4 of its scale beyond what Adam
  makes of the two runs' own gradients, the rate within 1e-6 and the
  step counter the JAX one.
* The logits served by both predictors from a JAX-saved directory,
  as saved and after ``matmul_bias_act_fuse`` (fc1 + relu into kernel
  5's op), within 1e-5.
* ``bert_program`` under ``PADDLE_TPU_BERT_HEAD_LAYOUT=BHSD`` (the
  reference's transposes around ``flash_attention``) serves what the
  BSHD program serves, within 1e-5.
"""

import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import ir as jir
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu.inference import AnalysisConfig as JaxConfig
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu_torch import fluid, inference, models
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.fluid import ir, layers

from chip_smoke import key_bias_weights, wmt_batch
from torch_static_common import (
    TOL, S, bert_feed, jax_save, jax_state_unchanged,
)

SRC, TGT, B = 8, 6, 3
WARMUP = 4
FEEDS = sys.modules["paddle_tpu_torch.models.transformer_program"].FEED_NAMES
BETAS = dict(beta1=0.9, beta2=0.98, epsilon=1e-9)


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


def _lens(src_len, tgt_len):
    return dict(src_ids=src_len, src_pos=src_len, tgt_ids=tgt_len,
                tgt_pos=tgt_len, src_pad_mask=src_len, labels=tgt_len)


def jax_transformer(cfg, src_len=SRC, tgt_len=TGT, minimize=False):
    """The JAX ``Transformer`` and its loss (and Adam on noam) traced in
    static mode in fresh guards: ``(main, startup, loss, logits)``."""
    main, startup = jfluid.Program(), jfluid.Program()
    lens = _lens(src_len, tgt_len)
    with jun.guard(), jfluid.program_guard(main, startup):
        f = {n: jfluid.data(n, [-1, lens[n]], "int64") for n in FEEDS}
        model = jax_models.Transformer(cfg)
        logits = model(f["src_ids"], f["src_pos"], f["tgt_ids"],
                       f["tgt_pos"], f["src_pad_mask"])
        loss = model.loss(logits, f["labels"], 0.1)
        if minimize:
            jfluid.optimizer.AdamOptimizer(
                jlayers.noam_decay(cfg.d_model, WARMUP), **BETAS).minimize(
                    loss)
    return main, startup, loss, logits


def port_transformer(cfg, src_len=SRC, tgt_len=TGT, minimize=False):
    opt = (lambda: topt.AdamOptimizer(layers.noam_decay(cfg.d_model, WARMUP),
                                      **BETAS)) if minimize else None
    return models.transformer_program(cfg, src_len, tgt_len, optimizer=opt)


def wmt_feed(seed=0):
    """A batch by `dataset.wmt14`'s law (`chip_smoke.wmt_batch`) at the
    tiny sizes, source rows of 4 to 8 tokens, padded."""
    return wmt_batch(models.TransformerConfig.tiny(), seed, B, SRC, TGT,
                     min_len=4)


@pytest.mark.parametrize("minimize", [False, True])
def test_transformer_program_is_the_traced_jax_one(minimize):
    cfg = models.TransformerConfig.tiny()
    jmain, jstart, jloss, jlogits = jax_transformer(
        jax_models.TransformerConfig.tiny(), minimize=minimize)
    main, start, feeds, loss, logits = port_transformer(cfg,
                                                        minimize=minimize)
    assert [o.type for o in main.global_block.ops] == \
        [o.type for o in jmain.global_block.ops]
    assert [(p.name, p.shape) for p in main.all_parameters()] == \
        [(p.name, p.shape) for p in jmain.all_parameters()]
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()
    assert (loss.name, logits.name) == (jloss.name, jlogits.name)
    assert feeds == list(FEEDS) and logits.shape == (-1, TGT, 64)
    types = [o.type for o in main.global_block.ops]
    L = cfg.num_encoder_layers + 2 * cfg.num_decoder_layers
    assert types.count("flash_attention") == L
    fa = [o.attrs for o in main.global_block.ops
          if o.type == "flash_attention"]
    assert [a["causal"] for a in fa] == [False] * 2 + [True, False] * 2
    assert types.count("one_hot") == 1 and types.count("label_smooth") == 1
    if minimize:
        assert len(types) == 398
        assert types.count("adam") == len(main.all_parameters())
        assert types.count("increment") == types.count("lr_schedule") == 1


def _adam64(p, g, lr, m1, m2, b1p, b2p):
    """The adam op's update in float64."""
    b1, b2, eps = BETAS["beta1"], BETAS["beta2"], BETAS["epsilon"]
    m1 = b1 * m1 + (1 - b1) * g
    m2 = b2 * m2 + (1 - b2) * g * g
    lr_t = lr * np.sqrt(1 - b2p) / (1 - b1p)
    return p - lr_t * m1 / (np.sqrt(m2) + eps)


def test_three_steps_of_the_tiny_transformer_match_jax():
    cfg = models.TransformerConfig.tiny()
    jmain, jstart, jloss, _ = jax_transformer(
        jax_models.TransformerConfig.tiny(), minimize=True)
    main, start, _, loss, _ = port_transformer(cfg, minimize=True)
    lr_name = next(o.output("Out")[0] for o in main.global_block.ops
                   if o.type == "lr_schedule")
    params = [p.name for p in main.all_parameters()]
    key_bias = key_bias_weights(main)
    assert len(key_bias) == cfg.num_decoder_layers
    fetch = [loss.name, lr_name] + [n + "@GRAD" for n in params]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    state = [v.name for v in jmain.list_vars() if v.persistable]
    losses = []
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        # unit LayerNorm scales and zero biases carry no signal: perturb
        # every parameter so the comparison sees them
        rng = np.random.RandomState(9)
        for n in params:
            v = np.asarray(jscope.find_var(n))
            jscope.set(n, (v + 0.05 * rng.standard_normal(v.shape))
                       .astype(np.float32))
        for step in range(3):
            before = {n: np.array(jscope.find_var(n)) for n in state}
            for n, v in before.items():
                scope.set(n, torch.from_numpy(v.copy()))
            feed = wmt_feed(step)
            want = jexe.run(jmain, feed=feed, fetch_list=fetch)
            got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
            losses.append(float(got[0]))
            lr = float(want[1][0])
            grads = dict(zip(params, want[2:]))
            for n, g, w in zip(params, got[2:], want[2:]):
                scale = np.abs(grads[key_bias.get(n, n)]).max()
                assert np.abs(g - w).max() <= 1e-4 * scale, (step, n)
                acc = {k: before[n + "_" + k + "_0"] for k in (
                    "moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc")}
                ups = [_adam64(before[n].astype(np.float64),
                               x.astype(np.float64), lr, acc["moment1"],
                               acc["moment2"], acc["beta1_pow_acc"][0],
                               acc["beta2_pow_acc"][0]) for x in (g, w)]
                p_t, p_j = (scope.find_var(n).numpy(),
                            np.asarray(jscope.find_var(n)))
                err = np.abs((p_t - p_j) - (ups[0] - ups[1])).max()
                assert err <= 1e-4 * np.abs(p_j).max(), (step, n, err)
            assert scope.find_var("@LR_DECAY_COUNTER@").tolist() == \
                [float(step + 1)]
    assert losses[2] < losses[0]


@pytest.fixture(scope="module")
def saved_transformer(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("static_transformer") / "logits")
    jmain, jstart, _, jlogits = jax_transformer(
        jax_models.TransformerConfig.tiny())
    jax_save(d, jmain, jstart, list(FEEDS[:5]), [jlogits], perturb=0.05)
    return d


@pytest.mark.parametrize("passes", [(), ("matmul_bias_act_fuse",)])
def test_served_logits_match_the_jax_predictor(saved_transformer, passes):
    feed = {n: v for n, v in wmt_feed(5).items() if n != "labels"}
    jpred = jax_predictor(JaxConfig(saved_transformer))
    pred = inference.create_predictor(
        inference.AnalysisConfig(saved_transformer), device="cpu")
    if passes:
        jir.apply_passes(jpred._program, list(passes))
        ir.apply_passes(pred._program, list(passes))
    want, = jpred.run(feed)
    got, = pred.run(feed)
    assert got.shape == want.shape == (B, TGT, 64)
    np.testing.assert_allclose(got, want, **TOL)
    types = [o.type for o in pred._program.global_block.ops]
    cfg = models.TransformerConfig.tiny()
    fcs = cfg.num_encoder_layers + cfg.num_decoder_layers
    assert types.count("matmul_bias_act") == (fcs if passes else 0)
    assert types.count("flash_attention") == fcs + cfg.num_decoder_layers


def test_bert_program_bhsd_serves_what_bshd_serves(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FUSED_FFN", raising=False)
    cfg = models.BertConfig.tiny()
    built = {}
    for layout in ("BSHD", "BHSD"):
        monkeypatch.setenv("PADDLE_TPU_BERT_HEAD_LAYOUT", layout)
        built[layout] = models.bert_program.bert_program(cfg, S)
    main, start, feeds, outs = built["BSHD"]
    types = [o.type for o in built["BHSD"][0].global_block.ops]
    assert types.count("transpose2") == 4 * cfg.num_hidden_layers
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    start.random_seed = 7
    exe.run(start, scope=scope)
    served = {}
    for layout, (m, _, f, o) in built.items():
        d = str(tmp_path / layout)
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, f, list(o), exe, m)
        served[layout] = inference.create_predictor(
            inference.AnalysisConfig(d), device="cpu").run(bert_feed())
    for a, b in zip(served["BHSD"], served["BSHD"]):
        np.testing.assert_allclose(a, b, **TOL)
