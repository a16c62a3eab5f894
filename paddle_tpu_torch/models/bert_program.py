"""BERT as a static program: the counterpart of `paddle_tpu.models.BertModel`
(and of ``BertForPretraining`` with its loss) traced under
``program_guard``.

The port's `models.BertModel` is an `nn.Module` and records no ops, so
this module emits the ops itself, through the port's `fluid.layers`:
under a fresh `unique_name.guard()` it gives the same op types in the
same order, the same attrs, and the same parameter, variable and
startup-op names and shapes as the reference's
``models.BertModel(cfg)(input_ids, token_type_ids, position_ids,
attention_mask)`` in static mode, with the fused FFN on
(``PADDLE_TPU_FUSED_FFN=1``: fc1 + gelu as one ``matmul_bias_act``) and
off (``mul`` -> ``elementwise_add`` -> ``gelu``, which
``fluid.ir``'s ``matmul_bias_act_fuse`` folds into the same op).
Attention is the ``flash_attention`` op with the padding mask as an
additive bias, BSHD, or BHSD with the reference's transposes under
``PADDLE_TPU_BERT_HEAD_LAYOUT=BHSD`` (`MultiHeadAttention`, which the
Transformer program shares).

    main, startup, feeds, (seq, pooled) = bert_program(cfg, seq_len=128)
    exe = fluid.Executor(); exe.run(startup)
    fluid.io.save_inference_model(dirname, feeds, [seq, pooled], exe, main)

    main, startup, feeds, loss = bert_pretraining_program(
        cfg, seq_len=128, max_preds=20,
        optimizer=optimizer.AdamWOptimizer(1e-4, weight_decay=0.01))
    exe.run(startup)
    loss_value, = exe.run(main, feed=batch, fetch_list=[loss])
"""

from __future__ import annotations

from ..fluid import framework, unique_name
from ..fluid.initializer import ConstantInitializer, NormalInitializer
from ..fluid.layer_helper import LayerHelper, ParamAttr
from ..fluid.layers import loss as Loss
from ..fluid.layers import ops as L
from ..fluid.layers import tensor as T
from ..fluid.layers.common import append_simple_op
from .bert import _fused_ffn_enabled, _head_layout

FEED_NAMES = ("input_ids", "token_type_ids", "position_ids", "attention_mask")


class _Linear:
    """Parameters of a reference ``dygraph.Linear`` (``linear.w_*``):
    weight ``[d_in, d_out]`` ~ N(0, initializer_range), bias zeros."""

    def __init__(self, cfg, d_in, d_out, act=None):
        helper = LayerHelper("linear")
        self.weight = helper.create_parameter(
            ParamAttr(initializer=NormalInitializer(
                0.0, cfg.initializer_range)), [d_in, d_out])
        self.bias = helper.create_parameter(None, [d_out], is_bias=True)
        self.act = act

    def __call__(self, x):
        nd = len(x.shape)
        out = append_simple_op("mul", {"X": x, "Y": self.weight},
                               {"x_num_col_dims": nd - 1,
                                "y_num_col_dims": 1})
        out = append_simple_op("elementwise_add",
                               {"X": out, "Y": self.bias}, {"axis": nd - 1})
        if self.act:
            out = append_simple_op(self.act, {"X": out}, {})
        return out


class _LayerNorm:
    """``layernorm.w_*``: scale ones, shift zeros, over the last dim."""

    def __init__(self, d):
        helper = LayerHelper("layernorm")
        self.weight = helper.create_parameter(
            None, [d], default_initializer=ConstantInitializer(1.0))
        self.bias = helper.create_parameter(None, [d], is_bias=True)

    def __call__(self, x):
        out, _, _ = append_simple_op(
            "layer_norm", {"X": x, "Scale": self.weight, "Bias": self.bias},
            {"begin_norm_axis": len(x.shape) - 1, "epsilon": 1e-5},
            out_slots=("Y", "Mean", "Variance"))
        return out


class _Embedding:
    """``embedding.w_*``: a ``[vocab, d]`` table ~ N(0, initializer_range)."""

    def __init__(self, cfg, vocab):
        self.weight = LayerHelper("embedding").create_parameter(
            ParamAttr(initializer=NormalInitializer(
                0.0, cfg.initializer_range)), [vocab, cfg.hidden_size])

    def __call__(self, ids):
        return append_simple_op("lookup_table",
                                {"W": self.weight, "Ids": ids},
                                {"padding_idx": -1}, dtype="float32")


def _dropout(x, p):
    """The reference's ``dygraph.Dropout`` in training mode, as a fresh
    layer is (`fluid.io.save_inference_model` sets ``is_test`` on the
    saved copy)."""
    out, _ = append_simple_op(
        "dropout", {"X": x},
        {"dropout_prob": p, "is_test": False,
         "dropout_implementation": "upscale_in_train"},
        out_slots=("Out", "Mask"))
    return out


class MultiHeadAttention:
    """The reference's ``MultiHeadAttention`` (`paddle_tpu/models/bert.py
    :122-236`) in static mode, shared by BERT and the Transformer:
    self-attention through one fused ``[d, 3d]`` projection
    (``self_attention=True``) or cross attention through separate q, k
    and v projections, then the ``flash_attention`` op (kernel 1), the
    output projection and dropout.  The heads stay BSHD, or are
    transposed to BHSD and back under ``PADDLE_TPU_BERT_HEAD_LAYOUT=
    BHSD``, as the reference builds them."""

    def __init__(self, cfg, d, n_head, dropout, self_attention=False):
        self.n_head, self.d_head = n_head, d // n_head
        self.dropout = dropout
        self.fused_qkv = bool(self_attention)
        if self.fused_qkv:
            self.qkv_proj = _Linear(cfg, d, 3 * d)
        else:
            self.q_proj = _Linear(cfg, d, d)
            self.k_proj = _Linear(cfg, d, d)
            self.v_proj = _Linear(cfg, d, d)
        self.out_proj = _Linear(cfg, d, d)

    def _split(self, x, seq_len):
        return T.reshape(x, [0, seq_len, self.n_head, self.d_head])

    def __call__(self, query, key=None, attn_bias=None, causal=False):
        """``query`` [B, Sq, d] over ``key`` [B, Sk, d] (the query
        itself when None); ``attn_bias`` an additive [B, 1, 1, Sk]
        padding bias; ``causal``: bottom-right causal masking."""
        key = query if key is None else key
        q_len, kv_len = int(query.shape[1]), int(key.shape[1])
        d = self.n_head * self.d_head
        if self.fused_qkv:
            if key is not query:
                raise ValueError(
                    "fused-qkv attention is self-attention only; build "
                    "with self_attention=False for cross attention")
            qkv = self.qkv_proj(query)
            q, k, v = (self._split(T.slice(qkv, [2], [i * d],
                                           [(i + 1) * d]), q_len)
                       for i in range(3))
        else:
            q = self._split(self.q_proj(query), q_len)
            k = self._split(self.k_proj(key), kv_len)
            v = self._split(self.v_proj(key), kv_len)
        layout = _head_layout()
        if layout == "BHSD":
            q, k, v = (T.transpose(t, [0, 2, 1, 3]) for t in (q, k, v))
        ins = {"Q": q, "K": k, "V": v}
        if attn_bias is not None:
            ins["Bias"] = attn_bias
        ctxv = append_simple_op(
            "flash_attention", ins,
            {"scale": self.d_head ** -0.5, "causal": causal,
             "layout": layout})
        if layout == "BHSD":
            ctxv = T.transpose(ctxv, [0, 2, 1, 3])
        ctxv = T.reshape(ctxv, [0, q_len, d])
        return _dropout(self.out_proj(ctxv), self.dropout)


def pad_bias(pad_mask):
    """``pad_mask`` [B, S] (1 = token, 0 = pad) as the additive
    [B, 1, 1, S] attention bias: 0 at a token, -1e4 at a pad."""
    m = T.cast(pad_mask, "float32")
    m = T.reshape(m, [0, 1, 1, int(pad_mask.shape[-1])])
    return (m + (-1.0)) * 10000.0


class _EncoderLayer:
    """The reference's post-LN ``TransformerEncoderLayer`` with fused-QKV
    self-attention: parameters in its construction order."""

    def __init__(self, cfg):
        d = cfg.hidden_size
        self.cfg = cfg
        self.attn = MultiHeadAttention(cfg, d, cfg.num_attention_heads,
                                       cfg.attention_probs_dropout_prob,
                                       self_attention=True)
        self.ln1 = _LayerNorm(d)
        self.fc1 = _Linear(cfg, d, cfg.intermediate_size)
        self.fc2 = _Linear(cfg, cfg.intermediate_size, d)
        self.ln2 = _LayerNorm(d)

    def __call__(self, x, attn_bias, fused_ffn):
        h = self.ln1(x + self.attn(x, attn_bias=attn_bias))
        if fused_ffn:
            f = append_simple_op(
                "matmul_bias_act",
                {"X": h, "Y": self.fc1.weight, "Bias": self.fc1.bias},
                {"act_type": "gelu", "approximate": False,
                 "x_num_col_dims": len(h.shape) - 1, "y_num_col_dims": 1})
        else:
            f = append_simple_op("gelu", {"X": self.fc1(h)},
                                 {"approximate": False})
        f = self.fc2(f)
        return self.ln2(h + _dropout(f, self.cfg.hidden_dropout_prob))


class _BertModel:
    """The reference's ``BertModel(cfg)``: its parameters in construction
    order when built, its forward ops when called."""

    def __init__(self, cfg):
        self.cfg = cfg
        d = cfg.hidden_size
        self.word = _Embedding(cfg, cfg.vocab_size)
        self.position = _Embedding(cfg, cfg.max_position_embeddings)
        self.token_type = _Embedding(cfg, cfg.type_vocab_size)
        self.emb_ln = _LayerNorm(d)
        self.layers = [_EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)]
        self.pooler = _Linear(cfg, d, d, act="tanh")

    def __call__(self, input_ids, token_type_ids, position_ids,
                 attention_mask=None):
        cfg, d = self.cfg, self.cfg.hidden_size
        fused_ffn = _fused_ffn_enabled()
        attn_bias = None if attention_mask is None else pad_bias(
            attention_mask)
        emb = self.word(input_ids) + self.position(position_ids) \
            + self.token_type(token_type_ids)
        h = _dropout(self.emb_ln(emb), cfg.hidden_dropout_prob)
        for layer in self.layers:
            h = layer(h, attn_bias, fused_ffn)
        first = T.reshape(T.slice(h, axes=[1], starts=[0], ends=[1]), [0, d])
        return h, self.pooler(first)


def build_bert(cfg, input_ids, token_type_ids, position_ids,
               attention_mask=None):
    """Emit BERT's parameters (startup program) and forward ops (main
    program) into the default programs: the reference's
    ``BertModel(cfg)`` constructed and called in static mode.  Returns
    ``(sequence_output [B, S, D], pooled [B, D])``.  The FFN is fused
    under ``PADDLE_TPU_FUSED_FFN=1``, as in the reference."""
    return _BertModel(cfg)(input_ids, token_type_ids, position_ids,
                           attention_mask)


def bert_program(cfg, seq_len):
    """Fresh ``(main, startup, feed_names, (sequence_output, pooled))``
    for BERT at ``seq_len``, built under a fresh `unique_name.guard()`.
    Feeds: int64 ``[-1, seq_len]`` input_ids, token_type_ids,
    position_ids and attention_mask (1 = attend)."""
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        feeds = [T.data(n, [-1, seq_len], "int64", append_batch_size=False)
                 for n in FEED_NAMES]
        outs = build_bert(cfg, *feeds)
    return main, startup, list(FEED_NAMES), outs


class _BertForPretraining:
    """The reference's ``BertForPretraining(cfg)``: BERT, the MLM
    transform and LayerNorm, the MLM bias (the decoder is the word
    embedding, tied) and the NSP head."""

    def __init__(self, cfg):
        d = cfg.hidden_size
        self.bert = _BertModel(cfg)
        self.mlm_transform = _Linear(cfg, d, d, act="gelu")
        self.mlm_ln = _LayerNorm(d)
        self.mlm_bias = LayerHelper("bertforpretraining").create_parameter(
            ParamAttr(initializer=ConstantInitializer(0.0)),
            [cfg.vocab_size])
        self.nsp = _Linear(cfg, d, 2)

    def __call__(self, input_ids, token_type_ids, position_ids,
                 attention_mask, masked_positions):
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask)
        idx = T.reshape(masked_positions, list(masked_positions.shape) + [1])
        seq = T.take_along_axis(seq, idx, axis=1)           # [B, P, D]
        h = self.mlm_ln(self.mlm_transform(seq))
        logits = L.matmul(h, self.bert.word.weight, transpose_y=True)
        return logits + self.mlm_bias, self.nsp(pooled)

    @staticmethod
    def loss(logits, nsp_logits, mlm_labels, mlm_weights, nsp_labels):
        """The weighted mean MLM loss over the masked positions plus the
        mean NSP loss (`paddle_tpu/models/bert.py:491-507`)."""
        vocab = int(logits.shape[-1])
        mlm_loss = Loss.softmax_with_cross_entropy(
            T.reshape(logits, [-1, vocab]), T.reshape(mlm_labels, [-1, 1]))
        w = T.reshape(mlm_weights, [-1, 1])
        mlm_loss = L.reduce_sum(mlm_loss * w) / (L.reduce_sum(w) + 1e-6)
        nsp_loss = L.reduce_mean(
            Loss.softmax_with_cross_entropy(nsp_logits, nsp_labels))
        return mlm_loss + nsp_loss


PRETRAINING_FEEDS = ("masked_positions", "mlm_labels", "mlm_weights",
                     "nsp_labels")


def bert_pretraining_program(cfg, seq_len, max_preds, optimizer=None):
    """Fresh ``(main, startup, feed_names, loss)`` for BERT pretraining
    (MLM over ``max_preds`` masked positions, NSP), built under a fresh
    `unique_name.guard()`: the reference's ``BertForPretraining(cfg)``
    called with ``masked_positions`` and its ``.loss`` in static mode.
    With an ``optimizer`` (a `paddle_tpu_torch.optimizer` instance), its
    ``minimize(loss)`` is appended in the same name space, as a JAX
    program built and minimized under one guard.  Feeds: the four of
    `bert_program`, then int64 ``[-1, max_preds]`` masked_positions and
    mlm_labels, float32 ``[-1, max_preds]`` mlm_weights (1 at a real
    prediction, 0 at padding) and int64 ``[-1, 1]`` nsp_labels."""
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        feeds = [T.data(n, [-1, seq_len], "int64", append_batch_size=False)
                 for n in FEED_NAMES]
        pos, labels, weights, nsp = (
            T.data(n, shape, dtype, append_batch_size=False)
            for n, shape, dtype in (
                ("masked_positions", [-1, max_preds], "int64"),
                ("mlm_labels", [-1, max_preds], "int64"),
                ("mlm_weights", [-1, max_preds], "float32"),
                ("nsp_labels", [-1, 1], "int64")))
        model = _BertForPretraining(cfg)
        logits, nsp_logits = model(*feeds, masked_positions=pos)
        loss = model.loss(logits, nsp_logits, labels, weights, nsp)
        if optimizer is not None:
            optimizer.minimize(loss)
    return main, startup, list(FEED_NAMES + PRETRAINING_FEEDS), loss
