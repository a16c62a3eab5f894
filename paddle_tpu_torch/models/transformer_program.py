"""The WMT Transformer (encoder-decoder) as a static program: the
counterpart of `paddle_tpu.models.Transformer` and its ``.loss`` traced
under ``program_guard``.

This module emits the ops itself through the port's `fluid.layers`, as
`bert_program` does for BERT (the eager `models.transformer` computes
the same function and defines `TransformerConfig`): under a fresh
`unique_name.guard()` it gives the same op types in the same order,
the same attrs, and the same parameter,
variable and startup-op names and shapes as the reference's
``Transformer(cfg)(src_ids, src_pos, tgt_ids, tgt_pos, src_pad_mask)``
followed by ``.loss(logits, labels, label_smooth_eps)`` in static mode.
The blocks are pre-LN; the encoder's self-attention and the decoder's
causal self-attention run through one fused QKV projection, the
decoder's cross attention through separate q, k and v projections over
the encoder's memory with the source padding bias (`bert_program
.MultiHeadAttention`, kernel 1); the FFN is ``mul`` +
``elementwise_add`` + ``relu``, then ``mul`` + ``elementwise_add``,
unfused as in the reference (``fluid.ir``'s ``matmul_bias_act_fuse``
folds fc1 + relu into kernel 5 for serving).  The loss smooths one-hot
labels (``one_hot`` -> ``label_smooth`` -> soft-label
``softmax_with_cross_entropy`` -> ``reduce_mean``).

    main, startup, feeds, loss, logits = transformer_program(
        TransformerConfig(), src_len=128, tgt_len=120,
        optimizer=lambda: optimizer.AdamOptimizer(
            fluid.layers.noam_decay(512, 4000), beta2=0.98, epsilon=1e-9))
    exe = fluid.Executor(); exe.run(startup)
    loss_value, = exe.run(main, feed=batch, fetch_list=[loss])
"""

from __future__ import annotations

from ..fluid import framework, unique_name
from ..fluid.layers import loss as Loss
from ..fluid.layers import ops as L
from ..fluid.layers import tensor as T
from .bert_program import (
    MultiHeadAttention,
    _dropout,
    _Embedding,
    _LayerNorm,
    _Linear,
    pad_bias,
)
from .transformer import TransformerConfig  # noqa: F401

FEED_NAMES = ("src_ids", "src_pos", "tgt_ids", "tgt_pos", "src_pad_mask",
              "labels")


class _FFN:
    def __init__(self, cfg, bcfg):
        self.fc1 = _Linear(bcfg, cfg.d_model, cfg.d_inner, act="relu")
        self.fc2 = _Linear(bcfg, cfg.d_inner, cfg.d_model)
        self.p = cfg.dropout

    def __call__(self, x):
        return _dropout(self.fc2(self.fc1(x)), self.p)


class _EncoderLayer:
    """Pre-LN: x + attn(ln1(x)), then x + ffn(ln2(x))."""

    def __init__(self, cfg, bcfg):
        d = cfg.d_model
        self.ln1 = _LayerNorm(d)
        self.attn = MultiHeadAttention(bcfg, d, cfg.n_head, cfg.dropout,
                                       self_attention=True)
        self.ln2 = _LayerNorm(d)
        self.ffn = _FFN(cfg, bcfg)

    def __call__(self, x, attn_bias):
        x = x + self.attn(self.ln1(x), attn_bias=attn_bias)
        return x + self.ffn(self.ln2(x))


class _DecoderLayer:
    """Pre-LN: causal self-attention, cross attention over the memory
    with the source padding bias, the FFN."""

    def __init__(self, cfg, bcfg):
        d = cfg.d_model
        self.ln1 = _LayerNorm(d)
        self.self_attn = MultiHeadAttention(bcfg, d, cfg.n_head, cfg.dropout,
                                            self_attention=True)
        self.ln2 = _LayerNorm(d)
        self.cross_attn = MultiHeadAttention(bcfg, d, cfg.n_head,
                                             cfg.dropout)
        self.ln3 = _LayerNorm(d)
        self.ffn = _FFN(cfg, bcfg)

    def __call__(self, x, memory, cross_bias):
        x = x + self.self_attn(self.ln1(x), causal=True)
        x = x + self.cross_attn(self.ln2(x), key=memory,
                                attn_bias=cross_bias)
        return x + self.ffn(self.ln3(x))


class _Embedder:
    """Word and position tables; word x sqrt(d_model) + position, then
    dropout."""

    def __init__(self, vocab, cfg, bcfg):
        self.word = _Embedding(bcfg, vocab)
        self.pos = _Embedding(bcfg, cfg.max_length)
        self.scale = cfg.d_model ** 0.5
        self.p = cfg.dropout

    def __call__(self, ids, pos_ids):
        return _dropout(self.word(ids) * self.scale + self.pos(pos_ids),
                        self.p)


class _Transformer:
    """The reference's ``Transformer(cfg)``: its parameters in
    construction order when built, its forward and loss ops when
    called."""

    def __init__(self, cfg):
        self.cfg = cfg
        bcfg = cfg._bert_cfg()
        self.src_emb = _Embedder(cfg.src_vocab_size, cfg, bcfg)
        self.tgt_emb = _Embedder(cfg.tgt_vocab_size, cfg, bcfg)
        self.encoder = [_EncoderLayer(cfg, bcfg)
                        for _ in range(cfg.num_encoder_layers)]
        self.enc_ln = _LayerNorm(cfg.d_model)
        self.decoder = [_DecoderLayer(cfg, bcfg)
                        for _ in range(cfg.num_decoder_layers)]
        self.dec_ln = _LayerNorm(cfg.d_model)
        self.out_proj = _Linear(bcfg, cfg.d_model, cfg.tgt_vocab_size)

    def encode(self, src_ids, src_pos, src_pad_mask=None):
        bias = None if src_pad_mask is None else pad_bias(src_pad_mask)
        h = self.src_emb(src_ids, src_pos)
        for layer in self.encoder:
            h = layer(h, bias)
        return self.enc_ln(h)

    def decode(self, tgt_ids, tgt_pos, memory, src_pad_mask=None):
        cross_bias = None if src_pad_mask is None else pad_bias(src_pad_mask)
        h = self.tgt_emb(tgt_ids, tgt_pos)
        for layer in self.decoder:
            h = layer(h, memory, cross_bias)
        return self.out_proj(self.dec_ln(h))

    def __call__(self, src_ids, src_pos, tgt_ids, tgt_pos, src_pad_mask=None):
        memory = self.encode(src_ids, src_pos, src_pad_mask)
        return self.decode(tgt_ids, tgt_pos, memory, src_pad_mask)

    @staticmethod
    def loss(logits, labels, label_smooth_eps=0.1):
        """The mean token cross entropy against the labels smoothed by
        ``label_smooth_eps`` (the hard-label form at 0)."""
        vocab = int(logits.shape[-1])
        flat = T.reshape(logits, [-1, vocab])
        lab = T.reshape(labels, [-1, 1])
        if label_smooth_eps:
            oh = T.one_hot(T.reshape(lab, [-1]), vocab)
            soft = L.label_smooth(oh, epsilon=label_smooth_eps)
            loss = Loss.softmax_with_cross_entropy(flat, soft,
                                                   soft_label=True)
        else:
            loss = Loss.softmax_with_cross_entropy(flat, lab)
        return L.reduce_mean(loss)


def transformer_program(cfg, src_len, tgt_len, optimizer=None,
                        label_smooth_eps=0.1):
    """Fresh ``(main, startup, feed_names, loss, logits)`` for the
    Transformer at ``src_len`` source and ``tgt_len`` target tokens,
    built under a fresh `unique_name.guard()`.  Feeds (int64): src_ids,
    src_pos, tgt_ids, tgt_pos and src_pad_mask (1 = token, 0 = pad)
    ``[-1, src_len]`` / ``[-1, tgt_len]``, labels ``[-1, tgt_len]``.
    ``logits`` are ``[B, tgt_len, tgt_vocab_size]``.  With an
    ``optimizer`` (a `paddle_tpu_torch.optimizer` instance; its learning
    rate may be a schedule of `fluid.layers`, built in the same call),
    its ``minimize(loss)`` is appended in the same name space, as a JAX
    program built and minimized under one guard.  A learning-rate
    schedule appends ops to the program, so an optimizer that takes one
    is passed as a callable that makes it: it is called after the loss
    is built, in the guard, as a JAX program makes it there."""
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup):
        lens = dict(src_ids=src_len, src_pos=src_len, tgt_ids=tgt_len,
                    tgt_pos=tgt_len, src_pad_mask=src_len, labels=tgt_len)
        feeds = {n: T.data(n, [-1, lens[n]], "int64",
                           append_batch_size=False) for n in FEED_NAMES}
        model = _Transformer(cfg)
        logits = model(feeds["src_ids"], feeds["src_pos"], feeds["tgt_ids"],
                       feeds["tgt_pos"], feeds["src_pad_mask"])
        loss = model.loss(logits, feeds["labels"], label_smooth_eps)
        if optimizer is not None:
            if callable(optimizer):
                optimizer = optimizer()
            optimizer.minimize(loss)
    return main, startup, list(FEED_NAMES), loss, logits
