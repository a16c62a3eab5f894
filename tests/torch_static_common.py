"""Shared pieces of the `tests/test_torch_static_*.py` files: the guard
that every test leaves the JAX package's process-wide static state as
it found it, and the programs both packages build.

The JAX static core keeps process-wide state (the ``unique_name``
counters, the default programs, the global scope, the dygraph tracer,
``fluid.flags``, the op registry) and reads ``PADDLE_TPU_FUSED_FFN``
when it builds BERT.  Under xdist one worker runs many files in turn,
so a test that changed any of these would change what every later
JAX test builds.  So each JAX program here is built inside
``unique_name.guard()``, ``program_guard(Program(), Program())`` and
``scope_guard(Scope())``, the knob is set only through
``monkeypatch.setenv``, and no test registers an op in either registry.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

import paddle_tpu.fluid as jfluid
from paddle_tpu import models as jax_models
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu.fluid.core import registry as jregistry
from paddle_tpu.fluid.core import scope as jscope

from paddle_tpu_torch.fluid.core import registry as tregistry

FEEDS = ("input_ids", "token_type_ids", "position_ids", "attention_mask")
S = 16          # the tiny BERT's sequence length here
TOL = dict(rtol=1e-5, atol=1e-5)


# the environment variables the JAX package and JAX read: the
# ``PADDLE_TPU_*`` knobs, fluid's ``FLAGS_*``, ``JAX_*`` and ``XLA_*``
# (libraries set others, such as ``TF_CPP_MIN_LOG_LEVEL``, once, on their
# first use)
_ENV_PREFIXES = ("PADDLE", "FLAGS_", "JAX_", "XLA_")


def _program_ops(p):
    return sum(len(b.ops) for b in p.blocks), sum(len(b.vars) for b in p.blocks)


def _snapshot():
    return {
        "unique_name generator": (id(jun.generator), dict(jun.generator.ids)),
        "default main program": (id(jframework._main_program),
                                 _program_ops(jframework._main_program)),
        "default startup program": (id(jframework._startup_program),
                                    _program_ops(jframework._startup_program)),
        "global scope": (id(jscope._global_scope),
                         sorted(jscope._global_scope.local_names())),
        "dygraph tracer": id(jframework._dygraph_tracer),
        "flags": dict(jflags._VALUES),
        "JAX op registry": sorted(jregistry._OP_REGISTRY),
        "port op registry": sorted(tregistry._OP_REGISTRY),
        "environment": {k: v for k, v in os.environ.items()
                        if k.startswith(_ENV_PREFIXES)},
    }


@contextlib.contextmanager
def jax_state_unchanged():
    """Fails the test if any of the JAX package's process-wide static
    state, the port's op registry or the environment the JAX package
    reads differs after it from before it."""
    before = _snapshot()
    yield
    after = _snapshot()
    changed = [k for k in before if before[k] != after[k]]
    assert not changed, "the test left changed: %s" % ", ".join(changed)


def jax_bert(cfg=None, seq_len=S):
    """(main, startup, feed names, (seq, pooled)) of the JAX
    ``BertModel`` traced in static mode, built inside fresh guards; the
    fused FFN follows ``PADDLE_TPU_FUSED_FFN`` (set it with
    monkeypatch)."""
    cfg = cfg or jax_models.BertConfig.tiny()
    main, startup = jfluid.Program(), jfluid.Program()
    with jun.guard(), jfluid.program_guard(main, startup):
        feeds = [jfluid.data(n, [-1, seq_len], "int64") for n in FEEDS]
        outs = jax_models.BertModel(cfg)(*feeds)
    return main, startup, list(FEEDS), outs


def jax_mlp():
    """A small fc/relu MLP (4 -> 8 relu -> 3) in JAX, its weights
    Xavier-uniform from the startup program."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jun.guard(), jfluid.program_guard(main, startup):
        x = jfluid.data("x", [-1, 4], "float32")
        h = jlayers.fc(x, 8, act="relu")
        pred = jlayers.fc(h, 3)
    return main, startup, ["x"], [pred]


def jax_save(dirname, main, startup, feeds, fetches, perturb=0.0, seed=0):
    """Run ``startup`` in a fresh JAX scope (then add ``perturb`` x
    N(0, 1) noise to every parameter, so zero biases and unit scales
    carry values) and save the inference model.  Returns the saved
    values by name."""
    exe = jfluid.Executor(jfluid.CPUPlace())
    rng = np.random.RandomState(seed)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        values = {}
        for p in main.all_parameters():
            v = np.asarray(scope.find_var(p.name))
            v = (v + perturb * rng.standard_normal(v.shape)).astype(v.dtype)
            scope.set(p.name, v)
            values[p.name] = v
        jfluid.io.save_inference_model(dirname, feeds, list(fetches), exe,
                                       main)
    return values


def bert_feed(seq_len=S, b=3, vocab=128, seed=0):
    """Seeded int64 BERT feeds; row 0 pads its last 6 keys."""
    rng = np.random.RandomState(seed)
    feed = {
        "input_ids": rng.randint(0, vocab, (b, seq_len)).astype(np.int64),
        "token_type_ids": rng.randint(0, 2, (b, seq_len)).astype(np.int64),
        "position_ids": np.tile(np.arange(seq_len, dtype=np.int64), (b, 1)),
        "attention_mask": np.ones((b, seq_len), np.int64),
    }
    feed["attention_mask"][0, seq_len - 6:] = 0
    return feed
