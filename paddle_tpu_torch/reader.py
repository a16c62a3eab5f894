"""Reader decorators (reference `python/paddle/reader/decorator.py`):
compose example generators — shuffle, batch, map, chain — feeding the
Executor.  Pure-Python host-side plumbing.

A copy of `paddle_tpu/reader.py` (numpy only), so the port imports
nothing of the JAX package: the same seeds give the same batches."""

from __future__ import annotations

import random as _random

import numpy as np


def shuffle(reader, buf_size, seed=None):
    """cf. reference reader.shuffle: buffered shuffling of a reader.

    `seed=` (parity with `fluid.reader.shuffle`) makes the order
    deterministic and stable across re-iterations.  Unseeded use is
    EXPLICITLY nondeterministic: each call draws a fresh OS-entropy RNG
    (never the process-global `random` module, whose hidden state made
    "unseeded" runs silently couple to unrelated code)."""

    def _impl():
        rs = _random.Random(seed) if seed is not None else _random.Random()
        buf = []
        for ex in reader():
            buf.append(ex)
            if len(buf) >= buf_size:
                rs.shuffle(buf)
                while buf:
                    yield buf.pop()
        rs.shuffle(buf)
        while buf:
            yield buf.pop()

    return _impl


def batch(reader, batch_size, drop_last=False):
    """cf. reference paddle.batch: group examples into lists of tuples."""

    def _impl():
        cur = []
        for ex in reader():
            cur.append(ex)
            if len(cur) == batch_size:
                yield cur
                cur = []
        if cur and not drop_last:
            yield cur

    return _impl


def map_readers(func, *readers):
    """cf. reference reader.map_readers."""

    def _impl():
        for exs in zip(*[r() for r in readers]):
            yield func(*exs)

    return _impl


def chain(*readers):
    """cf. reference reader.chain."""

    def _impl():
        for r in readers:
            yield from r()

    return _impl


def to_feed(batch_examples, names):
    """Stack a paddle.batch-style list of tuples into a feed dict of
    numpy arrays keyed by `names` (scalars gain a trailing dim)."""
    cols = list(zip(*batch_examples))
    feed = {}
    for name, col in zip(names, cols):
        arr = np.asarray(col)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        feed[name] = arr
    return feed
