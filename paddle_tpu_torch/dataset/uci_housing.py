"""UCI housing reader (reference `python/paddle/dataset/uci_housing.py:1`):
13 normalized features -> price.  Synthetic: a fixed linear ground truth
plus noise, deterministic per split."""

import numpy as np

FEATURE_DIM = 13
_W = np.linspace(-2.0, 2.0, FEATURE_DIM).astype(np.float32)
_B = 22.5


def _make(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, FEATURE_DIM).astype(np.float32)
    y = (x @ _W + _B + 0.5 * rs.randn(n)).astype(np.float32)
    return x, y


def train(n=404):
    def reader():
        x, y = _make(n, seed=1)
        for i in range(n):
            yield x[i], y[i: i + 1]

    return reader


def test(n=102):
    def reader():
        x, y = _make(n, seed=2)
        for i in range(n):
            yield x[i], y[i: i + 1]

    return reader
