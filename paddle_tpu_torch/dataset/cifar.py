"""CIFAR-10 reader (reference `python/paddle/dataset/cifar.py:1`):
3x32x32 float image + int label.  Synthetic separable classes
(channel/position-dependent means), deterministic per split."""

import numpy as np


def _make(n, seed):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 10, size=(n,)).astype(np.int64)
    imgs = rs.randn(n, 3, 32, 32).astype(np.float32) * 0.3
    for i, c in enumerate(labels):
        ch = int(c) % 3
        q = int(c) // 3
        imgs[i, ch, 8 * (q % 2): 8 * (q % 2) + 12,
             8 * (q // 2): 8 * (q // 2) + 12] += 1.2
    return imgs.reshape(n, 3 * 32 * 32), labels


def train10(n=512):
    def reader():
        x, y = _make(n, seed=41)
        for i in range(n):
            yield x[i], int(y[i])

    return reader


def test10(n=128):
    def reader():
        x, y = _make(n, seed=42)
        for i in range(n):
            yield x[i], int(y[i])

    return reader
