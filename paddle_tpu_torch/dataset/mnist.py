"""MNIST reader (reference `python/paddle/dataset/mnist.py:1`): 784-float
image in [-1, 1] + int label.  Synthetic separable digits (class-dependent
blob positions), deterministic per split."""

import numpy as np


def _make(n, seed):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 10, size=(n,)).astype(np.int64)
    imgs = rs.randn(n, 28, 28).astype(np.float32) * 0.2 - 0.5
    for i, c in enumerate(labels):
        r, col = divmod(int(c), 5)
        imgs[i, 4 + r * 12: 12 + r * 12, 2 + col * 5: 7 + col * 5] += 1.5
    return np.clip(imgs, -1, 1).reshape(n, 784), labels


def train(n=512):
    def reader():
        x, y = _make(n, seed=11)
        for i in range(n):
            yield x[i], int(y[i])

    return reader


def test(n=128):
    def reader():
        x, y = _make(n, seed=12)
        for i in range(n):
            yield x[i], int(y[i])

    return reader
