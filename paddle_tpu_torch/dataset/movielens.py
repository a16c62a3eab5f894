"""MovieLens reader (reference `python/paddle/dataset/movielens.py:1`):
(user_id, gender, age, job, movie_id, category, rating) tuples for the
recommender-system book test (the reference also carries a title token
sequence; this synthetic variant drops it).  Synthetic with the reference's field
layout; ratings follow a low-rank user x movie structure so the model has
signal to fit."""

import numpy as np

USER_COUNT = 200
MOVIE_COUNT = 300
JOB_COUNT = 21
AGE_COUNT = 7
CATEGORY_COUNT = 18

_rs = np.random.RandomState(31)
_user_f = _rs.randn(USER_COUNT, 4).astype(np.float32)
_movie_f = _rs.randn(MOVIE_COUNT, 4).astype(np.float32)


def max_user_id():
    return USER_COUNT


def max_movie_id():
    return MOVIE_COUNT


def max_job_id():
    return JOB_COUNT


def _make(n, seed):
    rs = np.random.RandomState(seed)
    for _ in range(n):
        u = int(rs.randint(0, USER_COUNT))
        m = int(rs.randint(0, MOVIE_COUNT))
        gender = int(rs.randint(0, 2))
        age = int(rs.randint(0, AGE_COUNT))
        job = int(rs.randint(0, JOB_COUNT))
        category = int(rs.randint(0, CATEGORY_COUNT))
        rating = float(
            np.clip(3.0 + _user_f[u] @ _movie_f[m] + 0.2 * rs.randn(), 1, 5)
        )
        yield u, gender, age, job, m, category, rating


def train(n=512):
    def reader():
        yield from _make(n, seed=32)

    return reader


def test(n=128):
    def reader():
        yield from _make(n, seed=33)

    return reader
