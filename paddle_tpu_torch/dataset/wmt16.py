"""WMT16 EN<->DE reader (reference `python/paddle/dataset/wmt16.py:1`): a
copy of `paddle_tpu/dataset/wmt16.py`, so the same arguments give the
same examples in both packages.

API contract matched: ``train/test/validation(src_dict_size,
trg_dict_size, src_lang)`` yielding ``(src_ids, trg_ids, trg_ids_next)``
and ``get_dict(lang, dict_size, reverse)``.  Special ids <s>=0, <e>=1,
<unk>=2.  Synthetic corpus with the same deterministic toy translation
as wmt14 (documented no-download policy); ``src_lang`` swaps direction.
"""

import numpy as np

from . import wmt14 as _w

__all__ = ["train", "test", "validation", "get_dict"]


def get_dict(lang, dict_size, reverse=False):
    return _w._build_dict(lang, dict_size, reverse)


def _creator(n, seed, src_dict_size, trg_dict_size, src_lang):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(n):
            length = int(rs.randint(3, 10))
            words = rs.randint(
                _w._RESERVED, min(src_dict_size, trg_dict_size),
                size=length).tolist()
            trg = _w._trg_of(words, min(src_dict_size, trg_dict_size))
            if src_lang != "en":
                words, trg = trg, words
            yield ([_w.START_IDX] + words + [_w.END_IDX],
                   [_w.START_IDX] + trg,
                   trg + [_w.END_IDX])

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en", n=512):
    return _creator(n, 161, src_dict_size, trg_dict_size, src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en", n=64):
    return _creator(n, 162, src_dict_size, trg_dict_size, src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en", n=64):
    return _creator(n, 163, src_dict_size, trg_dict_size, src_lang)
