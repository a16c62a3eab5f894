"""WMT14 EN->FR reader (reference `python/paddle/dataset/wmt14.py:1`): a
copy of `paddle_tpu/dataset/wmt14.py`, so the same arguments give the
same examples in both packages.

API contract matched: ``train(dict_size)`` / ``test(dict_size)`` /
``gen(dict_size)`` readers yielding ``(src_ids, trg_ids, trg_ids_next)``
with the reference's token layout — src = ``<s> words <e>``, trg =
``<s> words``, trg_next = ``words <e>`` — and ``get_dict(dict_size,
reverse)``.  Special ids: <s>=0, <e>=1, <unk>=2 (UNK_IDX, wmt14.py:52).

Synthetic corpus (no downloads in this environment, same policy as the
other dataset readers): a deterministic toy translation — the "French"
sentence is the reversed "English" sentence with a fixed vocabulary
offset — which gives the seq2seq book test a learnable mapping with the
exact WMT14 tensor format.
"""

import numpy as np

__all__ = ["train", "test", "gen", "get_dict"]

START = "<s>"
END = "<e>"
UNK = "<unk>"
START_IDX, END_IDX, UNK_IDX = 0, 1, 2
_RESERVED = 3
_OFFSET = 7            # deterministic src-word -> trg-word mapping


def _word(lang, i):
    return "%s_w%d" % (lang, i)


def _build_dict(lang, dict_size, reverse):
    """Shared vocab builder (wmt16.get_dict delegates here too)."""
    d = {START: START_IDX, END: END_IDX, UNK: UNK_IDX}
    for i in range(_RESERVED, dict_size):
        d[_word(lang, i)] = i
    if reverse:
        return {v: k for k, v in d.items()}
    return d


def get_dict(dict_size, reverse=True):
    """(src_dict, trg_dict); reverse=True gives id->word (reference
    default), reverse=False word->id."""
    return (_build_dict("en", dict_size, reverse),
            _build_dict("fr", dict_size, reverse))


def _trg_of(src_ids, dict_size):
    """Toy translation: reverse + offset (stays clear of reserved ids)."""
    n = dict_size - _RESERVED
    return [(_RESERVED + ((i - _RESERVED + _OFFSET) % n))
            for i in reversed(src_ids)]


def _make(n, dict_size, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = int(rs.randint(3, 10))
        words = rs.randint(_RESERVED, dict_size, size=length).tolist()
        trg = _trg_of(words, dict_size)
        src_ids = [START_IDX] + words + [END_IDX]
        trg_ids = [START_IDX] + trg
        trg_next = trg + [END_IDX]
        out.append((src_ids, trg_ids, trg_next))
    return out


def _creator(dict_size, n, seed):
    def reader():
        for ex in _make(n, dict_size, seed):
            yield ex

    return reader


def train(dict_size, n=512):
    return _creator(dict_size, n, seed=141)


def test(dict_size, n=64):
    return _creator(dict_size, n, seed=142)


def gen(dict_size, n=32):
    return _creator(dict_size, n, seed=143)
