"""PTB language-model reader (reference `python/paddle/dataset/
imikolov.py:1`): build_dict + n-gram / sequence readers.  Synthetic
markov-ish corpus with a Zipf vocabulary, deterministic per split."""

import numpy as np

__all__ = ["train", "test", "build_dict", "DataType"]


class DataType:
    NGRAM = 1
    SEQ = 2


_VOCAB = 200


def build_dict(min_word_freq=50):
    """word -> id; '<unk>' and '<e>' reserved like the reference."""
    d = {"w%d" % i: i for i in range(_VOCAB - 2)}
    d["<unk>"] = _VOCAB - 2
    d["<e>"] = _VOCAB - 1
    return d


def _sentences(n, seed, vocab_n):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ln = int(rs.randint(4, 20))
        s = [int(rs.zipf(1.5)) % vocab_n]
        for _ in range(ln - 1):
            s.append((s[-1] * 31 + int(rs.randint(0, 7))) % vocab_n)
        out.append(s)
    return out


def _creator(n, seed, word_idx, gram_n, data_type):
    vocab_n = max(word_idx.values()) + 1
    e_id = word_idx.get("<e>", vocab_n - 1)

    def reader():
        for s in _sentences(n, seed, vocab_n - 2):
            if data_type == DataType.NGRAM:
                if len(s) >= gram_n:
                    for i in range(gram_n - 1, len(s)):
                        yield tuple(s[i - gram_n + 1: i + 1])
            elif data_type == DataType.SEQ:
                src = s + [e_id]
                yield src[:-1], src[1:]
            else:
                raise ValueError("unknown data type %r" % data_type)

    return reader


def train(word_idx, n, data_type=DataType.NGRAM, n_sentences=256):
    return _creator(n_sentences, 91, word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM, n_sentences=64):
    return _creator(n_sentences, 92, word_idx, n, data_type)
