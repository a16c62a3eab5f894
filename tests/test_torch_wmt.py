"""`paddle_tpu_torch.dataset.wmt14` and `wmt16` held against the JAX
package's readers: the same arguments give the same examples, example
for example, and the same dictionaries (exact equality: both are the
same numpy synthesizer)."""

import pytest

from paddle_tpu.dataset import wmt14 as jax_wmt14
from paddle_tpu.dataset import wmt16 as jax_wmt16
from paddle_tpu_torch import dataset
from paddle_tpu_torch.dataset import wmt14, wmt16


def _examples(reader):
    return [tuple(list(x) for x in ex) for ex in reader()]


def test_the_package_exports_both():
    assert dataset.wmt14 is wmt14 and dataset.wmt16 is wmt16


@pytest.mark.parametrize("split,n", [("train", 512), ("test", 64),
                                     ("gen", 32)])
@pytest.mark.parametrize("dict_size", [30, 1000])
def test_wmt14_readers_equal_the_jax_ones(split, n, dict_size):
    got = _examples(getattr(wmt14, split)(dict_size))
    want = _examples(getattr(jax_wmt14, split)(dict_size))
    assert len(got) == n and got == want
    for src, trg, nxt in got:
        assert src[0] == wmt14.START_IDX and src[-1] == wmt14.END_IDX
        assert trg[1:] == nxt[:-1] and nxt[-1] == wmt14.END_IDX
        assert max(src + trg) < dict_size


@pytest.mark.parametrize("reverse", [True, False])
def test_wmt14_get_dict_equals_the_jax_one(reverse):
    assert wmt14.get_dict(50, reverse) == jax_wmt14.get_dict(50, reverse)
    src, trg = wmt14.get_dict(50)
    assert src[0] == "<s>" and trg[5] == "fr_w5" and len(src) == 50


@pytest.mark.parametrize("split", ["train", "test", "validation"])
@pytest.mark.parametrize("src_lang", ["en", "de"])
def test_wmt16_readers_equal_the_jax_ones(split, src_lang):
    got = _examples(getattr(wmt16, split)(40, 60, src_lang=src_lang, n=48))
    want = _examples(getattr(jax_wmt16, split)(40, 60, src_lang=src_lang,
                                               n=48))
    assert len(got) == 48 and got == want


def test_wmt16_src_lang_swaps_the_direction():
    en = _examples(wmt16.train(40, 40, "en", n=8))
    de = _examples(wmt16.train(40, 40, "de", n=8))
    for (s_en, t_en, _), (s_de, t_de, _) in zip(en, de):
        assert s_en[1:-1] == t_de[1:] and s_de[1:-1] == t_en[1:]


@pytest.mark.parametrize("lang", ["en", "de"])
@pytest.mark.parametrize("reverse", [True, False])
def test_wmt16_get_dict_equals_the_jax_one(lang, reverse):
    assert wmt16.get_dict(lang, 30, reverse) == \
        jax_wmt16.get_dict(lang, 30, reverse)
