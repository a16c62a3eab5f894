"""Dataset readers with the reference `python/paddle/dataset/` API.

Copies of `paddle_tpu/dataset/`'s numpy synthesizers (the reference
modules download public corpora; these synthesize deterministic data
of the same shapes, dtypes and reader-creator protocol, so the same
seeds give the same examples in both packages): `train()` / `test()`
return zero-arg callables producing example generators, what
`paddle_tpu_torch.batch(...)` and the Fluid book's programs consume.
The other dataset modules wait for the programs that read them.
"""

from . import (  # noqa: F401
    cifar, imikolov, mnist, movielens, uci_housing, wmt14, wmt16)
