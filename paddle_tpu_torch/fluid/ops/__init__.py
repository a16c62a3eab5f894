"""Op library of the port: importing this package registers every op
the port has.

Counterpart of `paddle_tpu/fluid/ops/`, reduced to the ops a static
BERT, the Fluid book's fit_a_line, recognize_digits,
image_classification, word2vec and recommender_system programs serve
and train with and are initialized by, every op `fluid.layers.ops`
reaches, and the 13 dense optimizer update ops; each op sits in
the file where the reference registers it.  The rest of the reference's library
waits for later slices (ROADMAP Queue A 3).
"""

from . import (  # noqa: F401
    extra_ops,
    linalg_ops,
    math_ops,
    metric_ops,
    nn_ops,
    optimizer_ops,
    random_ops,
    reduce_ops,
    tail_nn_ops,
    tensor_ops,
)
