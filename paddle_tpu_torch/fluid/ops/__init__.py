"""Op library of the port: importing this package registers every op
the port has.

Counterpart of `paddle_tpu/fluid/ops/`, reduced to the ops a static
BERT (and a small fc MLP) serves with and is initialized by; each op
sits in the file where the reference registers it.  The rest of the
reference's library waits for later slices (ROADMAP Queue A 3).
"""

from . import math_ops, nn_ops, random_ops, tensor_ops  # noqa: F401
