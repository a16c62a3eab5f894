"""``vjp_grad`` of the ops `fluid.layers.ops` reaches, held against the
JAX ``vjp_grad`` on the CPU: each case of
`tests/test_torch_static_surface.py` whose op differentiates a
floating input, with the harness of `tests/test_torch_static_backward.py`
(seeded cotangents on every floating output; the port's forward
recomputed and read from a tape; 1e-5).  A file of its own so that the
two files' cases run on two workers.
"""

import pytest

from test_torch_static_backward import assert_vjp_grad_matches, grad_cases
from test_torch_static_surface import SURFACE
from torch_static_common import jax_state_unchanged


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


@pytest.mark.parametrize("case", grad_cases(SURFACE))
@pytest.mark.parametrize("taped", [False, True])
def test_surface_vjp_grad_matches_the_jax_vjp_grad(case, taped):
    assert_vjp_grad_matches(case, *SURFACE[case], taped)
