"""paddle_tpu_torch.analysis — whole-program static verification.

The port's counterpart of the verifier half of `paddle_tpu.analysis`:
`assert_program_valid`, which `fluid.io` runs on every program it saves
or loads and `fluid.ir.apply_passes(verify=True)` after every pass.
The lint rules and the cost model wait for a later slice (ROADMAP
Queue A 6).
"""

from . import opgraph  # noqa: F401
from .diagnostics import (  # noqa: F401
    ERROR,
    INFO,
    WARNING,
    Diagnostic,
    Diagnostics,
    ProgramVerificationError,
)
from .verifier import (  # noqa: F401
    ProgramVerifier,
    assert_program_valid,
    find_orphan_vars,
    verify_program,
)
