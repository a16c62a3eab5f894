"""Operators with hand-written CUDA kernels (``csrc/``), each beside its
plain PyTorch version.  Each wrapper carries a ``launches`` count that
grows by one per kernel launch and nowhere else."""

from .attention import (  # noqa: F401
    flash_attention,
    naive_attention_with_layout,
    scaled_dot_product_attention,
)
from .decode_attention import (  # noqa: F401
    decode_attention,
    decode_attention_reference,
)
from .paged_attention import (  # noqa: F401
    paged_decode_attention,
    paged_decode_attention_reference,
    paged_gather_kv,
)

# kernel name (the csrc/ source it builds from) -> its wrapper
KERNEL_WRAPPERS = {
    "flash_fwd": flash_attention,
    "decode_attention": decode_attention,
    "paged_attention": paged_decode_attention,
}


def launch_counts():
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
