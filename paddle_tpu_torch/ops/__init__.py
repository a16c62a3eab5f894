"""Operators with hand-written CUDA kernels (``csrc/``), each beside its
plain PyTorch version (flash attention, decode attention, the
fused-epilogue GEMM, the 1x1 conv + eval BN + relu, the 1x1 conv + BN
statistics), and the plain ops of the training and ResNet paths
(`nn_ops`).  Each wrapper carries a
``launches`` count that grows by one per kernel launch and nowhere
else."""

from .attention import (  # noqa: F401
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_bwd_fused,
    flash_fwd,
    normalize_segment_ids,
    scaled_dot_product_attention,
)
from .matmul import (  # noqa: F401
    matmul_bias_act,
    matmul_bias_act_bwd_reference,
    matmul_bias_act_fwd,
    matmul_bias_act_reference,
    matmul_bwd_dw,
    matmul_bwd_dx,
)
from .conv_bn import (  # noqa: F401
    conv1x1_bn_relu,
    conv1x1_bn_relu_reference,
    conv1x1_bn_stats,
    conv1x1_bn_stats_reference,
    fold_bn,
)
from .decode_attention import (  # noqa: F401
    decode_attention,
    decode_attention_reference,
)
from .paged_attention import (  # noqa: F401
    chunked_attention_reference,
    dequantize_kv,
    paged_decode_attention,
    paged_decode_attention_reference,
    paged_gather_kv,
    quantize_kv,
)

# kernel name (the csrc/ source it builds from) -> its wrapper
KERNEL_WRAPPERS = {
    "flash_fwd": flash_fwd,
    "flash_bwd_dq": flash_bwd_dq,
    "flash_bwd_dkv": flash_bwd_dkv,
    "flash_bwd_fused": flash_bwd_fused,
    "decode_attention": decode_attention,
    "paged_attention": paged_decode_attention,
    "matmul_bias_act": matmul_bias_act_fwd,
    "matmul_bwd_dx": matmul_bwd_dx,
    "matmul_bwd_dw": matmul_bwd_dw,
    "conv_bn_relu": conv1x1_bn_relu,
    "conv_bn_stats": conv1x1_bn_stats,
}


def launch_counts():
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
