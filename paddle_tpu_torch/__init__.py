"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`.

The JAX package stays the reference; this package serves the same
models on an NVIDIA Hopper card.  Plain tensor code is PyTorch; every
Pallas kernel on the ported path is a hand-written CUDA kernel under
``ops/csrc/``, built with nvcc at first use (`ops._build`).

Covered so far: `models.TransformerLM` served through
`generation.GenerationEngine` (bucketed flash prefill, paged and dense
decode), and `models.BertForPretraining` trained by
`distributed.ShardedTrainStep` under `optimizer.AdamWOptimizer` (flash
forward and backward kernels; with ``PADDLE_TPU_FUSED_FFN=1`` the FFN's
fc1 + gelu through the fused-epilogue GEMM kernels,
`nn.functional.fused_linear`), and `models.resnet50` (and the rest of
the ResNet family) served in eval mode, each bottleneck block's 1x1
conv + BN + relu through one kernel (`ops.conv1x1_bn_relu`).  See
README "PyTorch/CUDA port".

Device rule: every entry point takes ``device=``; with none given it is
``"cuda"``, and a box without a CUDA device raises (`device.resolve_device`)
instead of quietly running on the CPU.

Submodules load lazily, so ``import paddle_tpu_torch`` works on a
CPU-only box and imports neither JAX nor `paddle_tpu`.
"""

import importlib

_SUBMODULES = ("device", "distributed", "generation", "models", "nn",
               "observability", "ops", "optimizer")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
