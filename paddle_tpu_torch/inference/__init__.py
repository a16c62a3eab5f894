"""Inference serving of saved static programs: `AnalysisConfig`,
`Predictor`, `create_predictor` (counterpart of
`paddle_tpu/inference/`'s predictor; the bucket-ladder
`InferenceServer` and ``batching.py`` wait for a later slice)."""

from .predictor import (  # noqa: F401
    AnalysisConfig,
    Predictor,
    create_predictor,
    export_stablehlo,
    load_stablehlo,
)
