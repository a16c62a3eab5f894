"""Models of the port: the decoder-only `TransformerLM` and the BERT
blocks it reuses."""

from .bert import BertConfig, MultiHeadAttention  # noqa: F401
from .convert import from_jax_state_dict, init_params  # noqa: F401
from .transformer_lm import (  # noqa: F401
    TransformerLM,
    TransformerLMBlock,
    TransformerLMConfig,
)
