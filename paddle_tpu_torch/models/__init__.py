"""Models of the port: BERT pretraining, the decoder-only
`TransformerLM`, and the blocks they share."""

from .bert import (  # noqa: F401
    BertConfig,
    BertEmbeddings,
    BertForPretraining,
    BertModel,
    MultiHeadAttention,
    TransformerEncoderLayer,
    convert_legacy_qkv_state_dict,
)
from .convert import (  # noqa: F401
    from_jax_state_dict,
    init_bert_params,
    init_params,
)
from .transformer_lm import (  # noqa: F401
    TransformerLM,
    TransformerLMBlock,
    TransformerLMConfig,
)
