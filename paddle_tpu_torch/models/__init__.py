"""Models of the port: BERT pretraining, the decoder-only
`TransformerLM`, the blocks they share, and the ResNet family."""

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
    init_resnet_params,
    train_state_from_jax,
)
from .resnet import (  # noqa: F401
    BasicBlock,
    BottleneckBlock,
    ConvBNLayer,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from .transformer_lm import (  # noqa: F401
    TransformerLM,
    TransformerLMBlock,
    TransformerLMConfig,
)
