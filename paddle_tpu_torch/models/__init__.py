"""Models of the port: BERT pretraining, the decoder-only
`TransformerLM`, the blocks they share, the WMT encoder-decoder
`Transformer`, and the vision zoo (the ResNet family, LeNet-5, VGG,
MobileNetV1); BERT (`bert_program`) and the WMT Transformer
(`transformer_program`) as static programs.  Every name of
`paddle_tpu.models` is here but ``MoEFFN`` (expert parallelism comes
with a later slice)."""

from . import bert_program  # noqa: F401

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
    init_mobilenet_params,
    init_params,
    init_resnet_params,
    init_transformer_params,
    init_vision_params,
    program_params_from_eager,
    train_state_from_jax,
)
from .lenet import LeNet5  # noqa: F401
from .mobilenet import MobileNetV1, mobilenet_v1  # noqa: F401
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
from .transformer import (  # noqa: F401
    DecoderLayer,
    EncoderLayer,
    Transformer,
    TransformerConfig,
)
from .transformer_program import transformer_program  # noqa: F401
from .transformer_lm import (  # noqa: F401
    TransformerLM,
    TransformerLMBlock,
    TransformerLMConfig,
)
from .vgg import VGG, vgg16, vgg19  # noqa: F401
