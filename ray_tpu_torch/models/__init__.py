"""ray_tpu_torch.models: the model families in PyTorch.

Port of ray_tpu.models: the decoder-only transformer (`transformer_init`
builds the module, `transformer_apply` the forward, `make_train_step` an
(init_state, step) pair on one device) and ResNet (`resnet_init`,
`resnet_apply`, and its SGD step `resnet.make_train_step`).
"""

from ray_tpu_torch.models.resnet import (
    ResNet,
    ResNetConfig,
    block_layout,
    resnet_apply,
    resnet_init,
)
from ray_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    TransformerLoss,
    make_train_step,
    transformer_apply,
    transformer_init,
    transformer_loss,
)

__all__ = [
    "ResNet",
    "ResNetConfig",
    "block_layout",
    "resnet_init",
    "resnet_apply",
    "Transformer",
    "TransformerConfig",
    "TransformerLoss",
    "transformer_init",
    "transformer_apply",
    "transformer_loss",
    "make_train_step",
]
