"""ray_tpu_torch.models: the flagship model family in PyTorch.

Port of ray_tpu.models: the decoder-only transformer. `transformer_init`
builds the module, `transformer_apply` the forward and `make_train_step`
an (init_state, step) pair on one device. ResNet comes in a later slice.
"""

from ray_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    make_train_step,
    transformer_apply,
    transformer_init,
    transformer_loss,
)

__all__ = [
    "Transformer",
    "TransformerConfig",
    "transformer_init",
    "transformer_apply",
    "transformer_loss",
    "make_train_step",
]
