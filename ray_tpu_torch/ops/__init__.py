"""ray_tpu_torch.ops: the hot ops, with hand-written CUDA kernels for Hopper.

Port of ray_tpu.ops. Attention runs through the CUDA kernels of
`csrc/flash_attention.cu` for CUDA tensors and through their plain PyTorch
versions for CPU tensors; RMSNorm and the chunked cross entropy are torch ops.
"""

from ray_tpu_torch.ops.flash_attention import flash_attention, mha
from ray_tpu_torch.ops.fused import (
    fused_rmsnorm,
    lm_head_cross_entropy,
    softmax_cross_entropy,
)

__all__ = [
    "flash_attention",
    "mha",
    "fused_rmsnorm",
    "lm_head_cross_entropy",
    "softmax_cross_entropy",
]
