"""ray_tpu_torch: the port of ray_tpu to PyTorch and CUDA on NVIDIA Hopper.

This slice holds the flagship transformer's train step: `ops` (flash
attention with hand-written CUDA kernels, RMSNorm, chunked cross entropy)
and `models` (the transformer). It imports neither jax nor ray_tpu.
"""

from ray_tpu_torch import models, ops

__all__ = ["models", "ops"]
