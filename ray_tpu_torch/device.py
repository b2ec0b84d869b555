"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without a
card, asking for CUDA (the default) raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: ray_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ray_tpu_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev
