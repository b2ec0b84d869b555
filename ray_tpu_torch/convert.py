"""Carry parameters between the JAX package's tree and the port's module.

`transformer_init` in ray_tpu returns a nested dict whose block leaves are
stacked on a leading [L] layer axis; the port keeps one `Block` per layer,
with the same names and orientation. Both directions go through numpy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.models.transformer import (
    BLOCK_PARAMS,
    Transformer,
    TransformerConfig,
)


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig, device="cuda") -> Transformer:
    """A Transformer holding the arrays of a ray_tpu transformer param tree
    (numpy, or anything np.asarray takes)."""
    model = Transformer(cfg, device)

    def put(param, value):
        value = np.asarray(value, dtype=np.float32)
        if value.shape != tuple(param.shape):
            raise ValueError(f"shape {value.shape} does not fit {tuple(param.shape)}")
        param.copy_(torch.from_numpy(value))

    put(model.embed, tree["embed"])
    put(model.final_norm, tree["final_norm"])
    if not cfg.tied_embeddings:
        put(model.unembed, tree["unembed"])
    for name in BLOCK_PARAMS:
        stacked = np.asarray(tree["blocks"][name])
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks/{name} has {stacked.shape[0]} layers, cfg {cfg.n_layers}")
        for blk, value in zip(model.blocks, stacked):
            put(getattr(blk, name), value)
    return model


def params_to_numpy(model: Transformer, grads: bool = False) -> Dict[str, Any]:
    """The module's parameters (or their .grad) as a ray_tpu-shaped tree of
    numpy arrays, block leaves stacked on a leading [L] axis."""

    def get(p):
        t = p.grad if grads else p
        return t.detach().float().cpu().numpy()

    tree = {
        "embed": get(model.embed),
        "final_norm": get(model.final_norm),
        "blocks": {
            name: np.stack([get(getattr(blk, name)) for blk in model.blocks])
            for name in BLOCK_PARAMS
        },
    }
    if not model.cfg.tied_embeddings:
        tree["unembed"] = get(model.unembed)
    return tree
