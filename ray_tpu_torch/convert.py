"""Carry parameters between the JAX package's trees and the port's modules.

`transformer_init` in ray_tpu returns a nested dict whose block leaves are
stacked on a leading [L] layer axis; the port keeps one `Block` per layer,
with the same names and orientation. `resnet_init` returns a dict with a
list of block dicts; the port keeps the names, with convolution weights
OIHW where the reference's are HWIO and each batch norm's running mean and
var as buffers. An RLlib module's params are lists of {"w": [in, out], "b"}
per net (plus SAC's `log_alpha`); the port's modules hold each as a Dense
layer with `weight` [out, in]. Both directions go through numpy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.models.resnet import ResNet, ResNetConfig
from ray_tpu_torch.models.transformer import (
    BLOCK_PARAMS,
    Transformer,
    TransformerConfig,
)
from ray_tpu_torch.rllib.core import rl_module


def _put(tensor, value) -> None:
    value = np.asarray(value, dtype=np.float32)
    if value.shape != tuple(tensor.shape):
        raise ValueError(f"shape {value.shape} does not fit {tuple(tensor.shape)}")
    tensor.copy_(torch.from_numpy(value))


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig, device="cuda") -> Transformer:
    """A Transformer holding the arrays of a ray_tpu transformer param tree
    (numpy, or anything np.asarray takes)."""
    model = Transformer(cfg, device)
    _put(model.embed, tree["embed"])
    _put(model.final_norm, tree["final_norm"])
    if not cfg.tied_embeddings:
        _put(model.unembed, tree["unembed"])
    for name in BLOCK_PARAMS:
        stacked = np.asarray(tree["blocks"][name])
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks/{name} has {stacked.shape[0]} layers, cfg {cfg.n_layers}")
        for blk, value in zip(model.blocks, stacked):
            _put(getattr(blk, name), value)
    return model


def params_to_numpy(model: Transformer, grads: bool = False) -> Dict[str, Any]:
    """The module's parameters (or their .grad) as a ray_tpu-shaped tree of
    numpy arrays, block leaves stacked on a leading [L] axis. A model placed
    on a mesh gives whole arrays, gathered from every rank's shards, as
    `jax.tree.map(np.array, params)` does: every rank of the mesh calls it."""
    layout = getattr(model, "layout", None)
    whole = {}
    for name, p in model.named_parameters():
        t = p.grad if grads else p
        if layout is not None:
            t = layout.gather(name, t)
        whole[name] = t.detach().float().cpu().numpy().copy()  # not a view of the live weight
    tree = {
        "embed": whole["embed"],
        "final_norm": whole["final_norm"],
        "blocks": {
            name: np.stack([whole[f"blocks.{i}.{name}"] for i in range(len(model.blocks))])
            for name in BLOCK_PARAMS
        },
    }
    if not model.cfg.tied_embeddings:
        tree["unembed"] = whole["unembed"]
    return tree


def _resnet_leaves(model: ResNet):
    """(path in the reference tree, tensor, is a convolution weight) of
    every parameter and batch-norm buffer of `model`."""
    for name, t in model.state_dict(keep_vars=True).items():
        path = name.split(".")
        if path[0] == "blocks":
            path[1] = int(path[1])
        yield path, t, t.dim() == 4


@torch.no_grad()
def resnet_params_from_jax(tree: Dict[str, Any], cfg: ResNetConfig, device="cuda") -> ResNet:
    """A ResNet holding the arrays of a ray_tpu resnet param tree (numpy,
    or anything np.asarray takes): HWIO convolutions go to OIHW, every
    other leaf as it is."""
    model = ResNet(cfg, device)
    if len(tree["blocks"]) != len(model.blocks):
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, cfg {len(model.blocks)}")
    for path, t, conv in _resnet_leaves(model):
        value = tree
        for key in path:
            value = value[key]
        value = np.asarray(value)
        _put(t, value.transpose(3, 2, 0, 1) if conv else value)
    return model


def resnet_params_to_numpy(model: ResNet, grads: bool = False) -> Dict[str, Any]:
    """The module's parameters and batch-norm statistics as a ray_tpu-shaped
    tree of numpy arrays (convolutions HWIO). With grads=True, the
    parameters' .grad instead, and no statistics: they have none."""
    tree: Dict[str, Any] = {"blocks": [{} for _ in model.blocks]}
    for path, t, conv in _resnet_leaves(model):
        if grads:
            if not isinstance(t, torch.nn.Parameter):
                continue
            t = t.grad
        value = t.detach().to(torch.promote_types(t.dtype, torch.float32)).cpu().numpy()
        if conv:
            value = value.transpose(2, 3, 1, 0)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {}) if isinstance(node, dict) else node[key]
        node[path[-1]] = np.ascontiguousarray(value)
    return tree


def rl_module_from_jax(params: Dict[str, Any], spec: rl_module.RLModuleSpec, kind: str,
                       device="cuda") -> torch.nn.Module:
    """The RLlib module of `kind` ("pi_vf", "q" or "sac") for `spec`, holding
    a ray_tpu.rllib param tree (numpy, or anything np.asarray takes)."""
    module = rl_module.make_module(kind, spec, torch.Generator().manual_seed(0))
    return rl_module.load_tree(module, params).to(device)


def rl_module_to_numpy(module: torch.nn.Module, grads: bool = False) -> Dict[str, Any]:
    """The module's parameters (or their .grad) as a ray_tpu.rllib-shaped
    tree of numpy arrays."""
    return rl_module.tree_of(module, (lambda p: p.grad) if grads else None)
