"""Decoder-only transformer (GPT family) in PyTorch.

Port of ray_tpu/models/transformer.py: pre-norm decoder blocks with RoPE,
grouped-query attention, SwiGLU MLP, bf16 compute on f32 master weights,
tied embeddings. Attention goes through the hand-written flash kernels
(ray_tpu_torch/ops/flash_attention.py) on the card.

The parameters keep the reference's names and orientation (x @ w), one
`Block` per layer where the reference stacks them on a leading [L] axis, so
`ray_tpu_torch.convert.params_from_jax` loads a JAX tree by plain copies.
The mesh (param_shardings, logical axes) and ring attention come later.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops.flash_attention import mha
from ray_tpu_torch.ops.fused import fused_rmsnorm, lm_head_cross_entropy


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 6
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # None => MHA
    d_ff: Optional[int] = None  # None => 4 * d_model (SwiGLU sized 2/3)
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    dtype: torch.dtype = torch.bfloat16  # compute/activation dtype
    remat: bool = False  # torch.utils.checkpoint each block
    attention_impl: str = "auto"  # auto | kernel | torch
    norm_eps: float = 1e-6
    tied_embeddings: bool = True

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        return int(8 * self.d_model / 3 + 127) // 128 * 128  # SwiGLU, 128-mult


# ------------------------------------------------------------------ params

BLOCK_PARAMS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")


def _block_shapes(cfg: TransformerConfig):
    d, h, hk, dh, f = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.ff_dim
    return {
        "attn_norm": (d,), "wq": (d, h * dh), "wk": (d, hk * dh), "wv": (d, hk * dh),
        "wo": (h * dh, d), "mlp_norm": (d,), "w_gate": (d, f), "w_up": (d, f),
        "w_down": (f, d),
    }


class Block(nn.Module):
    """One pre-norm decoder block; f32 master weights."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.cfg = cfg
        for name, shape in _block_shapes(cfg).items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))
            )

    def forward(self, x, positions):
        return _block(x, self, positions, self.cfg)


class Transformer(nn.Module):
    """Parameters of the model: embed [V, d], blocks, final_norm [d] and,
    untied, unembed [d, V]. The forward gives f32 logits."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        f32 = dict(dtype=torch.float32, device=device)
        self.embed = nn.Parameter(torch.empty((cfg.vocab_size, cfg.d_model), **f32))
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.empty((cfg.d_model,), **f32))
        if not cfg.tied_embeddings:
            self.unembed = nn.Parameter(torch.empty((cfg.d_model, cfg.vocab_size), **f32))

    def forward(self, tokens, positions=None):
        return transformer_apply(self, tokens, positions=positions)


@torch.no_grad()
def transformer_init(cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
                     *, device="cuda") -> Transformer:
    """f32 master params, drawn as the reference draws them (normal / sqrt(fan_in),
    embed normal * 0.02, norms at 1) from `generator` (seed 0 if None). The
    numbers differ from jax.random's; tests carry JAX's over with
    `params_from_jax` instead."""
    model = Transformer(cfg, device)
    dev = model.embed.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=dev) * std)

    normal(model.embed, 0.02)
    for blk in model.blocks:
        for name in BLOCK_PARAMS:
            p = getattr(blk, name)
            if name.endswith("norm"):
                p.fill_(1.0)
            else:
                normal(p, 1.0 / math.sqrt(p.shape[0]))
    model.final_norm.fill_(1.0)
    if not cfg.tied_embeddings:
        normal(model.unembed, 1.0 / math.sqrt(cfg.d_model))
    return model


# ----------------------------------------------------------------- forward

def _rope(x, positions, theta: float):
    """Rotary embedding on [B, T, H, Dh] with integer positions [B, T]
    (half-split convention, f32 angles)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _block(x, blk: Block, positions, cfg: TransformerConfig):
    B, T, d = x.shape
    h, hk, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    dt = cfg.dtype

    y = fused_rmsnorm(x, blk.attn_norm, eps=cfg.norm_eps)
    q = (y @ blk.wq.to(dt)).reshape(B, T, h, dh)
    k = (y @ blk.wk.to(dt)).reshape(B, T, hk, dh)
    v = (y @ blk.wv.to(dt)).reshape(B, T, hk, dh)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = mha(q, k, v, causal=True, impl=cfg.attention_impl)
    x = x + o.reshape(B, T, h * dh) @ blk.wo.to(dt)

    y = fused_rmsnorm(x, blk.mlp_norm, eps=cfg.norm_eps)
    gate = F.silu(y @ blk.w_gate.to(dt))
    up = y @ blk.w_up.to(dt)
    return x + (gate * up) @ blk.w_down.to(dt)


def transformer_hidden(model: Transformer, tokens, positions=None):
    """Forward through the blocks: [B, T] tokens -> [B, T, d] normed hidden."""
    cfg = model.cfg
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    x = F.embedding(tokens, model.embed.to(cfg.dtype))
    for blk in model.blocks:
        if cfg.remat:
            x = checkpoint(blk, x, positions, use_reentrant=False)
        else:
            x = blk(x, positions)
    return fused_rmsnorm(x, model.final_norm, eps=cfg.norm_eps)


def _unembed(model: Transformer):
    return model.embed.T if model.cfg.tied_embeddings else model.unembed


def transformer_apply(model: Transformer, tokens, positions=None):
    """Forward: [B, T] integer tokens -> [B, T, vocab] logits (f32)."""
    x = transformer_hidden(model, tokens, positions=positions)
    return (x @ _unembed(model).to(model.cfg.dtype)).float()


def transformer_loss(model: Transformer, batch):
    """Next-token CE. batch: {'tokens': [B, T+1]} or {'tokens', 'targets'}.

    Uses the chunked LM-head CE (ops/fused.py lm_head_cross_entropy), so the
    [B*T, V] f32 logits are never materialized."""
    if "targets" in batch:
        tokens, targets = batch["tokens"], batch["targets"]
    else:
        tokens, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    hidden = transformer_hidden(model, tokens)
    loss, _ = lm_head_cross_entropy(hidden, _unembed(model), targets)
    return loss


# -------------------------------------------------------------- train step

def adamw(params, lr: float = 3e-4, weight_decay: float = 0.01) -> torch.optim.Optimizer:
    """The reference's optax.adamw(lr, weight_decay=0.01), on every parameter."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def make_train_step(cfg: TransformerConfig, device="cuda",
                    optimizer: Optional[Callable] = None):
    """Build (init_state, step) on one device.

    optimizer: a callable params -> torch.optim.Optimizer (default `adamw`).
    init_state(generator=None, *, model=None) -> {'model', 'opt', 'step'};
    a given model (e.g. from params_from_jax) is used as it is.
    step(state, batch) -> (state, {'loss', 'grad_norm'}): the parameters and
    the optimizer state are updated in place, where the reference donates
    its buffers.
    """
    device = resolve_device(device)
    if optimizer is None:
        optimizer = adamw

    def init_state(generator: Optional[torch.Generator] = None, *, model=None):
        if model is None:
            model = transformer_init(cfg, generator, device=device)
        elif model.embed.device.type != device.type:
            raise ValueError(f"model is on {model.embed.device}, the step on {device}")
        return {"model": model, "opt": optimizer(list(model.parameters())), "step": 0}

    def step(state, batch):
        model, opt = state["model"], state["opt"]
        loss = transformer_loss(model, batch)
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        opt.step()
        opt.zero_grad(set_to_none=True)
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return init_state, step


def _fwd_flops_per_token(cfg: TransformerConfig, seq_len: int):
    """(matmul fwd flops/token per layer, causal attn fwd flops/token per
    layer, lm-head fwd flops/token)."""
    d, f = cfg.d_model, cfg.ff_dim
    h, hk, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    per_layer = 2 * d * (h * dh + 2 * hk * dh) + 2 * h * dh * d + 2 * 3 * d * f
    # Causal attention: token t attends to t+1 keys, so the average query
    # sees (seq_len + 1) / 2 positions; qk^T and pv each cost 2*h*dh flops
    # per (query, key) pair. The flash kernels skip the masked-out tiles.
    attn = 2 * 2 * h * dh * ((seq_len + 1) / 2)
    embed = 2 * d * cfg.vocab_size
    return per_layer, attn, embed


def flops_per_token(cfg: TransformerConfig, seq_len: int) -> float:
    """USEFUL train FLOPs/token: 6ND rule + CAUSAL attention quadratic term.

    1 forward + backward at 2x forward. Recomputation (remat, flash-backward
    recompute) is excluded: this is the numerator of useful-MFU. Use
    hardware_flops_per_token for what the card actually executes.
    """
    per_layer, attn, embed = _fwd_flops_per_token(cfg, seq_len)
    return 3 * (cfg.n_layers * (per_layer + attn) + embed)


def hardware_flops_per_token(
    cfg: TransformerConfig, seq_len: int, remat: Optional[bool] = None
) -> float:
    """Actually-executed train FLOPs/token, including recomputation:

    - the flash-attention backward recomputes the attention forward: +1
      attention fwd per layer, always;
    - per-block remat (cfg.remat) recomputes the whole block forward during
      the backward: +1 block fwd per layer.

    hardware-MFU = hardware_flops_per_token * tokens/s / peak must come out
    below 1.0.
    """
    if remat is None:
        remat = cfg.remat
    per_layer, attn, embed = _fwd_flops_per_token(cfg, seq_len)
    fwd_layer = per_layer + attn
    extra = cfg.n_layers * attn  # flash bwd recompute
    if remat:
        extra += cfg.n_layers * fwd_layer  # block fwd recompute
    return 3 * (cfg.n_layers * fwd_layer + embed) + extra
