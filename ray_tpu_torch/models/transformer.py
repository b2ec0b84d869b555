"""Decoder-only transformer (GPT family) in PyTorch.

Port of ray_tpu/models/transformer.py: pre-norm decoder blocks with RoPE,
grouped-query attention, SwiGLU MLP, bf16 compute on f32 master weights,
tied embeddings. Attention goes through the hand-written flash kernels
(ray_tpu_torch/ops/flash_attention.py) on the card.

The parameters keep the reference's names and orientation (x @ w), one
`Block` per layer where the reference stacks them on a leading [L] axis, so
`ray_tpu_torch.convert.params_from_jax` loads a JAX tree by plain copies.

On a mesh (`make_train_step(..., mesh=...)`, axes of ray_tpu_torch.parallel):
  data/fsdp — batch split; FSDP2 `fully_shard` over the (data, fsdp)
              sub-mesh, replicating over data and sharding each parameter's
              `embed` dim over fsdp (the norms stay whole); a mesh without
              fsdp gets an fsdp axis of one device for it
  tensor    — heads + mlp hidden + vocab split (Megatron layout, each shard a
              plain local Parameter, the collectives of parallel/tensor_parallel)
  sequence  — tokens split on T; attention runs the ring over global positions
              (the mesh's sequence axis chooses the ring, where the
              reference's attention_impl="ring" does; attention_impl then
              chooses the kernels or plain torch for each hop)
`_LOGICAL_AXES` and `param_shardings` give each parameter's layout, as the
reference's do. The reference's XLA computes exact causal attention over a
sharded sequence by gathering; the port computes it with ring attention.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops.flash_attention import mha
from ray_tpu_torch.ops.fused import fused_rmsnorm, lm_head_cross_entropy
from ray_tpu_torch.parallel import mesh as mesh_lib
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.tensor_parallel import all_reduce_, copy_to, gather_from, reduce_from


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
    attention_impl: str = "auto"  # auto | kernel | torch (also inside the ring)
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

    def forward(self, x, positions, layout=None):
        return _block(x, self, positions, self.cfg, layout)


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


# Logical axes of each parameter, by its last name (the reference's table
# without the stacked "layers" axis: one Block per layer here).
_LOGICAL_AXES = {
    "embed": ("vocab", "embed"),
    "unembed": ("embed", "vocab"),
    "final_norm": (None,),
    "attn_norm": (None,),
    "wq": ("embed", "heads"),
    "wk": ("embed", "kv"),
    "wv": ("embed", "kv"),
    "wo": ("heads", "embed"),
    "mlp_norm": (None,),
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
}


def _param_names(cfg: TransformerConfig):
    """The Transformer's parameter names, in named_parameters' order."""
    names = ["embed"]
    names += [f"blocks.{i}.{p}" for i in range(cfg.n_layers) for p in BLOCK_PARAMS]
    names.append("final_norm")
    if not cfg.tied_embeddings:
        names.append("unembed")
    return names


def param_shardings(mesh, cfg: TransformerConfig) -> Dict[str, tuple]:
    """{parameter name: per dim, the mesh axis (or axes, or None) it splits
    over}, from the logical-axis table + default_transformer_rules."""
    rules = mesh_lib.default_transformer_rules(mesh)
    return {n: rules.spec(_LOGICAL_AXES[n.rsplit(".", 1)[-1]]) for n in _param_names(cfg)}


def _dim_over(spec: tuple, axis: str) -> Optional[int]:
    """The dim of `spec` that splits over mesh axis `axis`, or None."""
    for d, a in enumerate(spec):
        if a == axis or (isinstance(a, tuple) and axis in a):
            return d
    return None


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


def _attention(q, k, v, cfg: TransformerConfig, layout):
    if layout is not None and layout.seq is not None:
        # Tokens split on T: exact causal attention in global positions
        # around the ring, kv heads repeated first as the reference does.
        rep = q.shape[2] // k.shape[2]
        if rep > 1:
            k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        impl = "plain" if cfg.attention_impl == "torch" else cfg.attention_impl
        return ring_attention(q, k, v, layout.seq, causal=True, impl=impl)
    return mha(q, k, v, causal=True, impl=cfg.attention_impl)


def _block(x, blk: Block, positions, cfg: TransformerConfig, layout=None):
    B, T, d = x.shape
    t = 1 if layout is None else layout.t_size
    h, hk, dh = cfg.n_heads // t, cfg.kv_heads // t, cfg.head_dim
    dt = cfg.dtype
    tp = None if layout is None else layout.tensor
    wk, wv = blk.wk, blk.wv
    if t > 1:  # this rank's kv heads, those of its q heads
        cols = slice(layout.t_rank * hk * dh, (layout.t_rank + 1) * hk * dh)
        wk, wv = wk[:, cols], wv[:, cols]

    y = copy_to(fused_rmsnorm(x, blk.attn_norm, eps=cfg.norm_eps), tp)
    q = (y @ blk.wq.to(dt)).reshape(B, T, h, dh)
    k = (y @ wk.to(dt)).reshape(B, T, hk, dh)
    v = (y @ wv.to(dt)).reshape(B, T, hk, dh)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = _attention(q, k, v, cfg, layout)
    x = x + reduce_from(o.reshape(B, T, h * dh) @ blk.wo.to(dt), tp)

    y = copy_to(fused_rmsnorm(x, blk.mlp_norm, eps=cfg.norm_eps), tp)
    gate = F.silu(y @ blk.w_gate.to(dt))
    up = y @ blk.w_up.to(dt)
    return x + reduce_from((gate * up) @ blk.w_down.to(dt), tp)


def transformer_hidden(model: Transformer, tokens, positions=None):
    """Forward through the blocks: [B, T] tokens -> [B, T, d] normed hidden.
    On a mesh, `tokens` are this rank's and the positions global."""
    cfg = model.cfg
    layout = getattr(model, "layout", None)
    B, T = tokens.shape
    if positions is None:
        start = 0 if layout is None else layout.s_rank * T
        positions = torch.arange(start, start + T, dtype=torch.int32,
                                 device=tokens.device).expand(B, T)
    x = F.embedding(tokens, _vocab_whole(model, model.embed, 0).to(cfg.dtype))
    for blk in model.blocks:
        if cfg.remat:
            x = checkpoint(blk, x, positions, layout, use_reentrant=False)
        else:
            x = blk(x, positions, layout)
    return fused_rmsnorm(x, model.final_norm, eps=cfg.norm_eps)


def _vocab_whole(model: Transformer, w, dim: int):
    """A vocab-sharded weight whole: gathered over tensor on a mesh."""
    layout = getattr(model, "layout", None)
    return w if layout is None else gather_from(w, layout.tensor, dim)


def _unembed(model: Transformer):
    if model.cfg.tied_embeddings:
        return _vocab_whole(model, model.embed, 0).T
    return _vocab_whole(model, model.unembed, 1)


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


class TransformerLoss(nn.Module):
    """`transformer_loss` as a module's forward. A data-parallel wrapper
    (DistributedDataParallel) reduces the gradients only of what runs
    through its own forward, so the train step computes its loss through
    this module, wrapped or not."""

    def __init__(self, model: Transformer):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return transformer_loss(self.model, batch)


class _Layout:
    """How a model lies on a mesh, and the collectives its step makes.

    Every gradient ends as the mean over the ranks that hold different
    tokens (data, fsdp, sequence) of each rank's gradient of its own mean
    loss, which is the gradient of the global mean loss:
    - FSDP2 averages its parameters' gradients over (data, fsdp); the norms,
      which it does not shard, are averaged here over (data, fsdp);
    - every gradient is averaged here over sequence;
    - wk and wv, whole on every tensor rank, get gradients only in the
      columns of the rank's own kv heads: summed here over tensor.
    """

    def __init__(self, mesh, cfg: TransformerConfig):
        self.mesh = mesh
        self.specs = param_shardings(mesh, cfg)
        self.tensor = mesh_lib.axis_group(mesh, mesh_lib.TENSOR)
        self.t_rank = mesh_lib.axis_rank(mesh, mesh_lib.TENSOR)
        self.t_size = mesh_lib.axis_size(mesh, mesh_lib.TENSOR)
        self.seq = mesh_lib.axis_group(mesh, mesh_lib.SEQUENCE)
        self.s_rank = mesh_lib.axis_rank(mesh, mesh_lib.SEQUENCE)
        self.s_size = mesh_lib.axis_size(mesh, mesh_lib.SEQUENCE)
        self.dp = [a for a in (mesh_lib.DATA, mesh_lib.FSDP) if a in mesh.mesh_dim_names]
        rep = cfg.n_heads // cfg.kv_heads
        if cfg.n_heads % self.t_size or (cfg.n_heads // self.t_size) % rep:
            raise ValueError(
                f"tensor size {self.t_size} must split {cfg.n_heads} query heads into groups "
                f"of whole kv heads ({rep} query heads each)")

    def tensor_dim(self, name: str) -> Optional[int]:
        return _dim_over(self.specs[name], mesh_lib.TENSOR)

    @torch.no_grad()
    def place(self, loss_fn: "TransformerLoss") -> None:
        """Cut every tensor-sharded parameter to this rank's shard, then
        fully_shard each block and the root over the (data, fsdp) sub-mesh,
        each parameter on its `embed` dim; the norms stay whole."""
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        model = loss_fn.model
        for name, p in list(model.named_parameters()):
            d = self.tensor_dim(name)
            if d is None or self.t_size == 1:
                continue
            if p.shape[d] % self.t_size:
                raise ValueError(f"{name} {tuple(p.shape)}: dim {d} does not split over "
                                 f"tensor {self.t_size}")
            owner, attr = model.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2]
            setattr(owner, attr, nn.Parameter(p.chunk(self.t_size, dim=d)[self.t_rank].clone()))
        model.layout = self
        if not self.dp:
            return
        dp_mesh = self._dp_mesh()
        specs = param_shardings(dp_mesh, model.cfg)
        dims = {p: _dim_over(specs[n], mesh_lib.FSDP) for n, p in model.named_parameters()}
        whole = {p for p, d in dims.items() if d is None}
        for m in (*model.blocks, loss_fn):
            fully_shard(m, mesh=dp_mesh, shard_placement_fn=lambda p: Shard(dims[p]),
                        ignored_params=whole)

    def _dp_mesh(self):
        """The (data, fsdp) sub-mesh FSDP2 runs on. A mesh without an fsdp
        axis gets one of size 1, so that its data axis too averages the
        gradients during the backward (HSDP, replicated over data)."""
        if mesh_lib.FSDP in self.mesh.mesh_dim_names:
            return self.mesh[tuple(self.dp)]
        n = mesh_lib.axis_size(self.mesh, mesh_lib.DATA)
        return self.mesh[mesh_lib.DATA]._unflatten(0, (n, 1), (mesh_lib.DATA, mesh_lib.FSDP))

    def local_batch(self, batch):
        """This rank's tokens and targets of a global batch."""
        if "targets" in batch:
            tokens, targets = batch["tokens"], batch["targets"]
        else:
            tokens, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        return {"tokens": mesh_lib.batch_slice(self.mesh, tokens),
                "targets": mesh_lib.batch_slice(self.mesh, targets)}

    def _grads(self, model):
        """(name, local gradient, averaged by FSDP) of every parameter."""
        from torch.distributed.tensor import DTensor

        for name, p in model.named_parameters():
            g = p.grad
            yield name, (g.to_local() if isinstance(g, DTensor) else g), isinstance(g, DTensor)

    def reduce_grads(self, model) -> None:
        grads = list(self._grads(model))
        if self.t_size > 1:
            all_reduce_([g for n, g, _ in grads if "kv" in _LOGICAL_AXES[n.rsplit(".", 1)[-1]]],
                        self.tensor)
        for axis in self.dp:
            n = mesh_lib.axis_size(self.mesh, axis)
            if n > 1:
                all_reduce_([g for _, g, by_fsdp in grads if not by_fsdp],
                            self.mesh.get_group(axis), 1.0 / n)
        all_reduce_([g for _, g, _ in grads], self.seq, 1.0 / self.s_size)

    def grad_norm(self, model) -> torch.Tensor:
        """The global norm: each shard's sum of squares summed over the axes
        that shard it, each replicated gradient counted once."""
        import torch.distributed as dist

        total = 0.0
        buckets: Dict[tuple, list] = {}
        for name, g, by_fsdp in self._grads(model):
            key = (by_fsdp, self.t_size > 1 and self.tensor_dim(name) is not None)
            buckets.setdefault(key, []).append(torch.linalg.vector_norm(g) ** 2)
        for (by_fsdp, by_tensor), sq in buckets.items():
            s = torch.stack(sq).sum()
            for group in ((mesh_lib.axis_group(self.mesh, mesh_lib.FSDP) if by_fsdp else None),
                          (self.tensor if by_tensor else None)):
                if group is not None:
                    dist.all_reduce(s, group=group)
            total = total + s
        return torch.sqrt(total)

    def mean_loss(self, loss) -> torch.Tensor:
        """The global mean loss: the mean of every rank's (tensor ranks hold
        equal ones)."""
        import torch.distributed as dist

        world = dist.get_world_size()
        if world == 1:
            return loss
        loss = loss.detach().clone()
        dist.all_reduce(loss)
        return loss / world

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A parameter (or gradient) of this layout whole on every rank."""
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t.full_tensor()
        d = self.tensor_dim(name)
        if d is None or self.t_size == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.t_size)]
        dist.all_gather(parts, t.contiguous(), group=self.tensor)
        return torch.cat(parts, dim=d)


def _param_groups(model):
    """The optimizer's parameters: a list, or, on a mesh, one group of FSDP's
    sharded DTensors and one of plain tensors (a foreach update takes no
    mix of the two)."""
    params = list(model.parameters())
    if getattr(model, "layout", None) is None:
        return params
    from torch.distributed.tensor import DTensor

    groups = [[p for p in params if isinstance(p, DTensor)],
              [p for p in params if not isinstance(p, DTensor)]]
    return [{"params": g} for g in groups if g]


def make_train_step(cfg: TransformerConfig, device="cuda",
                    optimizer: Optional[Callable] = None,
                    wrap: Optional[Callable] = None, *, mesh=None):
    """Build (init_state, step) on one device, or on a mesh.

    optimizer: a callable params -> torch.optim.Optimizer (default `adamw`);
    on a mesh it gets a list of param groups.
    wrap: a callable nn.Module -> nn.Module applied to the model's
    `TransformerLoss`, e.g. `ray_tpu_torch.train.torch.prepare_model`, which
    wraps it in DistributedDataParallel in a gang of more than one worker;
    the step computes the loss through what it returns.
    mesh: a DeviceMesh (ray_tpu_torch.parallel.make_mesh), whose device type
    replaces `device`; init_state places the whole model on it (data, fsdp,
    tensor; see the module docstring), and step takes the GLOBAL batch, the
    same on every rank, and trains on this rank's part (`batch_slice`);
    its loss and grad_norm are the global ones. `wrap` does not combine
    with a mesh.
    init_state(generator=None, *, model=None) -> {'model', 'opt', 'step',
    'loss_fn'}; a given model (e.g. from params_from_jax) is used as it is,
    or, on a mesh, cut to this rank's shards in place.
    step(state, batch) -> (state, {'loss', 'grad_norm'}): the parameters and
    the optimizer state are updated in place, where the reference donates
    its buffers.
    """
    if mesh is not None:
        if wrap is not None:
            raise ValueError("a step on a mesh shards the model itself: pass no wrap")
        device = mesh.device_type
    device = resolve_device(device)
    if optimizer is None:
        optimizer = adamw

    def init_state(generator: Optional[torch.Generator] = None, *, model=None):
        if model is None:
            model = transformer_init(cfg, generator, device=device)
        elif model.embed.device.type != device.type:
            raise ValueError(f"model is on {model.embed.device}, the step on {device}")
        loss_fn = TransformerLoss(model)
        if mesh is not None:
            _Layout(mesh, cfg).place(loss_fn)
        elif wrap is not None:
            loss_fn = wrap(loss_fn)
        return {"model": model, "opt": optimizer(_param_groups(model)), "step": 0,
                "loss_fn": loss_fn}

    def step(state, batch):
        model, opt = state["model"], state["opt"]
        layout = getattr(model, "layout", None)
        if layout is not None:
            batch = layout.local_batch(batch)
        loss = state["loss_fn"](batch)
        loss.backward()
        if layout is None:
            grads = [p.grad for p in model.parameters()]
            gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        else:
            layout.reduce_grads(model)
            gnorm = layout.grad_norm(model)
            loss = layout.mean_loss(loss)
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
