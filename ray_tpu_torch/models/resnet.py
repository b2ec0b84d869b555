"""ResNet (v1.5) in PyTorch: the Train benchmark's model family.

Port of ray_tpu/models/resnet.py. Activations are `channels_last` (the
reference's NHWC), convolution weights OIHW (the reference's HWIO,
transposed). Master weights are f32 and are cast to `cfg.dtype` at each
convolution; batch norm takes its statistics in f32 and applies a folded
scale and bias in the compute dtype, as the reference does, written with
plain tensor ops because `F.batch_norm` differs from it in three ways: it
keeps the unbiased variance as the running one, it weighs the old running
value by 1 - momentum, and it normalises in f32. The convolutions are
`F.conv2d` (cuDNN on the card): the JAX package leaves them to XLA too.

The parameters keep the reference tree's names (`stem_conv`, `stem_bn`,
`blocks.<i>.conv1..3`, `bn1..3`, `proj_conv`, `proj_bn`, `fc_w`, `fc_b`),
the running statistics are buffers (`<bn>.mean`, `<bn>.var`), so
`ray_tpu_torch.convert.resnet_params_from_jax` loads a JAX tree by plain
copies.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device

_STAGES = {
    18: ((2, 2, 2, 2), False),
    34: ((3, 4, 6, 3), False),
    50: ((3, 4, 6, 3), True),
    101: ((3, 4, 23, 3), True),
    152: ((3, 8, 36, 3), True),
}

# The reference's batch-norm constants (ray_tpu/models/resnet.py `_bn`):
# running = MOMENTUM * running + (1 - MOMENTUM) * batch statistic.
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
# The bench's optimizer, optax.sgd(0.1, momentum=0.9): no dampening, no Nesterov.
SGD_LR, SGD_MOMENTUM = 0.1, 0.9


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    # MLPerf-style stem: a 2x2 space-to-depth reshape to [H/2, W/2, 12]
    # and a 4x4/s1 conv in place of the 7x7/s2 conv; same output shape,
    # other weight shapes.
    space_to_depth: bool = False

    @property
    def stages(self) -> Sequence[int]:
        return _STAGES[self.depth][0]

    @property
    def bottleneck(self) -> bool:
        return _STAGES[self.depth][1]


def block_layout(cfg: ResNetConfig):
    """Static per-block structure: (stride, cin, base, cout) tuples."""
    layout = []
    cin = cfg.width
    for stage, n_blocks in enumerate(cfg.stages):
        base = cfg.width * (2 ** stage)
        cout = base * (4 if cfg.bottleneck else 1)
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            layout.append((stride, cin, base, cout))
            cin = cout
    return layout


def _conv_shapes(cfg: ResNetConfig, cin: int, base: int, cout: int, proj: bool):
    """{name: (cout, cin, k)} of one block's convolutions."""
    if cfg.bottleneck:
        convs = {"conv1": (base, cin, 1), "conv2": (base, base, 3), "conv3": (cout, base, 1)}
    else:
        convs = {"conv1": (base, cin, 3), "conv2": (cout, base, 3)}
    if proj:
        convs["proj_conv"] = (cout, cin, 1)
    return convs


def _conv_param(cout: int, cin: int, k: int, device) -> nn.Parameter:
    w = torch.empty((cout, cin, k, k), dtype=torch.float32, device=device)
    return nn.Parameter(w.contiguous(memory_format=torch.channels_last))


class BatchNorm(nn.Module):
    """One batch norm's f32 state: `scale` and `bias` are trained, the
    running `mean` and `var` are buffers."""

    def __init__(self, c: int, device):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(c, **f32))
        self.bias = nn.Parameter(torch.zeros(c, **f32))
        self.register_buffer("mean", torch.zeros(c, **f32))
        self.register_buffer("var", torch.ones(c, **f32))


class Block(nn.Module):
    """A residual block: conv1..2 (basic) or conv1..3 (bottleneck), each
    with its batch norm, and a projection shortcut where the shape changes."""

    def __init__(self, cfg: ResNetConfig, stride: int, cin: int, base: int, cout: int, device):
        super().__init__()
        self.stride = stride
        for name, (o, i, k) in _conv_shapes(cfg, cin, base, cout,
                                            stride != 1 or cin != cout).items():
            self.register_parameter(name, _conv_param(o, i, k, device))
            self.add_module(name.replace("conv", "bn"), BatchNorm(o, device))


class ResNet(nn.Module):
    """Parameters of the model. The forward takes [B, 3, H, W] images (any
    memory format) and gives [B, num_classes] f32 logits."""

    def __init__(self, cfg: ResNetConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        if cfg.space_to_depth:
            self.stem_conv = _conv_param(cfg.width, 12, 4, device)
        else:
            self.stem_conv = _conv_param(cfg.width, 3, 7, device)
        self.stem_bn = BatchNorm(cfg.width, device)
        self.blocks = nn.ModuleList(Block(cfg, *spec, device) for spec in block_layout(cfg))
        final_c = block_layout(cfg)[-1][3]
        f32 = dict(dtype=torch.float32, device=device)
        self.fc_w = nn.Parameter(torch.empty((final_c, cfg.num_classes), **f32))
        self.fc_b = nn.Parameter(torch.zeros(cfg.num_classes, **f32))

    def forward(self, images, train: bool = False):
        return resnet_apply(self, images, train)


@torch.no_grad()
def resnet_init(cfg: ResNetConfig, device="cuda",
                generator: Optional[torch.Generator] = None) -> ResNet:
    """f32 master weights drawn as the reference draws them (convolutions
    normal * sqrt(2 / fan_in), fc normal / sqrt(fan_in), batch norms at
    scale 1, bias 0, mean 0, var 1) from `generator` (seed 0 if None). The
    numbers differ from jax.random's; tests carry JAX's over with
    `resnet_params_from_jax` instead."""
    model = ResNet(cfg, device)
    dev = model.fc_w.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    for p in model.parameters():
        if p.dim() == 4:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            p.copy_(torch.randn(p.shape, generator=generator, device=dev) * math.sqrt(2.0 / fan_in))
    model.fc_w.copy_(torch.randn(model.fc_w.shape, generator=generator, device=dev)
                     * math.sqrt(1.0 / model.fc_w.shape[0]))
    return model


# ----------------------------------------------------------------- forward

def _conv(x, w, stride: int, dtype):
    """Convolution padded by k // 2 on every side, in `dtype`."""
    return F.conv2d(x.to(dtype), w.to(dtype), stride=stride, padding=w.shape[-1] // 2)


def _at_least_f32(x):
    """x in f32, or as it is where its dtype is wider (an f64 model)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _bn(x, bn: BatchNorm, train: bool):
    """Batch norm as the reference computes it. In train mode the batch's
    statistics are taken in f32 (gradients flow through them) and the
    running ones move to MOMENTUM * old + (1 - MOMENTUM) * new, with the
    biased variance. The affine is folded into one scale and one bias,
    rounded to x's dtype and applied in it."""
    if train:
        xf = _at_least_f32(x)
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        with torch.no_grad():
            bn.mean.copy_(BN_MOMENTUM * bn.mean + (1 - BN_MOMENTUM) * mean)
            bn.var.copy_(BN_MOMENTUM * bn.var + (1 - BN_MOMENTUM) * var)
    else:
        mean, var = bn.mean, bn.var
    inv = torch.rsqrt(var + BN_EPS)
    scale = (bn.scale * inv).to(x.dtype)
    bias = (bn.bias - mean * bn.scale * inv).to(x.dtype)
    return x * scale[:, None, None] + bias[:, None, None]


def _space_to_depth(x):
    """[B, C, H, W] -> [B, 4C, H/2, W/2], the channels ordered as the
    reference's NHWC reshape orders them: (row parity, column parity, c)."""
    b, c, h, w = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    return x.permute(0, 3, 1, 2)


def resnet_apply(model: ResNet, images, train: bool = False):
    """[B, 3, H, W] images -> [B, num_classes] f32 logits. In train mode the
    batch norms normalise with the batch's statistics and update their
    running ones in place."""
    cfg = model.cfg
    dt = cfg.dtype
    x = images.to(dtype=dt, memory_format=torch.channels_last)
    if cfg.space_to_depth:
        # 4x4/s1 with (1, 2) padding keeps the 7x7/s2 stem's output shape.
        x = F.pad(_space_to_depth(x), (1, 2, 1, 2))
        x = F.conv2d(x, model.stem_conv.to(dt))
    else:
        x = _conv(x, model.stem_conv, 2, dt)
    x = F.relu(_bn(x, model.stem_bn, train))
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)  # -inf padding
    for blk in model.blocks:
        shortcut = x
        if hasattr(blk, "proj_conv"):
            shortcut = _bn(_conv(x, blk.proj_conv, blk.stride, dt), blk.proj_bn, train)
        if cfg.bottleneck:
            y = F.relu(_bn(_conv(x, blk.conv1, 1, dt), blk.bn1, train))
            y = F.relu(_bn(_conv(y, blk.conv2, blk.stride, dt), blk.bn2, train))
            y = _bn(_conv(y, blk.conv3, 1, dt), blk.bn3, train)
        else:
            y = F.relu(_bn(_conv(x, blk.conv1, blk.stride, dt), blk.bn1, train))
            y = _bn(_conv(y, blk.conv2, 1, dt), blk.bn2, train)
        x = F.relu(y + shortcut)
    x = _at_least_f32(x.mean(dim=(2, 3)))  # global average pool, in the compute dtype
    return x @ model.fc_w + model.fc_b


def images_from_uint8(raw, size: int, dtype):
    """[B, size*size*3] uint8 pixels (HWC rows) -> [B, 3, size, size]
    images in `dtype` scaled to [-1, 1], as the bench normalises them on
    the device. The NCHW result is a channels_last view: no copy beyond
    the cast."""
    x = raw.view(-1, size, size, 3).to(dtype).div_(127.5).sub_(1.0)
    return x.permute(0, 3, 1, 2)


# -------------------------------------------------------------- train step

def make_train_step(cfg: ResNetConfig, device="cuda"):
    """Build (init_state, step) on one device: softmax cross entropy on the
    f32 logits, then SGD(SGD_LR, momentum SGD_MOMENTUM) on the parameters;
    the batch norms' running statistics move only by the forward.

    init_state(generator=None, *, model=None) -> {'model', 'opt', 'step'};
    a given model (e.g. from resnet_params_from_jax) is used as it is.
    step(state, {'images': [B, 3, H, W], 'labels': [B] int64}) -> (state,
    {'loss'}): the parameters and the momentum are updated in place.
    """
    device = resolve_device(device)

    def init_state(generator: Optional[torch.Generator] = None, *, model=None):
        if model is None:
            model = resnet_init(cfg, device, generator)
        elif model.fc_w.device.type != device.type:
            raise ValueError(f"model is on {model.fc_w.device}, the step on {device}")
        opt = torch.optim.SGD(model.parameters(), lr=SGD_LR, momentum=SGD_MOMENTUM)
        return {"model": model, "opt": opt, "step": 0}

    def step(state, batch):
        model, opt = state["model"], state["opt"]
        logits = resnet_apply(model, batch["images"], train=True)
        loss = F.cross_entropy(logits, batch["labels"])
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        state["step"] += 1
        return state, {"loss": loss.detach()}

    return init_state, step


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def forward_flops_per_image(cfg: ResNetConfig, size: int) -> float:
    """Forward FLOPs of one size x size image through the convolutions and
    the fc layer, 2 per multiply-add (batch norm, ReLU, pooling and the
    residual adds are not counted). ResNet-50 at 224: ~8.2e9."""
    if cfg.space_to_depth:
        s = size // 2  # the 4x4/s1 conv keeps the space-to-depth size
        flops = 2 * 16 * 12 * cfg.width * s * s
    else:
        s = _out(size, 7, 2, 3)
        flops = 2 * 49 * 3 * cfg.width * s * s
    s = _out(s, 3, 2, 1)  # max pool
    for stride, cin, base, cout in block_layout(cfg):
        t = _out(s, 3, stride, 1)
        if cfg.bottleneck:
            flops += 2 * (cin * base * s * s + 9 * base * base * t * t + base * cout * t * t)
        else:
            flops += 2 * (9 * cin * base * t * t + 9 * base * cout * t * t)
        if stride != 1 or cin != cout:
            flops += 2 * cin * cout * t * t
        s = t
    return float(flops + 2 * block_layout(cfg)[-1][3] * cfg.num_classes)


def train_flops_per_image(cfg: ResNetConfig, size: int) -> float:
    """FLOPs of one trained image: the forward, and a backward of twice the
    forward less the stem's input gradient, which nothing needs (the count
    torch.utils.flop_counter gives). ResNet-50 at 224: ~2.43e10."""
    stem = (16 * 12 if cfg.space_to_depth else 49 * 3) * 2 * cfg.width * (size // 2) ** 2
    return 3 * forward_flops_per_image(cfg, size) - stem
