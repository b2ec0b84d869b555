"""RLModule: the neural-net component of an RL algorithm, in PyTorch.

Port of ray_tpu/rllib/core/rl_module.py (analog of the reference's
rllib/core/rl_module/). The JAX package's (init, forward) pairs over a param
pytree become small `nn.Module`s with the same structure and the same
initialisation law: `PiVf` (actor-critic: separate `pi`/`vf` nets, or a
shared `torso` with `pi_head`/`vf_head`), `QNet` (DQN, CQL) and `SACNet`
(squashed-Gaussian actor `pi`, twin critics `q1`/`q2`, the temperature
`log_alpha`). The free functions keep the reference's names.

Weights travel between learners, runners and checkpoints as numpy trees in
the reference's layout (lists of {"w": [in, out], "b": [out]} per net, plus
`log_alpha`): `tree_of` and `load_tree` map a module to and from one.

Supported spaces: Box observations, Discrete actions, and bounded symmetric
Box actions for SAC.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class RLModuleSpec:
    """Declarative module spec (reference: rl_module/rl_module.py RLModuleSpec)."""

    obs_dim: int
    num_actions: int
    hidden: Tuple[int, ...] = (64, 64)
    # "shared" (one torso, two heads) or "separate" (independent pi/vf nets).
    vf_share_layers: bool = False
    dtype: Any = torch.float32
    # Continuous (Box) action spaces (SAC): dimensionality and symmetric
    # bound; num_actions is 0 for continuous modules.
    act_dim: int = 0
    act_limit: float = 1.0


class Dense(nn.Module):
    """x @ weight.T + bias, weight [out, in] drawn as the reference's
    `_init_mlp` draws its [in, out] `w`: normal * sqrt(2 / d_in), zero bias,
    from an explicit generator (never nn.Linear's default init)."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator, dtype):
        super().__init__()
        w = torch.randn(d_out, d_in, generator=generator) * math.sqrt(2.0 / d_in)
        self.weight = nn.Parameter(w.to(dtype))
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=dtype))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class MLP(nn.ModuleList):
    """Dense layers with tanh between them and none after the last (the
    reference's `_mlp`)."""

    def __init__(self, sizes, generator: torch.Generator, dtype):
        super().__init__(Dense(a, b, generator, dtype) for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        for i, layer in enumerate(self):
            x = layer(x)
            if i < len(self) - 1:
                x = torch.tanh(x)
        return x


class PiVf(nn.Module):
    """Policy + value nets for actor-critic algorithms (PPO/IMPALA/APPO, and
    BC/MARWIL). forward(obs) -> (action_logits [B, A], value [B])."""

    def __init__(self, spec: RLModuleSpec, generator: torch.Generator):
        super().__init__()
        self.shared = spec.vf_share_layers
        h, dt = spec.hidden, spec.dtype
        if self.shared:
            self.torso = MLP((spec.obs_dim, *h), generator, dt)
            self.pi_head = MLP((h[-1], spec.num_actions), generator, dt)
            self.vf_head = MLP((h[-1], 1), generator, dt)
        else:
            self.pi = MLP((spec.obs_dim, *h, spec.num_actions), generator, dt)
            self.vf = MLP((spec.obs_dim, *h, 1), generator, dt)

    def forward(self, obs):
        if self.shared:
            # The torso's last layer has no tanh inside the MLP; the
            # reference applies one before the heads.
            h = torch.tanh(self.torso(obs))
            return self.pi_head(h), self.vf_head(h)[..., 0]
        return self.pi(obs), self.vf(obs)[..., 0]


class QNet(nn.Module):
    """Q-network for value-based algorithms (DQN, CQL). forward(obs) -> [B, A]."""

    def __init__(self, spec: RLModuleSpec, generator: torch.Generator):
        super().__init__()
        self.q = MLP((spec.obs_dim, *spec.hidden, spec.num_actions), generator, spec.dtype)

    def forward(self, obs):
        return self.q(obs)


class SACNet(nn.Module):
    """Actor (obs -> [mu, log_std]), twin critics (obs+act -> q) and the
    learnable entropy temperature log_alpha. forward(obs, act) is the twin
    critic, so a critic with other parameters (frozen, or the target's) is
    `torch.func.functional_call(net, params, (obs, act))`."""

    def __init__(self, spec: RLModuleSpec, generator: torch.Generator):
        super().__init__()
        in_q, h, dt = spec.obs_dim + spec.act_dim, spec.hidden, spec.dtype
        self.pi = MLP((spec.obs_dim, *h, 2 * spec.act_dim), generator, dt)
        self.q1 = MLP((in_q, *h, 1), generator, dt)
        self.q2 = MLP((in_q, *h, 1), generator, dt)
        self.log_alpha = nn.Parameter(torch.zeros((), dtype=dt))

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self.q1(x)[..., 0], self.q2(x)[..., 0]


MODULES: Dict[str, Callable[[RLModuleSpec, torch.Generator], nn.Module]] = {
    "pi_vf": PiVf,
    "q": QNet,
    "sac": SACNet,
}


def make_module(kind: str, spec: RLModuleSpec, generator: torch.Generator) -> nn.Module:
    """The module of `kind` ("pi_vf", "q" or "sac"), initialised on the CPU."""
    if kind not in MODULES:
        raise ValueError(f"unknown module kind {kind!r}")
    return MODULES[kind](spec, generator)


def forward_pi_vf(module: PiVf, obs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (action_logits [B, A], value [B])."""
    return module(obs)


def forward_q(module: QNet, obs) -> torch.Tensor:
    return module(obs)


def sample_actions(generator: torch.Generator, logits):
    """Categorical sample + logp, drawn from `generator` (on logits' device)."""
    logp = F.log_softmax(logits, dim=-1)
    actions = torch.multinomial(logp.exp(), 1, generator=generator)[:, 0]
    logp_a = logp.gather(-1, actions[:, None])[:, 0]
    return actions, logp_a


def num_params(module: nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))


# -- SAC: squashed-Gaussian actor + twin Q (reference: sac_rl_module /
# sac_learner; continuous Box actions) --------------------------------------

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def sac_pi(module: SACNet, obs, rng, act_limit: float):
    """Sample a squashed-Gaussian action; returns (action, logp) with the
    tanh change-of-variables correction. `rng` is a torch.Generator (on the
    CPU) to draw the standard-normal noise from, or the noise itself."""
    mu, log_std = module.pi(obs).chunk(2, dim=-1)
    log_std = log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)
    std = log_std.exp()
    if isinstance(rng, torch.Tensor):
        eps = rng
    else:
        eps = torch.randn(mu.shape, generator=rng, dtype=mu.dtype).to(mu.device)
    pre = mu + std * eps
    # Gaussian logp minus tanh correction (numerically stable softplus form).
    logp = (-0.5 * eps**2 - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)
    logp = logp - (2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre))).sum(-1)
    # Jacobian of the final scaling by act_limit: without it the density is
    # that of tanh(pre), biasing the alpha auto-tune by log(act_limit)/dim.
    logp = logp - mu.shape[-1] * math.log(act_limit)
    action = torch.tanh(pre) * act_limit
    return action, logp


def sac_pi_deterministic(module: SACNet, obs, act_limit: float):
    mu, _ = module.pi(obs).chunk(2, dim=-1)
    return torch.tanh(mu) * act_limit


def sac_q(module: SACNet, obs, act) -> Tuple[torch.Tensor, torch.Tensor]:
    return module(obs, act)


# -- the reference's tree layout ---------------------------------------------


def _leaves(module: nn.Module) -> Iterator[tuple]:
    """(path in the reference's tree, parameter, stored transposed) of every
    parameter: an MLP child is a list of {"w": weight.T, "b": bias}, a
    parameter of the module itself (log_alpha) a leaf of its own."""
    for name, child in module.named_children():
        for i, layer in enumerate(child):
            yield (name, i, "w"), layer.weight, True
            yield (name, i, "b"), layer.bias, False
    for name, p in module.named_parameters(recurse=False):
        yield (name,), p, False


def tree_of(module: nn.Module, get: Optional[Callable] = None) -> Dict[str, Any]:
    """The module's parameters, or `get(parameter)` of each (its grad, an
    optimizer moment), as a numpy tree in the reference's layout."""
    tree: Dict[str, Any] = {}
    for path, p, transposed in _leaves(module):
        t = p if get is None else get(p)
        value = t.detach().float().cpu().numpy()
        value = np.ascontiguousarray(value.T) if transposed else value.copy()
        if len(path) == 1:
            tree[path[0]] = value
        else:
            layers = tree.setdefault(path[0], [])
            if len(layers) == path[1]:
                layers.append({})
            layers[path[1]][path[2]] = value
    return tree


def tree_values(module: nn.Module, tree: Dict[str, Any]) -> Iterator[tuple]:
    """(parameter, the tree's value for it as a CPU tensor in the module's
    orientation and dtype) for every parameter of the module."""
    for path, p, transposed in _leaves(module):
        value = tree[path[0]] if len(path) == 1 else tree[path[0]][path[1]][path[2]]
        value = np.asarray(value, dtype=np.float32)
        # np.array copies: contiguous, writable, and a 0-d leaf stays 0-d.
        value = np.array(value.T if transposed else value)
        if value.shape != tuple(p.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape {value.shape} "
                             f"does not fit {tuple(p.shape)}")
        yield p, torch.from_numpy(value).to(p.dtype)


@torch.no_grad()
def load_tree(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copies a numpy tree in the reference's layout into the module."""
    for p, value in tree_values(module, tree):
        p.copy_(value)
    return module
