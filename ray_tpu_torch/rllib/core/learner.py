"""Learner: owns a module and its optimizer, applies updates on its device.

Port of ray_tpu/rllib/core/learner.py (analog of
rllib/core/learner/learner.py:107, update_from_batch:1074,
compute_loss:814, apply_gradients:586). Learners run on a CUDA card unless
the caller asks for "cpu"; without a card they raise. One update zeroes the
gradients, runs the loss and its backward, takes the global gradient norm,
clips by it exactly as `optax.clip_by_global_norm` does and steps Adam with
optax.adam's constants, all eager torch ops (cuBLAS for the GEMMs). Its
metrics come to the host in one transfer.

Everything that leaves a learner is device-free numpy in the reference's
tree layout (`rl_module.tree_of`): weights, gradients and state (the
module's parameters, the optimizer's per-parameter state, the update
count), so a state saved from the card restores on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, load_tree, tree_of, tree_values


def learner_device(device) -> torch.device:
    """torch.device(device), raising if it names a CUDA card this process
    cannot use: a learner never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"learner device {device!r}: no CUDA device is available "
                           "(pass device='cpu' to run the learner on the CPU)")
    return dev


def adam(lr: float) -> Callable[[List[torch.nn.Parameter]], torch.optim.Optimizer]:
    """optax.adam(lr)'s update as a torch optimizer."""
    return lambda params: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


class Learner:
    """Base learner. Subclasses define `init_module(generator)` (the module
    on the CPU) and `loss_fn(module, batch) -> (loss, metrics)` over a batch
    of tensors on the learner's device; the base class runs the update and
    manages the optimizer. `optimizer`, a function of the parameter list
    that returns a torch optimizer, replaces the default global-norm clip
    and Adam, as an optax optimizer does in the reference."""

    def __init__(
        self,
        spec: RLModuleSpec,
        *,
        lr: float = 5e-4,
        grad_clip: Optional[float] = 40.0,
        optimizer: Optional[Callable] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.spec = spec
        self.lr = lr
        self.device = learner_device(device)
        self.grad_clip = grad_clip if optimizer is None else None
        # Init draws and the learner's noise (SAC) come from one CPU
        # generator, so a card and a CPU learner of one seed agree.
        self.generator = torch.Generator().manual_seed(seed)
        self.module = self.init_module(self.generator).to(self.device)
        self.params = list(self.module.parameters())
        self.optimizer = (optimizer or adam(lr))(self.params)
        self._num_updates = 0

    # -- subclass hooks ------------------------------------------------------

    def init_module(self, generator: torch.Generator) -> torch.nn.Module:
        raise NotImplementedError

    def loss_fn(self, module, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError

    # -- update pipeline -----------------------------------------------------

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.tensor(np.asarray(v), device=self.device) for k, v in batch.items()}

    def _backward(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Loss, metrics and gradients into each parameter's .grad (zeros
        where the loss does not reach a parameter, as jax.grad gives)."""
        for p in self.params:
            p.grad = None
        loss, metrics = self.loss_fn(self.module, batch)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = dict(metrics)
        metrics["total_loss"] = loss
        metrics["grad_norm"] = torch.nn.utils.get_total_norm([p.grad for p in self.params])
        return metrics

    def _apply(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """Clip by the global norm (optax.clip_by_global_norm: g / norm * max
        where norm >= max, no epsilon, no host sync) and step."""
        if self.grad_clip is not None:
            grads = [p.grad for p in self.params]
            if grad_norm is None:
                grad_norm = torch.nn.utils.get_total_norm(grads)
            keep = grad_norm < self.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / grad_norm * self.grad_clip))
        self.optimizer.step()
        self._num_updates += 1

    @staticmethod
    def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        values = torch.stack([torch.as_tensor(v).detach().float().reshape(())
                              for v in metrics.values()]).cpu().tolist()
        return dict(zip(metrics, values))

    def _update(self, batch: Dict[str, Any]) -> Dict[str, float]:
        metrics = self._backward(batch)
        self._apply(metrics["grad_norm"])
        return self._to_host(metrics)

    def update_from_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One gradient step on a numpy batch, moved to the device."""
        return self._update(self.to_device(batch))

    def compute_gradients(self, batch: Dict[str, np.ndarray]):
        """Grads (numpy, the reference's layout) without applying them: used
        by multi-learner grad averaging."""
        metrics = self._backward(self.to_device(batch))
        return tree_of(self.module, lambda p: p.grad), self._to_host(metrics)

    def apply_gradients(self, grads) -> None:
        for p, g in tree_values(self.module, grads):
            p.grad = g.to(self.device)
        self._apply()

    # -- weights -------------------------------------------------------------

    def get_weights(self) -> Any:
        return tree_of(self.module)

    def set_weights(self, weights) -> None:
        load_tree(self.module, weights)

    def get_state(self) -> Dict[str, Any]:
        """Params, the optimizer's state (each per-parameter tensor as a
        tree in the reference's layout, its step count as a float) and the
        update count, all numpy."""
        state = self.optimizer.state
        opt_state: Dict[str, Any] = {}
        for key in state.get(self.params[0], {}):
            if key == "step":  # one count for every parameter
                opt_state[key] = float(state[self.params[0]][key])
            else:
                opt_state[key] = tree_of(self.module, lambda p, k=key: state[p][k])
        return {
            "params": tree_of(self.module),
            "opt_state": opt_state,
            "num_updates": self._num_updates,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        load_tree(self.module, state["params"])
        self.optimizer.state.clear()
        for key, value in state["opt_state"].items():
            if key == "step":
                for p in self.params:
                    self.optimizer.state[p][key] = torch.tensor(value, dtype=torch.float32)
            else:
                for p, v in tree_values(self.module, value):
                    self.optimizer.state[p][key] = v.to(self.device)
        self._num_updates = state.get("num_updates", 0)
