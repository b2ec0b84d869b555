"""MARWIL: monotonic advantage re-weighted imitation learning.

Port of ray_tpu/rllib/algorithms/marwil.py (analog of
rllib/algorithms/marwil/: marwil.py + marwil_learner): offline
imitation where each logged action's log-likelihood is weighted by
exp(beta * advantage) — better-than-average actions are imitated harder,
beta=0 degenerates to plain BC. Advantages come from Monte-Carlo returns
over the logged episodes minus the learned value baseline; the moving
average of squared advantages normalizes the exponent (the reference's
update_beta/ moving-average-sqd-adv-norm machinery, as the JAX package
carries it: a scalar in the learner, fed to each update as `_ma_sq_adv`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.utils.offline import materialize_offline, validate_discrete_actions
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import PiVf, RLModuleSpec, forward_pi_vf


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=MARWIL)
        self.lr = 1e-3
        self.train_batch_size = 256
        self.updates_per_iteration = 32
        self.beta = 1.0  # 0 => plain BC
        self.vf_coeff = 1.0
        # Exponent clip guards exp() overflow on outlier advantages
        # (reference: MARWIL's 'clip exp term' behavior).
        self.max_adv_exponent = 10.0


class MARWILLearner(Learner):
    def __init__(self, spec: RLModuleSpec, cfg: Dict[str, Any], **kw):
        self.cfg = cfg
        super().__init__(spec, **kw)
        # Moving average of squared advantages (normalizes the exponent).
        self.ma_sq_adv = 1.0

    def init_module(self, generator):
        return PiVf(self.spec, generator)

    def loss_fn(self, module, batch):
        logits, values = forward_pi_vf(module, batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["actions"][:, None])[:, 0]
        adv = batch["returns"] - values
        # Weight = exp(beta * adv / sqrt(ma_sq_adv)); baseline gradient
        # must not flow through the weight (detach adv).
        norm = torch.sqrt(batch["_ma_sq_adv"]) + 1e-8
        exponent = torch.clamp(
            self.cfg["beta"] * adv.detach() / norm,
            -self.cfg["max_adv_exponent"],
            self.cfg["max_adv_exponent"],
        )
        weight = torch.exp(exponent)
        policy_loss = -torch.mean(weight * logp)
        vf_loss = torch.mean(adv**2)
        loss = policy_loss + self.cfg["vf_coeff"] * vf_loss
        return loss, {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "total_loss": loss,
            "mean_weight": torch.mean(weight),
            "mean_sq_adv": torch.mean(adv.detach() ** 2),
        }

    def update_from_batch(self, batch):
        batch = dict(batch)
        batch["_ma_sq_adv"] = np.float32(self.ma_sq_adv)
        metrics = super().update_from_batch(batch)
        # Moving-average update outside the step (a carried scalar).
        msa = float(metrics.get("mean_sq_adv", self.ma_sq_adv))
        self.ma_sq_adv = 0.99 * self.ma_sq_adv + 0.01 * msa
        return metrics


def _discounted_returns(rows: List[dict], gamma: float) -> np.ndarray:
    """Monte-Carlo return per row over the logged episode boundaries
    (reference: offline pre-processing computes advantages from returns)."""
    rewards = np.asarray([float(r.get("rewards", 0.0)) for r in rows])
    dones = np.asarray([bool(r.get("dones", False)) for r in rows])
    returns = np.zeros(len(rows), dtype=np.float32)
    acc = 0.0
    for i in range(len(rows) - 1, -1, -1):
        if dones[i]:
            acc = 0.0
        acc = rewards[i] + gamma * acc
        returns[i] = acc
    return returns


class MARWIL(Algorithm):
    policy_kind = "pi_vf"

    def __init__(self, config: AlgorithmConfig):
        if config.offline_input is None:
            raise ValueError(
                "MARWIL requires offline data: config.offline_data(input_=...)"
            )
        super().__init__(config)
        rows = materialize_offline(config.offline_input)
        self._obs = np.asarray(
            [r["obs"] for r in rows], dtype=np.float32
        ).reshape(len(rows), -1)
        self._acts = validate_discrete_actions(
            np.asarray([r["actions"] for r in rows]), self.num_actions, "MARWIL"
        )
        self._returns = _discounted_returns(rows, config.gamma)
        self._rng = np.random.RandomState(config.seed)

    def _learner_builder(self, obs_dim: int, num_actions: int) -> Callable[[str], Any]:
        cfg = self.config
        spec = RLModuleSpec(
            obs_dim=obs_dim,
            num_actions=num_actions,
            hidden=tuple(cfg.model.get("hidden", (64, 64))),
        )
        loss_cfg = {
            "beta": cfg.beta,
            "vf_coeff": cfg.vf_coeff,
            "max_adv_exponent": cfg.max_adv_exponent,
        }
        lr, grad_clip, seed = cfg.lr, cfg.grad_clip, cfg.seed

        def build(device):
            return MARWILLearner(spec, loss_cfg, lr=lr, grad_clip=grad_clip, seed=seed,
                                 device=device)

        return build

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        metrics: Dict[str, float] = {}
        for _ in range(cfg.updates_per_iteration):
            idx = self._rng.randint(0, len(self._obs), size=cfg.train_batch_size)
            metrics = self.learner_group.update_from_batch(
                {
                    "obs": self._obs[idx],
                    "actions": self._acts[idx],
                    "returns": self._returns[idx],
                }
            )
        self._sync_weights()
        return {
            **{k: float(v) for k, v in metrics.items()},
            "num_offline_rows": len(self._obs),
        }

    def evaluate(self, num_steps: int = 256) -> Dict[str, Any]:
        batches = self.env_runner_group.sample(num_steps)
        return self._episode_metrics(batches)
