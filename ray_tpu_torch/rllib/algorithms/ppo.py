"""PPO: clipped-surrogate policy optimization.

Port of ray_tpu/rllib/algorithms/ppo.py (analog of rllib/algorithms/ppo/:
ppo.py, ppo_learner.py, torch loss at ppo_torch_learner.py): sync sampling
from the env-runner gang, GAE postprocessing, minibatched multi-epoch SGD on
one torch loss — policy clip + value clip + entropy bonus.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, gae_advantages
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import PiVf, RLModuleSpec, forward_pi_vf


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=PPO)
        self.lr = 3e-4
        self.train_batch_size = 2048
        self.minibatch_size = 128
        self.num_epochs = 8
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.kl_target = 0.02  # accepted for parity; adaptive KL not applied
        self.grad_clip = 0.5


class PPOLearner(Learner):
    def __init__(self, spec: RLModuleSpec, cfg: Dict[str, Any], **kw):
        self.cfg = cfg
        super().__init__(spec, **kw)

    def init_module(self, generator):
        return PiVf(self.spec, generator)

    def loss_fn(self, module, batch):
        c = self.cfg
        logits, values = forward_pi_vf(module, batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["actions"][:, None])[:, 0]
        # Optional row mask (multi-agent: padded rows of individually-
        # terminated agents must not produce gradients).
        mask = batch.get("mask")
        if mask is None:
            wmean = torch.mean
        else:
            denom = torch.clamp(mask.sum(), min=1.0)

            def wmean(x):
                return (x * mask).sum() / denom

        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - c["clip_param"], 1 + c["clip_param"]) * adv
        policy_loss = -wmean(torch.minimum(surr1, surr2))

        vf_err = values - batch["value_targets"]
        vf_clipped = batch["values_old"] + torch.clamp(
            values - batch["values_old"], -c["vf_clip_param"], c["vf_clip_param"]
        )
        vf_err_clipped = vf_clipped - batch["value_targets"]
        vf_loss = 0.5 * wmean(
            torch.maximum(torch.square(vf_err), torch.square(vf_err_clipped))
        )

        probs = F.softmax(logits, dim=-1)
        entropy = -wmean(torch.sum(probs * logp_all, dim=-1))
        kl = wmean(batch["logp_old"] - logp)

        loss = (
            policy_loss
            + c["vf_loss_coeff"] * vf_loss
            - c["entropy_coeff"] * entropy
        )
        return loss, {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "kl": kl,
        }


class PPO(Algorithm):
    policy_kind = "pi_vf"
    supports_multi_agent = True

    def _learner_builder(self, obs_dim: int, num_actions: int) -> Callable[[str], Any]:
        cfg = self.config
        spec = RLModuleSpec(
            obs_dim=obs_dim,
            num_actions=num_actions,
            hidden=tuple(cfg.model.get("hidden", (64, 64))),
            vf_share_layers=bool(cfg.model.get("vf_share_layers", False)),
        )
        loss_cfg = {
            "clip_param": cfg.clip_param,
            "vf_clip_param": cfg.vf_clip_param,
            "vf_loss_coeff": cfg.vf_loss_coeff,
            "entropy_coeff": cfg.entropy_coeff,
        }
        lr, grad_clip, seed = cfg.lr, cfg.grad_clip, cfg.seed

        def build(device):
            return PPOLearner(spec, loss_cfg, lr=lr, grad_clip=grad_clip, seed=seed,
                              device=device)

        return build

    def _flatten_with_gae(self, policy_batches, obs_dim: int) -> Dict[str, np.ndarray]:
        """GAE per runner batch, then flatten to one train batch."""
        cfg = self.config
        has_mask = any("mask" in b for b in policy_batches)
        keys = [
            "obs", "actions", "logp_old", "advantages",
            "value_targets", "values_old",
        ] + (["mask"] if has_mask else [])
        flat: Dict[str, list] = {k: [] for k in keys}
        for b in policy_batches:
            adv, ret = gae_advantages(
                b["rewards"],
                b["values"],
                b["terminateds"],
                b["truncateds"],
                b["bootstrap_value"],
                cfg.gamma,
                cfg.lambda_,
                boundary_values=b.get("boundary_values"),
            )
            flat["obs"].append(b["obs"].reshape(-1, obs_dim))
            flat["actions"].append(b["actions"].reshape(-1))
            flat["logp_old"].append(b["logp"].reshape(-1))
            flat["advantages"].append(adv.reshape(-1))
            flat["value_targets"].append(ret.reshape(-1))
            flat["values_old"].append(b["values"].reshape(-1))
            if has_mask:
                flat["mask"].append(
                    b.get(
                        "mask", np.ones_like(b["values"], np.float32)
                    ).reshape(-1)
                )
        train_batch = {k: np.concatenate(v) for k, v in flat.items()}
        adv = train_batch["advantages"]
        if has_mask:
            # Masked normalization: padded rows must not skew the stats.
            m = train_batch["mask"]
            n = max(float(m.sum()), 1.0)
            mean = float((adv * m).sum() / n)
            var = float(((adv - mean) ** 2 * m).sum() / n)
            train_batch["advantages"] = (adv - mean) / (var**0.5 + 1e-8)
        else:
            train_batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        return train_batch

    def _sgd_epochs(self, train_batch, learner_group, rng) -> Dict[str, float]:
        """Minibatched multi-epoch SGD on one learner group."""
        cfg = self.config
        size = len(train_batch["obs"])
        mb = min(cfg.minibatch_size, size)
        last_metrics: Dict[str, float] = {}
        for _ in range(cfg.num_epochs):
            perm = rng.permutation(size)
            for start in range(0, size - mb + 1, mb):
                idx = perm[start : start + mb]
                minibatch = {k: v[idx] for k, v in train_batch.items()}
                last_metrics = learner_group.update_from_batch(minibatch)
        return last_metrics

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n_runners = max(1, cfg.num_env_runners)
        # Both runner kinds vectorize num_envs_per_env_runner (multi-agent
        # runners step num_envs env copies per lockstep step), so the
        # per-runner step count divides by it in both cases — the train
        # batch stays at train_batch_size env steps.
        envs_per_runner = cfg.num_envs_per_env_runner
        steps_per_runner = max(
            1, cfg.train_batch_size // (n_runners * envs_per_runner)
        )
        batches = self.env_runner_group.sample(steps_per_runner)
        self._env_steps_total += sum(b["env_steps"] for b in batches)
        rng = np.random.RandomState(cfg.seed + self.iteration)

        if self.multi_agent:
            # Per-policy update: each policy gets its own GAE + SGD epochs
            # on its own learner group (reference: one Learner.update over a
            # MultiRLModule; here independent learners per policy).
            metrics: Dict[str, Any] = {}
            for pid, lg in self.learner_groups.items():
                pbatches = [
                    b["policies"][pid] for b in batches if pid in b["policies"]
                ]
                if not pbatches:
                    continue
                obs_dim = self.policy_spaces[pid][0]
                train_batch = self._flatten_with_gae(pbatches, obs_dim)
                for k, v in self._sgd_epochs(train_batch, lg, rng).items():
                    metrics[f"{pid}/{k}"] = v
            self._sync_weights()
            return {**self._episode_metrics(batches), **metrics}

        train_batch = self._flatten_with_gae(batches, self.obs_dim)
        last_metrics = self._sgd_epochs(train_batch, self.learner_group, rng)
        self._sync_weights()
        return {**self._episode_metrics(batches), **last_metrics}
