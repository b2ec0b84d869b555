"""SAC: soft actor-critic for continuous (Box) action spaces.

Port of ray_tpu/rllib/algorithms/sac.py (analog of rllib/algorithms/sac/:
sac.py, sac_learner, default_sac_rl_module):
squashed-Gaussian actor, twin Q critics with polyak-averaged targets, and
automatic entropy-temperature tuning against a target entropy of -act_dim.
Off-policy: env runners explore stochastically into a uniform replay buffer;
the learner runs the critic, actor and alpha updates as one torch step. The
actor's loss sees the critics through `functional_call` with detached
parameters, so the action carries a gradient to `pi` and none reaches
`q1`/`q2`; the target critics are detached copies moved by Polyak averaging.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch
from torch.func import functional_call

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, SACNet, sac_pi, sac_q
from ray_tpu_torch.rllib.utils.replay_buffer import ReplayBuffer


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=SAC)
        self.lr = 3e-4
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 1500
        self.tau = 0.005  # polyak target-update coefficient
        self.target_entropy = None  # default: -act_dim
        self.initial_alpha = 1.0
        self.updates_per_iteration = 32
        self.rollout_fragment_length = 4


class SACLearner(Learner):
    """One update = twin-critic TD step + actor step + alpha step, all in
    one loss (losses are summed; their parameter sets are disjoint, so
    gradients don't cross-contaminate — the standard single-optimizer
    formulation)."""

    def __init__(self, spec: RLModuleSpec, cfg: Dict[str, Any], **kw):
        self.cfg = cfg
        super().__init__(spec, **kw)
        self.target_params = {
            n: p.detach().clone()
            for n, p in self.module.named_parameters()
            if n.startswith(("q1.", "q2."))
        }

    def init_module(self, generator):
        module = SACNet(self.spec, generator)
        with torch.no_grad():
            module.log_alpha.fill_(math.log(self.cfg.get("initial_alpha", 1.0)))
        return module

    def loss_fn(self, module, batch):
        cfg = self.cfg
        limit = self.spec.act_limit
        alpha = torch.exp(module.log_alpha)

        # -- critic loss (targets from the target twin-min + entropy bonus)
        with torch.no_grad():
            next_act, next_logp = sac_pi(module, batch["next_obs"], batch["_eps_next"], limit)
            tq1, tq2 = functional_call(
                module, batch["_target_params"], (batch["next_obs"], next_act)
            )
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target = batch["rewards"] + cfg["gamma"] * (1.0 - batch["dones"]) * target_v
        q1, q2 = sac_q(module, batch["obs"], batch["actions"])
        critic_loss = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)

        # -- actor loss (reparameterized; critics frozen: detached params)
        frozen_q = {
            n: p.detach()
            for n, p in module.named_parameters()
            if n.startswith(("q1.", "q2."))
        }
        act, logp = sac_pi(module, batch["obs"], batch["_eps_pi"], limit)
        aq1, aq2 = functional_call(module, frozen_q, (batch["obs"], act))
        actor_loss = torch.mean(alpha.detach() * logp - torch.minimum(aq1, aq2))

        # -- temperature loss (drive entropy toward the target)
        alpha_loss = -torch.mean(
            module.log_alpha * (logp + cfg["target_entropy"]).detach()
        )

        loss = critic_loss + actor_loss + alpha_loss
        return loss, {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha_loss": alpha_loss,
            "alpha": alpha,
            "q1_mean": torch.mean(q1),
            "entropy": -torch.mean(logp),
        }

    def update_from_batch(self, batch):
        batch = self.to_device(batch)
        batch["_target_params"] = self.target_params
        # The actor's noise for the next obs, then for obs (the reference's
        # _rng_next and _rng_pi), from the learner's generator.
        shape = (len(batch["obs"]), self.spec.act_dim)
        for key in ("_eps_next", "_eps_pi"):
            batch[key] = torch.randn(shape, generator=self.generator).to(self.device)
        metrics = self._update(batch)
        self._polyak()
        return metrics

    @torch.no_grad()
    def _polyak(self) -> None:
        tau = self.cfg["tau"]
        online = dict(self.module.named_parameters())
        self.target_params = {
            n: (1.0 - tau) * t + tau * online[n] for n, t in self.target_params.items()
        }


class SAC(Algorithm):
    policy_kind = "sac"

    def __init__(self, config: AlgorithmConfig):
        super().__init__(config)
        act_dim, _ = self.env_runner_group.get_act_info()
        self.replay = ReplayBuffer(
            config.replay_buffer_capacity,
            self.obs_dim,
            seed=config.seed,
            act_dim=act_dim,
        )

    def _module_spec_dict(self) -> Dict[str, Any]:
        m = self.config.model
        return {"hidden": tuple(m.get("hidden", (256, 256)))}

    def _learner_builder(self, obs_dim: int, num_actions: int) -> Callable[[str], Any]:
        cfg = self.config
        act_dim, act_limit = self.env_runner_group.get_act_info()
        if not act_dim:
            raise ValueError("SAC requires a continuous (Box) action space")
        spec = RLModuleSpec(
            obs_dim=obs_dim,
            num_actions=0,
            hidden=tuple(cfg.model.get("hidden", (256, 256))),
            act_dim=act_dim,
            act_limit=act_limit,
        )
        target_entropy = (
            cfg.target_entropy if cfg.target_entropy is not None else -float(act_dim)
        )
        loss_cfg = {
            "gamma": cfg.gamma,
            "tau": cfg.tau,
            "target_entropy": target_entropy,
            "initial_alpha": cfg.initial_alpha,
        }
        lr, grad_clip, seed = cfg.lr, cfg.grad_clip, cfg.seed

        def build(device):
            return SACLearner(spec, loss_cfg, lr=lr, grad_clip=grad_clip, seed=seed,
                              device=device)

        return build

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        learner = self.learner_group._local
        assert learner is not None, "SAC requires num_learners=0 (local learner)"

        warmup = (
            self._env_steps_total < cfg.num_steps_sampled_before_learning_starts
        )
        batches = self.env_runner_group.sample(
            cfg.rollout_fragment_length, random_actions=warmup
        )
        self._env_steps_total += sum(b["env_steps"] for b in batches)
        for b in batches:
            self.replay.add_batch(b)

        metrics: Dict[str, float] = {}
        if len(self.replay) >= cfg.num_steps_sampled_before_learning_starts:
            for _ in range(cfg.updates_per_iteration):
                metrics = learner.update_from_batch(
                    self.replay.sample(cfg.train_batch_size)
                )
            self._sync_weights()
        return {
            **self._episode_metrics(batches),
            **{k: float(v) for k, v in metrics.items()},
            "replay_size": len(self.replay),
        }
