"""IMPALA: asynchronous sampling with V-trace off-policy correction.

Port of ray_tpu/rllib/algorithms/impala.py (analog of
rllib/algorithms/impala/impala.py (async pipeline + weight
broadcast at impala.py:1152–1217): env runners sample continuously (no sync
barrier); the learner consumes batches as they land, corrects for policy lag
with V-trace (Espeholt et al. 2018), and broadcasts fresh weights to each
runner as its next sample request is issued. APPO = same pipeline with the
PPO surrogate on top of V-trace advantages). V-trace is a reversed loop
over time under no_grad, the reference's lax.scan under stop_gradient.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import PiVf, RLModuleSpec, forward_pi_vf


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or IMPALA)
        self.lr = 5e-4
        self.rollout_fragment_length = 50
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_c_threshold = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.batches_per_iteration = 8
        self.broadcast_interval = 1  # updates between weight pushes
        self.num_env_runners = 2


@torch.no_grad()
def _vtrace(
    behavior_logp,
    target_logp,
    rewards,
    values,
    bootstrap_value,
    dones,
    gamma,
    clip_rho,
    clip_c,
):
    """V-trace targets/advantages over time-major [T, B] tensors, computed
    inside the loss (a reversed loop over time; no gradient flows)."""
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = torch.clamp(rhos, max=clip_rho)
    clipped_cs = torch.clamp(rhos, max=clip_c)
    # dones = terminated | truncated: truncation also cuts the recursion
    # (the next row belongs to a different episode after autoreset).
    discounts = gamma * (1.0 - dones)
    values_tp1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_tp1 - values)

    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = []
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * clipped_cs[t] * acc
        vs_minus_v.append(acc)
    vs_minus_v = torch.stack(vs_minus_v[::-1])
    vs = values + vs_minus_v
    vs_tp1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_advantages = clipped_rhos * (rewards + discounts * vs_tp1 - values)
    return vs, pg_advantages


class IMPALALearner(Learner):
    def __init__(self, spec: RLModuleSpec, cfg: Dict[str, Any], **kw):
        self.cfg = cfg
        super().__init__(spec, **kw)

    def init_module(self, generator):
        return PiVf(self.spec, generator)

    def _policy_loss(self, target_logp, behavior_logp, pg_adv):
        return -torch.mean(target_logp * pg_adv)

    def loss_fn(self, module, batch):
        c = self.cfg
        T, B = batch["rewards"].shape
        obs = batch["obs"].reshape(T * B, -1)
        logits, values = forward_pi_vf(module, obs)
        logits = logits.reshape(T, B, -1)
        values = values.reshape(T, B)
        logp_all = F.log_softmax(logits, dim=-1)
        target_logp = logp_all.gather(-1, batch["actions"][..., None])[..., 0]

        dones = torch.logical_or(
            batch["terminateds"], batch["truncateds"]
        ).to(torch.float32)
        vs, pg_adv = _vtrace(
            batch["behavior_logp"],
            target_logp,
            batch["rewards"],
            values,
            batch["bootstrap_value"],
            dones,
            c["gamma"],
            c["clip_rho"],
            c["clip_c"],
        )
        policy_loss = self._policy_loss(
            target_logp, batch["behavior_logp"], pg_adv
        )
        vf_loss = 0.5 * torch.mean(torch.square(values - vs))
        probs = F.softmax(logits, dim=-1)
        entropy = -torch.mean(torch.sum(probs * logp_all, dim=-1))
        loss = policy_loss + c["vf_loss_coeff"] * vf_loss - c["entropy_coeff"] * entropy
        return loss, {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
        }


class IMPALA(Algorithm):
    policy_kind = "pi_vf"

    def _learner_builder(self, obs_dim: int, num_actions: int) -> Callable[[str], Any]:
        cfg = self.config
        spec = RLModuleSpec(
            obs_dim=obs_dim,
            num_actions=num_actions,
            hidden=tuple(cfg.model.get("hidden", (64, 64))),
        )
        loss_cfg = {
            "gamma": cfg.gamma,
            "clip_rho": cfg.vtrace_clip_rho_threshold,
            "clip_c": cfg.vtrace_clip_c_threshold,
            "vf_loss_coeff": cfg.vf_loss_coeff,
            "entropy_coeff": cfg.entropy_coeff,
        }
        lr, grad_clip, seed = cfg.lr, cfg.grad_clip, cfg.seed

        def build(device):
            return IMPALALearner(spec, loss_cfg, lr=lr, grad_clip=grad_clip, seed=seed,
                                 device=device)

        return build

    def __init__(self, config: AlgorithmConfig):
        if config.num_env_runners < 1:
            raise ValueError("IMPALA requires num_env_runners >= 1")
        super().__init__(config)
        self._inflight: Dict[Any, tuple] = {}  # ref -> (actor_idx, submit_t)
        self._updates_since_broadcast: Dict[int, int] = {}

    def _ensure_inflight(self) -> None:
        """Heal dead/replaced runners, then keep one sample request in flight
        per healthy runner."""
        import time as _time

        cfg = self.config
        self.env_runner_group._heal()
        mgr = self.env_runner_group._manager
        healthy = set(mgr.healthy_actor_ids())
        # Drop requests pinned to runners that are gone (their refs may never
        # resolve) and requests that have outlived the sample timeout (hung
        # runner: mark unhealthy so _heal replaces it next round).
        now = _time.monotonic()
        for ref, (idx, t0) in list(self._inflight.items()):
            if idx not in healthy:
                del self._inflight[ref]
            elif now - t0 > cfg.sample_timeout_s:
                self.env_runner_group.mark_unhealthy(idx)
                del self._inflight[ref]
        have = {idx for idx, _ in self._inflight.values()}
        for i in healthy - have:
            try:
                ref = self.env_runner_group.submit_sample(
                    i, cfg.rollout_fragment_length
                )
            except Exception:
                self.env_runner_group.mark_unhealthy(i)
                continue
            self._inflight[ref] = (i, now)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        batches_done: List[Dict[str, Any]] = []
        metrics: Dict[str, float] = {}
        stale_total = 0
        while len(batches_done) < cfg.batches_per_iteration:
            self._ensure_inflight()
            if not self._inflight:
                raise RuntimeError("no healthy env runners for IMPALA")
            ready, _ = ray_tpu_torch.wait(
                list(self._inflight),
                num_returns=1,
                timeout=min(5.0, cfg.sample_timeout_s),
            )
            if not ready:
                continue
            ref = ready[0]
            actor_idx, _t0 = self._inflight.pop(ref)
            try:
                batch = ray_tpu_torch.get(ref)
            except Exception:
                self.env_runner_group.mark_unhealthy(actor_idx)
                continue
            self._env_steps_total += batch["env_steps"]
            stale_total += self._weights_version - batch["weights_version"]

            train_batch = {
                "obs": batch["obs"],
                "actions": batch["actions"],
                "behavior_logp": batch["logp"],
                "rewards": batch["rewards"],
                "terminateds": batch["terminateds"],
                "truncateds": batch["truncateds"],
                "bootstrap_value": batch["bootstrap_value"],
            }
            metrics = self.learner_group.update_from_batch(
                train_batch, time_major=True
            )
            batches_done.append(batch)

            # Async weight push to this runner, then immediately resubmit its
            # next sample so it never idles (reference impala.py broadcast).
            n = self._updates_since_broadcast.get(actor_idx, 0) + 1
            if n >= cfg.broadcast_interval:
                self._weights_version += 1
                self.env_runner_group._manager.actors[actor_idx].set_weights.remote(
                    self.learner_group.get_weights(), self._weights_version
                )
                self._updates_since_broadcast[actor_idx] = 0
            else:
                self._updates_since_broadcast[actor_idx] = n
            import time as _time

            try:
                new_ref = self.env_runner_group.submit_sample(
                    actor_idx, cfg.rollout_fragment_length
                )
                self._inflight[new_ref] = (actor_idx, _time.monotonic())
            except Exception:
                self.env_runner_group.mark_unhealthy(actor_idx)
        return {
            **self._episode_metrics(batches_done),
            **metrics,
            "mean_weight_staleness": stale_total / max(1, len(batches_done)),
        }


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__(algo_class=APPO)
        self.clip_param = 0.2


class APPOLearner(IMPALALearner):
    def _policy_loss(self, target_logp, behavior_logp, pg_adv):
        # PPO clipped surrogate on V-trace advantages (reference APPO loss).
        c = self.cfg
        ratio = torch.exp(target_logp - behavior_logp)
        surr1 = ratio * pg_adv
        surr2 = torch.clamp(ratio, 1 - c["clip_param"], 1 + c["clip_param"]) * pg_adv
        return -torch.mean(torch.minimum(surr1, surr2))


class APPO(IMPALA):
    def _learner_builder(self, obs_dim: int, num_actions: int) -> Callable[[str], Any]:
        cfg = self.config
        spec = RLModuleSpec(
            obs_dim=obs_dim,
            num_actions=num_actions,
            hidden=tuple(cfg.model.get("hidden", (64, 64))),
        )
        loss_cfg = {
            "gamma": cfg.gamma,
            "clip_rho": cfg.vtrace_clip_rho_threshold,
            "clip_c": cfg.vtrace_clip_c_threshold,
            "vf_loss_coeff": cfg.vf_loss_coeff,
            "entropy_coeff": cfg.entropy_coeff,
            "clip_param": cfg.clip_param,
        }
        lr, grad_clip, seed = cfg.lr, cfg.grad_clip, cfg.seed

        def build(device):
            return APPOLearner(spec, loss_cfg, lr=lr, grad_clip=grad_clip, seed=seed,
                               device=device)

        return build
