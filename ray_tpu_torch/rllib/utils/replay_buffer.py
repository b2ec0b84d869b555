"""Uniform FIFO replay buffer for off-policy algorithms.

Analog of rllib/utils/replay_buffers/episode_replay_buffer.py, flattened to
transition storage (obs, action, reward, next_obs, done) in preallocated
numpy rings — O(1) add, vectorized uniform sample.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, obs_dim: int, seed: int = 0, act_dim: int = 0):
        """act_dim 0 -> discrete int actions; >0 -> continuous float vectors
        (SAC)."""
        self.capacity = capacity
        self.act_dim = act_dim
        self.obs = np.empty((capacity, obs_dim), dtype=np.float32)
        self.next_obs = np.empty((capacity, obs_dim), dtype=np.float32)
        if act_dim:
            self.actions = np.empty((capacity, act_dim), dtype=np.float32)
        else:
            self.actions = np.empty((capacity,), dtype=np.int64)
        self.rewards = np.empty((capacity,), dtype=np.float32)
        self.dones = np.empty((capacity,), dtype=np.float32)
        self._size = 0
        self._head = 0
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        """batch: time-major [T, N, ...] arrays from an EnvRunner.sample()."""
        obs = batch["obs"].reshape(-1, batch["obs"].shape[-1])
        next_obs = batch["next_obs"].reshape(-1, batch["next_obs"].shape[-1])
        if self.act_dim:
            actions = batch["actions"].reshape(-1, self.act_dim)
        else:
            actions = batch["actions"].reshape(-1)
        rewards = batch["rewards"].reshape(-1)
        dones = batch["terminateds"].reshape(-1).astype(np.float32)
        n = len(obs)
        idx = (self._head + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.next_obs[idx] = next_obs
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.dones[idx] = dones
        self._head = (self._head + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.randint(0, self._size, size=batch_size)
        return {
            "obs": self.obs[idx],
            "next_obs": self.next_obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "dones": self.dones[idx],
        }
