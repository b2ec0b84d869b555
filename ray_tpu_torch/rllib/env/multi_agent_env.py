"""MultiAgentEnv API (reference: rllib/env/multi_agent_env.py MultiAgentEnv).

Dict-keyed multi-agent episodes: reset/step consume and produce per-agent
dicts, with the reserved "__all__" key in terminateds/truncateds signalling
episode end for everyone. Spaces are per-agent dicts so different agents may
have different observation/action shapes (policies are grouped by shared
spaces via the policy mapping).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple


class MultiAgentEnv:
    """Subclass and implement reset/step; fill observation_spaces /
    action_spaces with gymnasium spaces keyed by agent id."""

    # agent_id -> gymnasium.Space
    observation_spaces: Dict[Any, Any] = {}
    action_spaces: Dict[Any, Any] = {}

    @property
    def agents(self):
        return sorted(self.observation_spaces.keys())

    def reset(self, *, seed: Optional[int] = None) -> Tuple[Dict, Dict]:
        """-> (obs_dict, info_dict)"""
        raise NotImplementedError

    def step(
        self, action_dict: Dict[Any, Any]
    ) -> Tuple[Dict, Dict, Dict, Dict, Dict]:
        """-> (obs, rewards, terminateds, truncateds, infos); terminateds and
        truncateds carry the "__all__" aggregate key."""
        raise NotImplementedError

    def close(self) -> None:
        pass
