"""MountainCar: classic underpowered-car hill climb with reward shaping.

PyTorch counterpart of ``examples/mountain_car/env.py``; the physics
config stays in the env state as Python values.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any

import torch

from rl8_tpu_torch.env import Env, EnvConfig, EnvState
from rl8_tpu_torch.specs import Discrete, Unbounded

__all__ = ["MountainCar", "MountainCarConfig"]


@dataclass
class MountainCarConfig:
    """Physics parameters."""

    force_mag: float = 0.001
    goal_position: float = 0.5
    goal_velocity: float = 0.0
    gravity: float = 0.0025
    max_position: float = 0.6
    max_speed: float = 0.07
    min_position: float = -1.2


def _step_physics(
    phys: torch.Tensor, action: torch.Tensor, cfg: dict[str, Any]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``phys [B, 2]`` = (position, velocity); clip-based dynamics with a
    shaped distance reward and a goal bonus."""
    position, velocity = phys.unbind(1)
    velocity = (
        velocity
        + (action.reshape(-1).to(torch.float32) - 1) * cfg["force_mag"]
        - cfg["gravity"] * torch.cos(3 * position)
    )
    velocity = torch.clamp(velocity, -cfg["max_speed"], cfg["max_speed"])
    position = torch.clamp(position + velocity, cfg["min_position"], cfg["max_position"])
    velocity = torch.where((position == cfg["min_position"]) & (velocity < 0), 0.0, velocity)
    reward = -(position - cfg["goal_position"]).abs()
    reward = torch.where((position >= cfg["goal_position"]) & (velocity >= cfg["goal_velocity"]), 1.0, reward)
    phys = torch.stack((position, velocity), dim=1)
    return phys, phys, reward[:, None]


class MountainCar(Env):
    """Reimplementation of the classic MountainCar environment.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.examples.mountain_car import MountainCar
        >>> env = MountainCar(2, device="cpu")
        >>> state, obs = env.reset(torch.Generator().manual_seed(0))
        >>> state, obs, reward = env.step(state, torch.ones((2, 1), dtype=torch.int32))
        >>> tuple(obs.shape), tuple(reward.shape)
        ((2, 2), (2, 1))

    """

    max_horizon = 512

    def __init__(self, num_envs: int, /, horizon: None | int = None, *, device: Any = "cuda") -> None:
        super().__init__(num_envs, horizon, device=device)
        self.observation_spec = Unbounded(2)
        self.action_spec = Discrete(3, shape=(1,))

    def reset(
        self,
        generator: torch.Generator,
        *,
        state: EnvState = None,
        config: EnvConfig = None,
    ) -> tuple[EnvState, torch.Tensor]:
        cfg = asdict(MountainCarConfig(**(config or {})))
        z = torch.randn((2, self.num_envs), generator=generator, device=self.device)
        phys = torch.stack((-0.5 + 0.05 * z[0], 0.05 * z[1]), dim=1)
        return {"phys": phys, "cfg": cfg}, phys

    def step(self, state: EnvState, action: torch.Tensor) -> tuple[EnvState, torch.Tensor, torch.Tensor]:
        phys, obs, reward = _step_physics(state["phys"], action, state["cfg"])
        return {"phys": phys, "cfg": state["cfg"]}, obs, reward
