"""Pendulum: classic continuous-control swing-up.

PyTorch counterpart of ``examples/pendulum/env.py``; the physics config
stays in the env state as Python values.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Any

import torch

from rl8_tpu_torch.env import Env, EnvConfig, EnvState
from rl8_tpu_torch.specs import Unbounded

__all__ = ["Pendulum", "PendulumConfig"]


@dataclass
class PendulumConfig:
    """Physics parameters."""

    dt: float = 0.05
    g: float = 10.0
    l: float = 1.0  # noqa: E741
    m: float = 1.0
    max_speed: float = 8.0
    max_torque: float = 2.0


def _step_physics(
    phys: torch.Tensor, action: torch.Tensor, cfg: dict[str, Any]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``phys [B, 2]`` = (theta, theta_dot); torque-limited dynamics and
    the negative quadratic cost. The angle wraps into [-pi, pi) with a
    floor modulo (``%``, as JAX's), not ``fmod``."""
    th, thdot = phys.unbind(1)
    u = torch.clamp(action.reshape(-1), -cfg["max_torque"], cfg["max_torque"])
    costs = (((th + math.pi) % (2 * math.pi)) - math.pi) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
    newthdot = thdot + (
        3 * cfg["g"] / (2 * cfg["l"]) * torch.sin(th) + 3.0 / (cfg["m"] * cfg["l"] ** 2) * u
    ) * cfg["dt"]
    newthdot = torch.clamp(newthdot, -cfg["max_speed"], cfg["max_speed"])
    newth = th + newthdot * cfg["dt"]
    phys = torch.stack((newth, newthdot), dim=1)
    obs = torch.stack((torch.cos(newth), torch.sin(newth), newthdot), dim=1)
    return phys, obs, -costs[:, None]


class Pendulum(Env):
    """Reimplementation of the classic Pendulum environment.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.examples.pendulum import Pendulum
        >>> env = Pendulum(2, device="cpu")
        >>> state, obs = env.reset(torch.Generator().manual_seed(0))
        >>> state, obs, reward = env.step(state, torch.zeros((2, 1)))
        >>> tuple(obs.shape), bool((reward <= 0).all())
        ((2, 3), True)

    """

    max_horizon = 512

    def __init__(self, num_envs: int, /, horizon: None | int = None, *, device: Any = "cuda") -> None:
        super().__init__(num_envs, horizon, device=device)
        self.action_spec = Unbounded(1)
        self.observation_spec = Unbounded(3)

    def reset(
        self,
        generator: torch.Generator,
        *,
        state: EnvState = None,
        config: EnvConfig = None,
    ) -> tuple[EnvState, torch.Tensor]:
        cfg = asdict(PendulumConfig(**(config or {})))
        u = torch.rand((2, self.num_envs), generator=generator, device=self.device)
        th = -math.pi + 2 * math.pi * u[0]
        thdot = -1.0 + 2.0 * u[1]
        phys = torch.stack((th, thdot), dim=1)
        obs = torch.stack((torch.cos(th), torch.sin(th), thdot), dim=1)
        return {"phys": phys, "cfg": cfg}, obs

    def step(self, state: EnvState, action: torch.Tensor) -> tuple[EnvState, torch.Tensor, torch.Tensor]:
        phys, obs, reward = _step_physics(state["phys"], action, state["cfg"])
        return {"phys": phys, "cfg": state["cfg"]}, obs, reward
