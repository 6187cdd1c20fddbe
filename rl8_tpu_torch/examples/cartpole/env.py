"""CartPole: infinite-horizon variant with continuous shaped reward.

PyTorch counterpart of ``examples/cartpole/env.py``. The step is a chain
of small tensor ops on the env's device. The physics config stays in the
env state as Python values (strings included), so the integrator is a
plain Python branch and no step reads the device.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any

import torch

from rl8_tpu_torch.env import Env, EnvConfig, EnvState
from rl8_tpu_torch.specs import Discrete, Unbounded

__all__ = ["CartPole", "CartPoleConfig"]


@dataclass
class CartPoleConfig:
    """Physics parameters."""

    cart_mass: float = 1.0
    force_mag: float = 5.0
    gravity: float = 9.8
    #: ``"euler"`` (explicit) or anything else for semi-implicit Euler.
    kinematics_integrator: str = "euler"
    length: float = 0.5
    pole_mass: float = 0.1
    tau: float = 0.02
    #: Pole mass * pole length. Derived — not settable; passing it via an
    #: env config raises instead of being silently recomputed.
    pole_mass_length: float = field(init=False)
    #: Pole mass + cart mass. Derived — not settable.
    total_mass: float = field(init=False)

    def __post_init__(self) -> None:
        self.pole_mass_length = self.pole_mass * self.length
        self.total_mass = self.cart_mass + self.pole_mass


def _observe(x: torch.Tensor, x_dot: torch.Tensor, theta: torch.Tensor, theta_dot: torch.Tensor) -> torch.Tensor:
    return torch.stack((x, x_dot, torch.cos(theta), torch.sin(theta), theta_dot), dim=1)


def _step_physics(
    phys: torch.Tensor, action: torch.Tensor, cfg: dict[str, Any]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched cart-pole dynamics: ``phys [B, 4]`` = (x, x_dot, theta,
    theta_dot); Euler integration and the shaped infinite-horizon reward."""
    x, x_dot, theta, theta_dot = phys.unbind(1)
    pole_mass_length = cfg["pole_mass_length"]
    total_mass = cfg["total_mass"]

    force = (action.reshape(-1).to(torch.float32) - 1) * cfg["force_mag"]
    costheta = torch.cos(theta)
    sintheta = torch.sin(theta)

    tmp = (force + pole_mass_length * theta_dot**2 * sintheta) / total_mass
    theta_acc = (cfg["gravity"] * sintheta - costheta * tmp) / (
        cfg["length"] * (4.0 / 3.0 - cfg["pole_mass"] * costheta**2 / total_mass)
    )
    x_acc = tmp - pole_mass_length * theta_acc * costheta / total_mass

    tau = cfg["tau"]
    x_dot_new = x_dot + tau * x_acc
    theta_dot_new = theta_dot + tau * theta_acc
    if cfg["kinematics_integrator"] == "euler":
        x = x + tau * x_dot
        theta = theta + tau * theta_dot
    else:  # semi-implicit Euler
        x = x + tau * x_dot_new
        theta = theta + tau * theta_dot_new
    x_dot = x_dot_new
    theta_dot = theta_dot_new

    phys = torch.stack((x, x_dot, theta, theta_dot), dim=1)
    obs = _observe(x, x_dot, theta, theta_dot)
    # Shaped reward: distance of (cos, sin) from upright plus magnitudes
    # of x, x_dot, theta_dot.
    theta_error = (obs[:, 2] - 1.0).abs() + obs[:, 3].abs()
    other_errors = x.abs() + x_dot.abs() + theta_dot.abs()
    reward = -(theta_error + other_errors)[:, None]
    return phys, obs, reward


class CartPole(Env):
    """Reimplementation of the classic CartPole environment.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.examples.cartpole import CartPole
        >>> env = CartPole(2, device="cpu")
        >>> state, obs = env.reset(torch.Generator().manual_seed(0), config={"gravity": 1.0})
        >>> tuple(obs.shape), state["cfg"]["gravity"]
        ((2, 5), 1.0)
        >>> state, obs, reward = env.step(state, torch.full((2, 1), 2, dtype=torch.int32))
        >>> tuple(reward.shape), bool((reward <= 0).all())
        ((2, 1), True)

    """

    max_horizon = 128

    def __init__(self, num_envs: int, /, horizon: None | int = None, *, device: Any = "cuda") -> None:
        super().__init__(num_envs, horizon, device=device)
        self.observation_spec = Unbounded(5)
        self.action_spec = Discrete(3, shape=(1,))

    def reset(
        self,
        generator: torch.Generator,
        *,
        state: EnvState = None,
        config: EnvConfig = None,
    ) -> tuple[EnvState, torch.Tensor]:
        # As in rl8_tpu, a reset without a config rebuilds the defaults.
        cfg = asdict(CartPoleConfig(**(config or {})))
        phys = 0.01 * torch.randn((self.num_envs, 4), generator=generator, device=self.device)
        return {"phys": phys, "cfg": cfg}, _observe(*phys.unbind(1))

    def step(self, state: EnvState, action: torch.Tensor) -> tuple[EnvState, torch.Tensor, torch.Tensor]:
        phys, obs, reward = _step_physics(state["phys"], action, state["cfg"])
        return {"phys": phys, "cfg": state["cfg"]}, obs, reward
