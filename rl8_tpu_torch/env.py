"""Environment protocol and dummy environments.

PyTorch counterpart of ``rl8_tpu/env.py``. Environments keep the pure
functional form of the JAX package, over dicts of tensors:

- ``reset(generator, *, state=None, config=None) -> (state, obs)``
- ``step(state, action) -> (state, obs, reward)``

One ``Env`` simulates ``num_envs`` instances in lockstep as batched
tensors on ``device``. Random draws take an explicit ``torch.Generator``
that lives on that device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, ClassVar, Protocol

import torch

from .specs import Discrete, Spec, Unbounded

__all__ = [
    "Env",
    "EnvFactory",
    "GenericEnv",
    "DummyEnv",
    "ContinuousDummyEnv",
    "DiscreteDummyEnv",
]

EnvState = Any
EnvConfig = dict[str, Any] | None


class Env(ABC):
    """Protocol for highly parallelized, infinite-horizon environments.

    Args:
        num_envs: Number of parallel, independent environment instances
            simulated in lockstep by this one object.
        horizon: Number of steps the environment expects to take before
            being reset. ``None`` suggests the environment may never reset.
        device: Device holding the environment's tensors: the card by
            default, as ``AlgorithmConfig.device``; pass ``"cpu"`` for
            the CPU.

    """

    #: Spec defining the environment's inputs (actions).
    action_spec: Spec

    #: Spec defining the environment's observation outputs.
    observation_spec: Spec

    #: Optional cap on ``horizon``, validated at construction.
    max_horizon: ClassVar[int]

    #: Optional cap on ``num_envs``, validated at construction.
    max_num_envs: ClassVar[int]

    #: Number of parallel and independent environments being simulated.
    num_envs: int

    #: Expected steps per reset; ``None`` = may never reset.
    horizon: None | int

    #: Device holding the environment's tensors.
    device: torch.device

    def __init__(
        self, num_envs: int, /, horizon: None | int = None, *, device: Any = "cuda"
    ) -> None:
        if hasattr(self, "max_horizon") and horizon is not None:
            if not (horizon <= self.max_horizon):
                raise ValueError(
                    f"{self.__class__.__name__} `horizon` must be <= {self.max_horizon}."
                )
        if hasattr(self, "max_num_envs"):
            if not (num_envs <= self.max_num_envs):
                raise ValueError(
                    f"{self.__class__.__name__} `num_envs` must be <= {self.max_num_envs}."
                )
        self.num_envs = num_envs
        self.horizon = horizon
        self.device = torch.device(device)

    @abstractmethod
    def reset(
        self,
        generator: torch.Generator,
        *,
        state: EnvState = None,
        config: EnvConfig = None,
    ) -> tuple[EnvState, Any]:
        """Reset the environment, returning fresh state and the initial
        observation (spec :attr:`observation_spec`, batch ``[num_envs, ...]``).

        Args:
            generator: Generator on :attr:`device` for stochastic
                initialization.
            state: Previous state, if any. Lets per-reset config persist
                when ``config`` is ``None``.
            config: Optional configuration applied to this reset.

        """

    @abstractmethod
    def step(self, state: EnvState, action: Any) -> tuple[EnvState, Any, torch.Tensor]:
        """Apply an action (spec :attr:`action_spec`) and simulate one
        transition.

        Returns:
            ``(new_state, obs, rewards)`` where ``rewards`` has shape
            ``[num_envs, 1]``.

        """


class EnvFactory(Protocol):
    """Factory protocol describing how to create an environment instance."""

    max_horizon: ClassVar[int]
    max_num_envs: ClassVar[int]

    def __call__(
        self, num_envs: int, /, horizon: None | int = None, *, device: Any = "cuda"
    ) -> Env:
        ...


class GenericEnv(Env):
    """Generic version of :class:`Env` for environments with constant specs."""


class DummyEnv(GenericEnv):
    """The simplest environment possible, for testing and debugging.

    The state is a position along a 1D axis; the action perturbs it; the
    reward is the negative distance from the origin.
    """

    #: Default state-magnitude bound for initial-state sampling.
    default_bounds: float = 100.0

    def __init__(
        self, num_envs: int, /, horizon: None | int = None, *, device: Any = "cuda"
    ) -> None:
        super().__init__(num_envs, horizon, device=device)
        self.observation_spec = Unbounded(1)

    def reset(
        self,
        generator: torch.Generator,
        *,
        state: EnvState = None,
        config: EnvConfig = None,
    ) -> tuple[EnvState, torch.Tensor]:
        config = config or {}
        if "bounds" in config:
            bounds = torch.as_tensor(config["bounds"], dtype=torch.float32, device=self.device)
        elif state is not None:
            bounds = state["bounds"]
        else:
            bounds = torch.tensor(self.default_bounds, dtype=torch.float32, device=self.device)
        u = torch.rand(
            (self.num_envs, 1), generator=generator, dtype=torch.float32, device=self.device
        )
        pos = (2.0 * u - 1.0) * bounds
        return {"position": pos, "bounds": bounds}, pos


class ContinuousDummyEnv(DummyEnv):
    """Continuous dummy env: the action moves the state by any magnitude."""

    def __init__(
        self, num_envs: int, /, horizon: None | int = None, *, device: Any = "cuda"
    ) -> None:
        super().__init__(num_envs, horizon, device=device)
        self.action_spec = Unbounded(1)

    def step(self, state: EnvState, action: torch.Tensor) -> tuple[EnvState, torch.Tensor, torch.Tensor]:
        pos = state["position"] + action
        return {"position": pos, "bounds": state["bounds"]}, pos, -pos.abs()


class DiscreteDummyEnv(DummyEnv):
    """Discrete dummy env: the action moves the state left/right one unit.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.env import DiscreteDummyEnv
        >>> env = DiscreteDummyEnv(2, device="cpu")
        >>> state, obs = env.reset(torch.Generator().manual_seed(0))
        >>> tuple(obs.shape)
        (2, 1)
        >>> state, obs, rewards = env.step(state, torch.ones((2, 1), dtype=torch.int32))
        >>> tuple(rewards.shape)  # reward = -|position|
        (2, 1)

    """

    def __init__(
        self, num_envs: int, /, horizon: None | int = None, *, device: Any = "cuda"
    ) -> None:
        super().__init__(num_envs, horizon, device=device)
        self.action_spec = Discrete(2, shape=(1,))

    def step(self, state: EnvState, action: torch.Tensor) -> tuple[EnvState, torch.Tensor, torch.Tensor]:
        pos = state["position"] + (2 * action - 1).to(torch.float32)
        return {"position": pos, "bounds": state["bounds"]}, pos, -pos.abs()
