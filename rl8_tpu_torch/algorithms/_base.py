"""Base algorithm definitions (counterpart of ``rl8_tpu/algorithms/_base.py``)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import asdict
from typing import Any, Generic, TypeVar

from ..data import AlgorithmHparams, CollectStats, StepStats
from ..env import Env

__all__ = ["GenericAlgorithmBase"]

_Hparams = TypeVar("_Hparams", bound=AlgorithmHparams)
_State = TypeVar("_State")
_Policy = TypeVar("_Policy")


class GenericAlgorithmBase(ABC, Generic[_Hparams, _State, _Policy]):
    """Generic algorithm ABC tying hparam/state/policy type params."""

    #: Environment being simulated (one object = ``num_envs`` instances).
    env: Env

    #: Frozen, validated hyperparameters.
    hparams: _Hparams

    #: Policy (model + action distribution); the model holds the parameters.
    policy: _Policy

    #: Dynamic train state.
    state: _State

    @property
    def horizons_per_env_reset(self) -> int:
        """Convenience passthrough used by trainers."""
        return self.hparams.horizons_per_env_reset

    @property
    def params(self) -> dict[str, Any]:
        """Flat dict of algorithm parameters for experiment tracking."""
        out: dict[str, Any] = {
            "env_cls": self.env.__class__.__name__,
            "model_cls": self.policy.model.__class__.__name__,  # type: ignore[attr-defined]
            "distribution_cls": self.policy.distribution_cls.__name__,  # type: ignore[attr-defined]
        }
        out.update(asdict(self.hparams))
        return {k: (v if v is not None else "None") for k, v in out.items()}

    @abstractmethod
    def collect(
        self, *, env_config: None | dict[str, Any] = None, deterministic: bool = False
    ) -> CollectStats:
        ...

    @abstractmethod
    def step(self) -> StepStats:
        ...

    @abstractmethod
    def validate(self) -> None:
        ...
