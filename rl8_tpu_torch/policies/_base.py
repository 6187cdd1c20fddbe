"""Base policy definitions (counterpart of ``rl8_tpu/policies/_base.py``).

A policy is the union of a model and an action distribution.
"""

from __future__ import annotations

from typing import Any, Generic, TypeVar

from ..distributions import Distribution
from ..specs import Spec

__all__ = ["GenericPolicyBase"]

_Model = TypeVar("_Model")


class GenericPolicyBase(Generic[_Model]):
    """The base policy, bound to a particular model type."""

    #: Action distribution class instantiated from model features.
    distribution_cls: type[Distribution]

    #: Underlying model (an ``nn.Module`` holding the parameters).
    model: _Model

    #: Model config kwargs used at construction.
    model_config: dict[str, Any]

    @property
    def action_spec(self) -> Spec:
        """Spec defining the policy's action distribution outputs."""
        return self.model.action_spec  # type: ignore[attr-defined]

    @property
    def observation_spec(self) -> Spec:
        """Spec defining the policy's model inputs."""
        return self.model.observation_spec  # type: ignore[attr-defined]
