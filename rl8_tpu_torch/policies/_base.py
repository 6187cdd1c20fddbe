"""Base policy definitions (counterpart of ``rl8_tpu/policies/_base.py``).

A policy is the union of a model and an action distribution. Policies
export with :meth:`GenericPolicyBase.save` and come back with
:meth:`GenericPolicyBase.load` (``rl8_tpu``'s ``Policy.save``/``load``).
"""

from __future__ import annotations

import copy
import pickle
from os import PathLike
from typing import Any, Generic, TypeVar

import torch

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

    def init_params(self, generator: torch.Generator, /) -> None:
        """Initialize the model's parameters in place from ``generator``
        (``rl8_tpu``'s ``init_params(key)`` returns them instead)."""
        raise NotImplementedError

    def save(self, path: str | PathLike[str], /) -> None:
        """Pickle the policy (its model config, distribution and
        parameters, moved to the CPU) to ``path``: the counterpart of
        ``rl8_tpu``'s ``save(path, params)``, whose parameters live
        outside the policy. Here they live in the model, so there is no
        params argument; the policy itself is left on its device."""
        policy = copy.copy(self)
        policy.model = copy.deepcopy(self.model).to("cpu")  # type: ignore[attr-defined]
        with open(path, "wb") as f:
            pickle.dump({"policy": policy}, f)

    @classmethod
    def load(cls, path: str | PathLike[str], /, device: Any = None) -> Any:
        """Load a policy exported with :meth:`save`, with its parameters on
        ``device``: the card unless the caller asks for the CPU
        (``device="cpu"``). Returns the policy alone, where ``rl8_tpu``'s
        ``load`` returns ``(policy, params)``: the parameters are in its
        model. The file is unpickled: load only files you trust."""
        with open(path, "rb") as f:
            policy = pickle.load(f)["policy"]
        if not isinstance(policy, cls):
            raise TypeError(f"{path} holds a {type(policy).__name__}, not a {cls.__name__}.")
        policy.model.to(torch.device("cuda" if device is None else device))
        return policy
