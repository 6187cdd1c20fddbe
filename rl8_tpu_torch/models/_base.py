"""Base model definitions (counterpart of ``rl8_tpu/models/_base.py``).

Models are ``nn.Module``s whose forward returns ``(features, values)``
directly, as the JAX package's pure ``__call__`` does.
"""

from __future__ import annotations

from torch import nn

from ..specs import Spec

__all__ = ["GenericModelBase"]


class GenericModelBase(nn.Module):
    """Base class for feedforward (and, later, recurrent) models.

    Args:
        observation_spec: Spec defining the forward pass input.
        action_spec: Spec defining the outputs of the policy's action
            distribution that this model is a component of.

    """

    observation_spec: Spec
    action_spec: Spec

    def __init__(self, observation_spec: Spec, action_spec: Spec, /) -> None:
        super().__init__()
        self.observation_spec = observation_spec
        self.action_spec = action_spec
