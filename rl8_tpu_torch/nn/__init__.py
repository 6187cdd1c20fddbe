"""Top-level NN extensions (counterpart of ``rl8_tpu/nn``)."""

from .functional import generalized_advantage_estimate, ppo_losses
from .modules import ACTIVATIONS, MLP, get_activation, squared_relu

__all__ = [
    "ACTIVATIONS",
    "MLP",
    "generalized_advantage_estimate",
    "get_activation",
    "ppo_losses",
    "squared_relu",
]
