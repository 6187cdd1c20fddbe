"""Top-level NN extensions (counterpart of ``rl8_tpu/nn``)."""

from .functional import generalized_advantage_estimate, ppo_losses
from .modules import ACTIVATIONS, MLP, LayerNorm, OneHotEmbed, dense, get_activation, one_hot_embed, squared_relu

__all__ = [
    "ACTIVATIONS",
    "LayerNorm",
    "MLP",
    "OneHotEmbed",
    "dense",
    "generalized_advantage_estimate",
    "get_activation",
    "one_hot_embed",
    "ppo_losses",
    "squared_relu",
]
