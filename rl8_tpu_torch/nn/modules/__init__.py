"""Basic modules (counterpart of ``rl8_tpu/nn/modules``)."""

from .activations import ACTIVATIONS, get_activation, squared_relu
from .mlp import MLP

__all__ = ["ACTIVATIONS", "MLP", "get_activation", "squared_relu"]
