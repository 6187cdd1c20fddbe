"""Basic modules (counterpart of ``rl8_tpu/nn/modules``)."""

from .activations import ACTIVATIONS, get_activation, squared_relu
from .embeddings import OneHotEmbed, one_hot_embed
from .mlp import MLP, dense
from .normalization import LayerNorm

__all__ = ["ACTIVATIONS", "LayerNorm", "MLP", "OneHotEmbed", "dense", "get_activation", "one_hot_embed", "squared_relu"]
