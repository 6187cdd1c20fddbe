"""Basic modules (counterpart of ``rl8_tpu/nn/modules``)."""

from .activations import ACTIVATIONS, SquaredReLU, get_activation, squared_relu
from .attention import CrossAttention, PointerNetwork, SelfAttention, SelfAttentionStack
from .embeddings import OneHotEmbed, PositionalEmbedding, one_hot_embed
from .mlp import MLP, dense
from .normalization import LayerNorm
from .perceiver import PerceiverIOLayer, PerceiverLayer
from .skip import SequentialSkipConnection

__all__ = [
    "ACTIVATIONS",
    "CrossAttention",
    "LayerNorm",
    "MLP",
    "OneHotEmbed",
    "PerceiverIOLayer",
    "PerceiverLayer",
    "PointerNetwork",
    "PositionalEmbedding",
    "SelfAttention",
    "SelfAttentionStack",
    "SequentialSkipConnection",
    "SquaredReLU",
    "dense",
    "get_activation",
    "one_hot_embed",
    "squared_relu",
]
