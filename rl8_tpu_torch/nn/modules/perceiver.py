"""Perceiver layers (counterpart of ``rl8_tpu/nn/modules/perceiver.py``):
cross-attention into a latent array followed by a self-attention stack
(Perceiver), optionally decoded into a fixed-size output array through a
learned output query (PerceiverIO)."""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .attention import CrossAttention, SelfAttentionStack
from .mlp import JaxLeaf, flax_init_, prefixed

__all__ = ["PerceiverLayer", "PerceiverIOLayer"]


class PerceiverLayer(nn.Module):
    """`Perceiver <https://arxiv.org/abs/2103.03206>`_ layer: cross-attention
    followed by a self-attention stack.

    Args:
        embed_dim: Feature dimension of the latent array and input sequence.
        num_heads: Attention heads for cross- and self-attention.
        hidden_dim: Hidden features of post-attention feedforwards.
        num_layers: Self-attention stack depth.
        activation_fn: Activation function ID.
        attention_dropout: Dropout on the attention weights.
        hidden_dropout: Feedforward dropout.
        skip_kind: Skip connection kind.
        share_parameters: Whether self-attention layers share parameters.
        dtype: Compute dtype (the parameters stay f32).

    """

    def __init__(
        self,
        embed_dim: int,
        num_heads: int = 2,
        hidden_dim: int = 128,
        num_layers: int = 2,
        activation_fn: str = "relu",
        attention_dropout: float = 0.0,
        hidden_dropout: float = 0.0,
        skip_kind: str = "cat",
        share_parameters: bool = False,
        dtype: Any = None,
    ) -> None:
        super().__init__()
        self.cross_attention = CrossAttention(
            embed_dim, num_heads, hidden_dim, activation_fn, attention_dropout, hidden_dropout, skip_kind, dtype
        )
        self.self_attention = SelfAttentionStack(
            embed_dim, num_layers, num_heads, hidden_dim, activation_fn, attention_dropout, hidden_dropout,
            skip_kind, share_parameters, dtype,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)

    def jax_leaves(self) -> dict[tuple[str, ...], JaxLeaf]:
        return {
            **prefixed(("cross_attention",), self.cross_attention.jax_leaves()),
            **prefixed(("self_attention",), self.self_attention.jax_leaves()),
        }

    def forward(
        self,
        q: torch.Tensor,
        kv: torch.Tensor,
        key_padding_mask: None | torch.Tensor = None,
        attention_mask: None | torch.Tensor = None,
        *,
        deterministic: bool = True,
    ) -> torch.Tensor:
        """``q [B, Q, E]`` (latent), ``kv [B, K, E]`` -> ``[B, Q, E]``."""
        latent = self.cross_attention(q, kv, key_padding_mask, attention_mask, deterministic=deterministic)
        return self.self_attention(latent, deterministic=deterministic)


class PerceiverIOLayer(nn.Module):
    """`PerceiverIO <https://arxiv.org/abs/2107.14795>`_ layer: a
    :class:`PerceiverLayer` decoded through a learned output query
    (``output_query [O, E]``, xavier-uniform) into ``output_seq_dim``
    elements.

    Args:
        embed_dim: Feature dimension of the latent array and input sequence.
        output_seq_dim: Output sequence size the latent array decodes to.
        (the rest as in :class:`PerceiverLayer`)

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.nn import PerceiverIOLayer
        >>> layer = PerceiverIOLayer(8, output_seq_dim=3, hidden_dim=16, num_layers=1)
        >>> layer.reset_parameters(torch.Generator().manual_seed(0))
        >>> tuple(layer(torch.randn(2, 4, 8), torch.randn(2, 5, 8)).shape)
        (2, 3, 8)

    """

    def __init__(
        self,
        embed_dim: int,
        output_seq_dim: int,
        num_heads: int = 2,
        hidden_dim: int = 128,
        num_layers: int = 2,
        activation_fn: str = "relu",
        attention_dropout: float = 0.0,
        hidden_dropout: float = 0.0,
        skip_kind: str = "cat",
        share_parameters: bool = False,
        dtype: Any = None,
    ) -> None:
        super().__init__()
        self.perceiver_layer = PerceiverLayer(
            embed_dim, num_heads, hidden_dim, num_layers, activation_fn, attention_dropout, hidden_dropout,
            skip_kind, share_parameters, dtype,
        )
        self.output_query = nn.Parameter(torch.zeros(output_seq_dim, embed_dim))
        self.decoder = CrossAttention(
            embed_dim, num_heads, hidden_dim, activation_fn, attention_dropout, hidden_dropout, skip_kind, dtype
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)
        with torch.no_grad():
            nn.init.xavier_uniform_(self.output_query, generator=generator)

    def jax_leaves(self) -> dict[tuple[str, ...], JaxLeaf]:
        return {
            **prefixed(("perceiver_layer",), self.perceiver_layer.jax_leaves()),
            ("output_query",): JaxLeaf(self.output_query, tuple(self.output_query.shape)),
            **prefixed(("decoder",), self.decoder.jax_leaves()),
        }

    def forward(
        self,
        q: torch.Tensor,
        kv: torch.Tensor,
        key_padding_mask: None | torch.Tensor = None,
        attention_mask: None | torch.Tensor = None,
        *,
        deterministic: bool = True,
    ) -> torch.Tensor:
        """``q [B, Q, E]`` (latent), ``kv [B, K, E]`` -> ``[B, O, E]``."""
        latent = self.perceiver_layer(q, kv, key_padding_mask, attention_mask, deterministic=deterministic)
        output_query = self.output_query[None].expand(q.shape[0], *self.output_query.shape)
        return self.decoder(output_query, latent, deterministic=deterministic)
