"""Embeddings (counterpart of ``rl8_tpu/nn/modules/embeddings.py``).

``PositionalEmbedding`` comes with the attention models, in a later
slice (ROADMAP Queue 1 #5).
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["OneHotEmbed", "one_hot_embed"]


def one_hot_embed(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``one_hot(idx) @ table``: the rows of ``table [V, F]`` at ``idx``
    as a dense product, differentiable in ``table`` (the functional form
    of :class:`OneHotEmbed`, for fused-apply ``assemble`` functions)."""
    onehot = torch.nn.functional.one_hot(idx.to(torch.int64), table.shape[0]).to(table.dtype)
    return onehot @ table


class OneHotEmbed(nn.Module):
    """Tiny-vocabulary embedding lookup as a one-hot product, with
    ``rl8_tpu``'s parameter layout: an ``embedding`` table
    ``[num_embeddings, features]``.

    Args:
        num_embeddings: Vocabulary size (the product does this many
            multiply-adds per output).
        features: Embedding feature dimension.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.nn.modules import OneHotEmbed
        >>> embed = OneHotEmbed(2, 3)
        >>> embed.reset_parameters(torch.Generator().manual_seed(0))
        >>> torch.equal(embed(torch.tensor([1, 0])), embed.embedding.flip(0))
        True

    """

    def __init__(self, num_embeddings: int, features: int) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num_embeddings, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)``
        for a ``[V, F]`` table: fan-in is ``F``, so a plain normal with
        std ``sqrt(1 / F)``."""
        with torch.no_grad():
            self.embedding.normal_(0.0, math.sqrt(1.0 / self.embedding.shape[1]), generator=generator)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return one_hot_embed(self.embedding, idx)
