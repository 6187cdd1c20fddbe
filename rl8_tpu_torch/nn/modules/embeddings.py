"""Embeddings (counterpart of ``rl8_tpu/nn/modules/embeddings.py``)."""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .mlp import JaxLeaf

__all__ = ["OneHotEmbed", "PositionalEmbedding", "one_hot_embed", "sinusoidal_embedding"]


def sinusoidal_embedding(max_len: int, embed_dim: int) -> np.ndarray:
    """The sin/cos positional embedding table ``[max_len, embed_dim]``
    (f32): sines in the even columns, cosines in the odd ones."""
    pos = np.arange(max_len)[:, None]
    div = np.exp(-np.log(10_000.0) / embed_dim * np.arange(0, embed_dim, 2))
    pe = np.zeros((max_len, embed_dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    # Odd embed dims have one fewer cos column than sin columns.
    pe[:, 1::2] = np.cos(pos * div)[:, : embed_dim // 2]
    return pe


def one_hot_embed(table: torch.Tensor, idx: torch.Tensor, dtype: Any = None) -> torch.Tensor:
    """``one_hot(idx) @ table``: the rows of ``table [V, F]`` at ``idx``
    as a dense product, differentiable in ``table`` (the functional form
    of :class:`OneHotEmbed`, for fused-apply ``assemble`` functions). With
    a ``dtype`` the table is cast to it and the product runs and returns
    in it (``rl8_tpu/nn/modules/embeddings.py:76-85``, the port's
    :func:`~rl8_tpu_torch.nn.modules.mlp.dense` rule)."""
    if dtype is not None:
        table = table.to(dtype)
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
        dtype: Compute dtype of the product (``rl8_tpu``'s ``dtype``,
            ``embeddings.py:62,73``): the table stays an f32 parameter,
            is cast to ``dtype`` and the one-hot product runs and returns
            in it. ``None`` computes in the table's f32.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.nn.modules import OneHotEmbed
        >>> embed = OneHotEmbed(2, 3)
        >>> embed.reset_parameters(torch.Generator().manual_seed(0))
        >>> torch.equal(embed(torch.tensor([1, 0])), embed.embedding.flip(0))
        True
        >>> OneHotEmbed(2, 3, dtype=torch.bfloat16)(torch.tensor([1, 0])).dtype
        torch.bfloat16

    """

    def __init__(self, num_embeddings: int, features: int, dtype: Any = None) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num_embeddings, features))
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)``
        for a ``[V, F]`` table: fan-in is ``F``, so a plain normal with
        std ``sqrt(1 / F)``."""
        with torch.no_grad():
            self.embedding.normal_(0.0, math.sqrt(1.0 / self.embedding.shape[1]), generator=generator)

    def jax_leaves(self) -> dict[tuple[str, ...], JaxLeaf]:
        return {("embedding",): JaxLeaf(self.embedding, tuple(self.embedding.shape))}

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return one_hot_embed(self.embedding, idx, self.dtype)


class PositionalEmbedding(nn.Module):
    """Add (non-learned) sinusoidal positional embeddings to a sequence.
    The f32 table promotes a bf16 input to f32, as ``rl8_tpu``'s does.

    Args:
        embed_dim: Input feature dimension.
        max_len: Max input sequence length.
        dropout: Dropout on the output.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.nn import PositionalEmbedding
        >>> out = PositionalEmbedding(4, max_len=8)(torch.zeros(1, 2, 4))
        >>> [round(v, 4) for v in out[0, 1].tolist()]
        [0.8415, 0.5403, 0.01, 0.9999]

    """

    def __init__(self, embed_dim: int, max_len: int, dropout: float = 0.0) -> None:
        super().__init__()
        self.dropout = dropout
        self.register_buffer("pe", torch.from_numpy(sinusoidal_embedding(max_len, embed_dim)), persistent=False)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True) -> torch.Tensor:
        """``x [B, T, E]`` -> the same shape."""
        x = x + self.pe[None, : x.shape[1], :]
        if self.dropout and not deterministic:
            x = F.dropout(x, self.dropout)
        return x
