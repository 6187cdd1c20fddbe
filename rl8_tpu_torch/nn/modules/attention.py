"""Attention modules (counterpart of ``rl8_tpu/nn/modules/attention.py``).

``rl8_tpu`` computes multi-head attention in one of two layouts: flax's
``MultiHeadDotProductAttention`` and, for windows of at most 16 and
embeddings of at most 64, a batch-last layout that suits the TPU's vector
tiles. Both compute the same function with the same parameters; here it
is one multi-head attention in the usual ``[B, H, S, dh]`` layout, with
their math: the query scaled by ``1 / sqrt(dh)`` (rounded to the compute
dtype) before the product, masked scores set to the compute dtype's
finite minimum (not ``-inf``, so a fully masked row attends uniformly),
and the softmax in the compute dtype. The products are plain ``matmul``s.

Mask conventions:

- ``key_padding_mask [B, K]``: ``True`` marks padded (invalid) keys.
- ``attention_mask [Q, K]``: ``True`` marks pairs that may attend.

A ``dtype`` is flax's compute dtype: the parameters stay f32, the
LayerNorms normalize in f32 and return ``dtype``, and every projection,
score and softmax is computed in ``dtype``. Every module's
``reset_parameters(generator)`` applies flax's initializers, and its
``jax_leaves()`` names its parameters in ``rl8_tpu``'s flax tree.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..functional import masked_log_softmax
from .activations import get_activation
from .mlp import JaxLeaf, dense, dense_leaves, flax_init_, prefixed
from .normalization import LayerNorm
from .skip import SequentialSkipConnection

__all__ = ["PointerNetwork", "CrossAttention", "SelfAttention", "SelfAttentionStack"]


class PointerNetwork(nn.Module):
    """3D attention for selecting the next encoder element to append to a
    decoder sequence (`Pointer Networks <https://arxiv.org/abs/1506.03134>`_).

    Args:
        embed_dim: Feature dimension of the projections.
        in_features: Feature dimension ``C`` of the encoder and decoder
            outputs (``embed_dim`` by default).

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.nn import PointerNetwork
        >>> logp = PointerNetwork(4)(torch.zeros(2, 3, 4), torch.zeros(2, 5, 4))
        >>> tuple(logp.shape), round(float(logp.exp().sum(-1)[0, 0]), 4)
        ((2, 3, 5), 1.0)

    """

    def __init__(self, embed_dim: int, in_features: None | int = None) -> None:
        super().__init__()
        in_features = embed_dim if in_features is None else in_features
        self.W1 = nn.Linear(in_features, embed_dim, bias=False)
        self.W2 = nn.Linear(in_features, embed_dim, bias=False)
        self.VT = nn.Linear(embed_dim, 1, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)

    def jax_leaves(self) -> dict[tuple[str, ...], JaxLeaf]:
        leaves = {}
        for name in ("W1", "W2", "VT"):
            leaves.update(prefixed((name,), dense_leaves(getattr(self, name))))
        return leaves

    def forward(
        self, decoder_out: torch.Tensor, encoder_out: torch.Tensor, mask: None | torch.Tensor = None
    ) -> torch.Tensor:
        """Log-probabilities ``[B, D, E]`` of each encoder element (``[B, E,
        C]``) per decoder element (``[B, D, C]``); ``mask [B, D, E]``,
        ``True`` = selectable."""
        encoder_proj = self.W1(encoder_out)[:, None, :, :]
        decoder_proj = self.W2(decoder_out)[:, :, None, :]
        weights = self.VT(torch.tanh(decoder_proj + encoder_proj))[..., 0]
        return masked_log_softmax(weights, mask=mask, dim=-1)


def _combine_masks(
    B: int, Q: int, K: int, key_padding_mask: None | torch.Tensor, attention_mask: None | torch.Tensor
) -> None | torch.Tensor:
    """The attention mask ``[B, 1, Q, K]`` (``True`` = attend), or ``None``."""
    mask = None
    if key_padding_mask is not None:
        mask = (~key_padding_mask.to(torch.bool))[:, None, None, :].expand(B, 1, Q, K)
    if attention_mask is not None:
        am = attention_mask.to(torch.bool)[None, None, :, :]
        mask = am if mask is None else (mask & am)
    return mask


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last dim, each op in ``x``'s dtype."""
    unnormalized = torch.exp(x - x.amax(dim=-1, keepdim=True).detach())
    return unnormalized / unnormalized.sum(dim=-1, keepdim=True)


class _MultiHeadAttention(nn.Module):
    """Multi-head attention with flax's parameters: ``query``, ``key`` and
    ``value`` ``DenseGeneral``s to ``[H, dh]`` (here ``nn.Linear(E, H *
    dh)``) and ``out`` from ``[H, dh]`` back to ``E``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, dtype: Any = None) -> None:
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} must be divisible by num_heads {num_heads}.")
        self.num_heads = num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.query, self.key, self.value, self.out = (nn.Linear(embed_dim, embed_dim) for _ in range(4))

    def jax_leaves(self) -> dict[tuple[str, ...], JaxLeaf]:
        E = self.out.weight.shape[0]
        H, dh = self.num_heads, E // self.num_heads
        leaves = {}
        for name in ("query", "key", "value"):
            leaves.update(prefixed((name,), dense_leaves(getattr(self, name), (E, H, dh), (H, dh))))
        leaves.update(prefixed(("out",), dense_leaves(self.out, (H, dh, E), (E,))))
        return leaves

    def forward(
        self, q: torch.Tensor, kv: torch.Tensor, mask: None | torch.Tensor = None, deterministic: bool = True
    ) -> torch.Tensor:
        """``q [B, Q, E]``, ``kv [B, K, E]``, ``mask [B, 1, Q, K]`` (``True``
        = may attend) -> ``[B, Q, E]``."""
        B, Q, E = q.shape
        K, H = kv.shape[1], self.num_heads
        dh = E // H
        qh = dense(self.query, q, self.dtype).view(B, Q, H, dh).transpose(1, 2)
        kh = dense(self.key, kv, self.dtype).view(B, K, H, dh).transpose(1, 2)
        vh = dense(self.value, kv, self.dtype).view(B, K, H, dh).transpose(1, 2)
        qh = qh / torch.tensor(math.sqrt(dh), dtype=qh.dtype, device=qh.device)
        scores = qh @ kh.transpose(-1, -2)  # [B, H, Q, K]
        if mask is not None:
            big_neg = torch.tensor(torch.finfo(scores.dtype).min, dtype=scores.dtype, device=scores.device)
            scores = torch.where(mask, scores, big_neg)
        weights = _softmax(scores)
        if self.dropout and not deterministic:
            weights = F.dropout(weights, self.dropout)
        out = (weights @ vh).transpose(1, 2).reshape(B, Q, E)
        return dense(self.out, out, self.dtype)


class _FFN(nn.Module):
    """Post-attention feedforward: LayerNorm, linear, activation, dropout,
    linear back to the input width (flax's ``LayerNorm_0``, ``Dense_0``,
    ``Dense_1``)."""

    def __init__(
        self, in_features: int, hidden_dim: int, out_dim: int, activation_fn: str, dropout: float, dtype: Any = None
    ) -> None:
        super().__init__()
        self.norm = LayerNorm(in_features, dtype=dtype)
        self.hidden = nn.Linear(in_features, hidden_dim)
        self.output = nn.Linear(hidden_dim, out_dim)
        self.dropout = dropout
        self.dtype = dtype
        self._act = get_activation(activation_fn)

    def jax_leaves(self) -> dict[tuple[str, ...], JaxLeaf]:
        return {
            **prefixed(("LayerNorm_0",), self.norm.jax_leaves()),
            **prefixed(("Dense_0",), dense_leaves(self.hidden)),
            **prefixed(("Dense_1",), dense_leaves(self.output)),
        }

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        x = self._act(dense(self.hidden, self.norm(x), self.dtype))
        if self.dropout and not deterministic:
            x = F.dropout(x, self.dropout)
        return dense(self.output, x, self.dtype)


class _AttentionBlock(nn.Module):
    """Attention, feedforward and skip connection, shared by cross- and
    self-attention. Self-attention normalizes ``q`` and ``kv`` with one
    LayerNorm (``q_norm``); cross-attention has a ``kv_norm`` too."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int = 2,
        hidden_dim: int = 128,
        activation_fn: str = "relu",
        attention_dropout: float = 0.0,
        hidden_dropout: float = 0.0,
        skip_kind: None | str = "cat",
        self_attention: bool = False,
        dtype: Any = None,
    ) -> None:
        super().__init__()
        self.q_norm = LayerNorm(embed_dim, dtype=dtype)
        self.kv_norm = None if self_attention else LayerNorm(embed_dim, dtype=dtype)
        self.attention = _MultiHeadAttention(embed_dim, num_heads, attention_dropout, dtype)
        ffn = _FFN(embed_dim, hidden_dim, embed_dim, activation_fn, hidden_dropout, dtype)
        self.skip_connection = SequentialSkipConnection(embed_dim, kind=skip_kind, layers=[ffn], dtype=dtype)

    def jax_leaves(self) -> dict[tuple[str, ...], JaxLeaf]:
        leaves = prefixed(("q_norm",), self.q_norm.jax_leaves())
        if self.kv_norm is not None:
            leaves.update(prefixed(("kv_norm",), self.kv_norm.jax_leaves()))
        leaves.update(prefixed(("attention",), self.attention.jax_leaves()))
        leaves.update(prefixed(("skip_connection",), self.skip_connection.jax_leaves()))
        return leaves

    def forward(
        self,
        q: torch.Tensor,
        kv: torch.Tensor,
        key_padding_mask: None | torch.Tensor = None,
        attention_mask: None | torch.Tensor = None,
        *,
        deterministic: bool = True,
    ) -> torch.Tensor:
        q_normed = self.q_norm(q)
        kv_normed = q_normed if self.kv_norm is None else self.kv_norm(kv)
        mask = _combine_masks(q.shape[0], q.shape[1], kv.shape[1], key_padding_mask, attention_mask)
        attn = self.attention(q_normed, kv_normed, mask, deterministic)
        return self.skip_connection(q, attn, deterministic=deterministic)


class _BlockModule(nn.Module):
    """A module around one :class:`_AttentionBlock` named ``block``."""

    block: _AttentionBlock

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)

    def jax_leaves(self) -> dict[tuple[str, ...], JaxLeaf]:
        return prefixed(("block",), self.block.jax_leaves())


class CrossAttention(_BlockModule):
    """Multi-head cross-attention mapping keys of length ``K`` to a query
    of length ``Q``.

    Args:
        embed_dim: Key and query feature dimension.
        num_heads: Number of attention heads.
        hidden_dim: Hidden features of the post-attention feedforward.
        activation_fn: Activation function ID.
        attention_dropout: Dropout on the attention weights.
        hidden_dropout: Feedforward dropout.
        skip_kind: Skip connection kind between attention and feedforward.
        dtype: Compute dtype (the parameters stay f32).

    """

    def __init__(
        self,
        embed_dim: int,
        num_heads: int = 2,
        hidden_dim: int = 128,
        activation_fn: str = "relu",
        attention_dropout: float = 0.0,
        hidden_dropout: float = 0.0,
        skip_kind: None | str = "cat",
        dtype: Any = None,
    ) -> None:
        super().__init__()
        self.block = _AttentionBlock(
            embed_dim, num_heads, hidden_dim, activation_fn, attention_dropout, hidden_dropout, skip_kind, False, dtype
        )

    def forward(
        self,
        q: torch.Tensor,
        kv: torch.Tensor,
        key_padding_mask: None | torch.Tensor = None,
        attention_mask: None | torch.Tensor = None,
        *,
        deterministic: bool = True,
    ) -> torch.Tensor:
        """``q [B, Q, E]``, ``kv [B, K, E]`` -> ``[B, Q, E]``."""
        return self.block(q, kv, key_padding_mask, attention_mask, deterministic=deterministic)


class SelfAttention(_BlockModule):
    """Multi-head self-attention over a sequence; the same arguments as
    :class:`CrossAttention`.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.nn import SelfAttention
        >>> layer = SelfAttention(8, num_heads=4, hidden_dim=16, skip_kind="residual")
        >>> layer.reset_parameters(torch.Generator().manual_seed(0))
        >>> padding = torch.tensor([[True, False, False]])
        >>> tuple(layer(torch.randn(1, 3, 8), padding).shape)
        (1, 3, 8)

    """

    def __init__(
        self,
        embed_dim: int,
        num_heads: int = 2,
        hidden_dim: int = 128,
        activation_fn: str = "relu",
        attention_dropout: float = 0.0,
        hidden_dropout: float = 0.0,
        skip_kind: None | str = "cat",
        dtype: Any = None,
    ) -> None:
        super().__init__()
        self.block = _AttentionBlock(
            embed_dim, num_heads, hidden_dim, activation_fn, attention_dropout, hidden_dropout, skip_kind, True, dtype
        )

    def forward(
        self,
        x: torch.Tensor,
        key_padding_mask: None | torch.Tensor = None,
        attention_mask: None | torch.Tensor = None,
        *,
        deterministic: bool = True,
    ) -> torch.Tensor:
        """``x [B, X, E]`` -> ``[B, X, E]``."""
        return self.block(x, x, key_padding_mask, attention_mask, deterministic=deterministic)


class SelfAttentionStack(nn.Module):
    """Stacked self-attention layers.

    Args:
        embed_dim: Feature dimension of every layer.
        num_layers: Number of layers.
        share_parameters: Whether all layers share one set of parameters
            (one :class:`SelfAttention`, ``layers_shared``, applied
            ``num_layers`` times: its gradients sum over the applications,
            and ``parameters()`` holds each tensor once).
        (the rest as in :class:`CrossAttention`)

    """

    def __init__(
        self,
        embed_dim: int,
        num_layers: int = 2,
        num_heads: int = 2,
        hidden_dim: int = 128,
        activation_fn: str = "relu",
        attention_dropout: float = 0.0,
        hidden_dropout: float = 0.0,
        skip_kind: None | str = "cat",
        share_parameters: bool = False,
        dtype: Any = None,
    ) -> None:
        super().__init__()
        self.num_layers = num_layers
        self.share_parameters = share_parameters

        def make() -> SelfAttention:
            return SelfAttention(
                embed_dim, num_heads, hidden_dim, activation_fn, attention_dropout, hidden_dropout, skip_kind, dtype
            )

        if share_parameters:
            self.layers_shared = make()
        else:
            self.layers = nn.ModuleList(make() for _ in range(num_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)

    def jax_leaves(self) -> dict[tuple[str, ...], JaxLeaf]:
        if self.share_parameters:
            return prefixed(("layers_shared",), self.layers_shared.jax_leaves())
        leaves = {}
        for i, layer in enumerate(self.layers):
            leaves.update(prefixed((f"layers_{i}",), layer.jax_leaves()))
        return leaves

    def forward(
        self,
        x: torch.Tensor,
        key_padding_mask: None | torch.Tensor = None,
        attention_mask: None | torch.Tensor = None,
        *,
        deterministic: bool = True,
    ) -> torch.Tensor:
        layers = [self.layers_shared] * self.num_layers if self.share_parameters else self.layers
        for layer in layers:
            x = layer(x, key_padding_mask, attention_mask, deterministic=deterministic)
        return x
