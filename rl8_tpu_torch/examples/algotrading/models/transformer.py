"""AttentiveAlpaca: self-attention over historical price changes.

PyTorch counterpart of ``examples/algotrading/models/transformer.py``: a
view requirement with ``shift=seq_len`` on the price changes gives a
padded window, which is embedded, run through a self-attention stack with
shared parameters and pooled by a masked average; the invested
embedding, the position's log change and the pooled window form the
11-wide input of twin LayerNorm MLP chains, and the action mask adds
FMIN-clipped logits. It declares a
:class:`~rl8_tpu_torch.ops.fused_mlp.FusedApplySpec`, so that with
``fused_forward=True`` the chains and their heads run through the chain
kernels, whose ``dx`` carries the gradient back into the attention stack.
``dtype=torch.bfloat16`` is flax's compute dtype, as in
``MischievousMule``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.models import GenericModel, lecun_normal_, small_uniform_
from rl8_tpu_torch.nn import MLP, OneHotEmbed, SelfAttentionStack, dense, get_activation, masked_avg
from rl8_tpu_torch.nn.modules.mlp import dense_leaves, prefixed
from rl8_tpu_torch.ops.fused_mlp import FusedApplySpec
from rl8_tpu_torch.specs import Spec
from rl8_tpu_torch.views import ViewRequirement

from ._common import action_mask_logits

__all__ = ["AttentiveAlpaca"]


class AttentiveAlpaca(GenericModel):
    """A model that applies self-attention to historical price changes to
    construct logits for action sampling.

    Args:
        observation_spec: ``AlgoTrading``'s composite observation spec.
        action_spec: ``Discrete(3, shape=(1,))``.
        invested_embed_dim: Embedding size for the invested flag.
        price_embed_dim: Embedding size for price changes.
        seq_len: Historical price changes per attention window (the
            window holds ``seq_len + 1`` of them).
        num_heads: Attention heads per layer.
        num_layers: Self-attention stack depth (parameters shared).
        hiddens: Hidden layer sizes for the feature and value models; the
            first entry also sizes the attention feedforward.
        activation_fn: Activation function ID.
        dtype: Compute dtype (``None``: f32; ``torch.bfloat16`` for AMP);
            the parameters stay f32.

    """

    def __init__(
        self,
        observation_spec: Spec,
        action_spec: Spec,
        /,
        *,
        invested_embed_dim: int = 2,
        price_embed_dim: int = 8,
        seq_len: int = 4,
        num_heads: int = 4,
        num_layers: int = 2,
        hiddens: Sequence[int] = (64, 64),
        activation_fn: str = "relu",
        dtype: Any = None,
    ) -> None:
        super().__init__(observation_spec, action_spec)
        self.seq_len = seq_len
        self.hiddens = tuple(hiddens)
        self.activation_fn = activation_fn
        self.dtype = dtype
        d_in = invested_embed_dim + 1 + price_embed_dim
        self.invested_embedding = OneHotEmbed(2, invested_embed_dim)
        self.price_embedding = nn.Linear(1, price_embed_dim)
        self.price_attention = SelfAttentionStack(
            price_embed_dim,
            num_layers=num_layers,
            num_heads=num_heads,
            hidden_dim=self.hiddens[0],
            activation_fn=activation_fn,
            skip_kind="residual",
            share_parameters=True,
            dtype=dtype,
        )
        self.feature_model = MLP(d_in, self.hiddens, activation_fn=activation_fn, layer_norm=True, dtype=dtype)
        self.feature_head = nn.Linear(self.hiddens[-1], 3)
        self.vf_model = MLP(d_in, self.hiddens, activation_fn=activation_fn, layer_norm=True, dtype=dtype)
        self.vf_head = nn.Linear(self.hiddens[-1], 1)
        self._act = get_activation(activation_fn)

    @property
    def view_requirements(self) -> dict:
        return {
            DataKeys.OBS: ViewRequirement(shift=0),
            (DataKeys.OBS, "LOG_CHANGE(price)"): ViewRequirement(shift=self.seq_len),
        }

    def extra_jax_params(self) -> dict[tuple[str, ...], Any]:
        """The flax tree's leaves outside the chains: the embeddings and the
        attention stack (``models/convert.py``)."""
        return {
            **prefixed(("invested_embedding",), self.invested_embedding.jax_leaves()),
            **prefixed(("price_embedding",), dense_leaves(self.price_embedding)),
            **prefixed(("price_attention",), self.price_attention.jax_leaves()),
        }

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers: the embedding's variance scaling,
        lecun-normal kernels and zero biases, LayerNorm scale 1 and bias 0,
        and a small-uniform ``feature_head`` kernel."""
        with torch.no_grad():
            self.invested_embedding.reset_parameters(generator)
            lecun_normal_(self.price_embedding.weight, generator)
            self.price_embedding.bias.zero_()
            self.price_attention.reset_parameters(generator)
            for torso in (self.feature_model, self.vf_model):
                for layer in torso.layers:
                    lecun_normal_(layer.weight, generator)
                    layer.bias.zero_()
                for norm in torso.norms:
                    norm.reset_parameters()
            small_uniform_(self.feature_head.weight, generator)
            lecun_normal_(self.vf_head.weight, generator)
            self.feature_head.bias.zero_()
            self.vf_head.bias.zero_()

    def _assemble(self, obs: dict) -> torch.Tensor:
        """The chains' shared input ``[B, invested_embed_dim + 1 +
        price_embed_dim]`` in the model's compute dtype: the embedding, the
        shared attention stack over the padded window, and its masked
        average."""
        price = obs["LOG_CHANGE(price)"]
        padding_mask = price[DataKeys.PADDING_MASK]
        x_price = dense(self.price_embedding, price[DataKeys.INPUTS], self.dtype)
        x_price = masked_avg(self.price_attention(x_price, padding_mask), mask=~padding_mask, dim=1)
        x = torch.cat(
            [
                self.invested_embedding(obs["invested"].reshape(-1)),
                obs["LOG_CHANGE(price, position)"].to(torch.float32),
                x_price.to(torch.float32),
            ],
            dim=-1,
        )
        return x if self.dtype is None else x.to(self.dtype)

    def forward(self, batch: Any) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        obs = batch[DataKeys.OBS]
        x = self._assemble(obs)
        logits = dense(self.feature_head, self._act(self.feature_model(x)), self.dtype).reshape(-1, 1, 3)
        values = dense(self.vf_head, self._act(self.vf_model(x)), self.dtype)
        return {"logits": logits.to(torch.float32) + action_mask_logits(obs)}, values.to(torch.float32)

    def fused_apply_spec(self) -> FusedApplySpec:
        """The embedding, the attention stack and the pooling stay in plain
        PyTorch; the twin LayerNorm-MLP chains and their heads run through
        the chain kernels."""

        def finalize(batch: Any, outs: Any) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
            (logits,), (values,) = outs
            return {"logits": logits.reshape(-1, 1, 3) + action_mask_logits(batch[DataKeys.OBS])}, values

        return FusedApplySpec(
            assemble=lambda batch: self._assemble(batch[DataKeys.OBS]),
            finalize=finalize,
            chain_names=(
                ("feature_model", ("feature_head",)),
                ("vf_model", ("vf_head",)),
            ),
        )
