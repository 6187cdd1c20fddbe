"""MischievousMule: MLP over aggregated historical price changes.

PyTorch counterpart of ``examples/algotrading/models/mlp.py``: a view
requirement with ``shift=seq_len`` on a nested observation key provides
windows of historical price changes, which are sum-aggregated at four
intervals into the feature vector; the action mask adds FMIN-clipped
logits. It declares a :class:`~rl8_tpu_torch.ops.fused_mlp.FusedApplySpec`,
so that with ``fused_forward=True`` its two LayerNorm-MLP chains and their
heads run through the chain kernels. ``dtype=torch.bfloat16`` is flax's
compute dtype (the JAX bench's configuration): the assembled input is
cast to it and the module forward computes in it; the chain kernels take
that input upcast to f32 and compute in f32.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.models import GenericModel, lecun_normal_, small_uniform_
from rl8_tpu_torch.nn import MLP, OneHotEmbed, dense, get_activation
from rl8_tpu_torch.ops.fused_mlp import FusedApplySpec
from rl8_tpu_torch.specs import Spec
from rl8_tpu_torch.views import ViewRequirement

from ._common import action_mask_logits

__all__ = ["MischievousMule"]


def _price_features(obs: dict, L: int) -> torch.Tensor:
    """Sum-aggregate the windowed price changes ``[B, L + 1, 1]`` at four
    intervals into ``[B, 4]``: shared by the module forward and the fused
    assembly, so both compute the same feature vector."""
    x_price = obs["LOG_CHANGE(price)"][DataKeys.INPUTS]
    return torch.cat(
        [
            x_price[:, : L // 4].sum(dim=1),
            x_price[:, : L // 2].sum(dim=1),
            x_price[:, -(L // 2) :].sum(dim=1),
            x_price[:, -(L // 4) :].sum(dim=1),
        ],
        dim=-1,
    )


class MischievousMule(GenericModel):
    """A model that aggregates historical price changes at different
    intervals to form a latent vector fed into the feature and value
    chains (twin LayerNorm MLP torsos).

    Args:
        observation_spec: ``AlgoTrading``'s composite observation spec.
        action_spec: ``Discrete(3, shape=(1,))``.
        invested_embed_dim: Embedding size for the invested flag.
        seq_len: Number of historical price changes to aggregate; must be
            divisible by 4 and less than the training horizon.
        hiddens: Hidden layer sizes for the feature and value models.
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
        seq_len: int = 4,
        hiddens: Sequence[int] = (128, 128),
        activation_fn: str = "relu",
        dtype: Any = None,
    ) -> None:
        super().__init__(observation_spec, action_spec)
        if seq_len % 4:
            raise ValueError("`seq_len` must be divisible by 4.")
        self.invested_embed_dim = invested_embed_dim
        self.seq_len = seq_len
        self.hiddens = tuple(hiddens)
        self.activation_fn = activation_fn
        self.dtype = dtype
        d_in = invested_embed_dim + 1 + 4
        self.invested_embedding = OneHotEmbed(2, invested_embed_dim)
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

    def extra_jax_params(self) -> dict[tuple[str, ...], nn.Parameter]:
        """Parameters outside the chains, by their path in the flax tree
        (``models/convert.py`` reads this beside :meth:`fused_apply_spec`'s
        chain names)."""
        return {("invested_embedding", "embedding"): self.invested_embedding.embedding}

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers: lecun-normal Dense kernels and zero biases,
        LayerNorm scale 1 and bias 0, a small-uniform ``feature_head``
        kernel, and the embedding's variance scaling."""
        with torch.no_grad():
            self.invested_embedding.reset_parameters(generator)
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
        """The chains' shared input ``[B, invested_embed_dim + 5]``, in the
        model's compute dtype."""
        x = torch.cat(
            [
                self.invested_embedding(obs["invested"].reshape(-1)),
                obs["LOG_CHANGE(price, position)"].to(torch.float32),
                _price_features(obs, self.seq_len).to(torch.float32),
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
        """The composite-observation assembly (embedding + interval sums)
        and the action masking stay in plain PyTorch; the twin
        LayerNorm-MLP chains and their heads run through the chain
        kernels."""

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
