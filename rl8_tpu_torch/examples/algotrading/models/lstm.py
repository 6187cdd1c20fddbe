"""LazyLemur: an LSTM model that keeps its states across horizons.

PyTorch counterpart of ``examples/algotrading/models/lstm.py``: the
invested embedding and the two log changes of each step go through a
stacked LSTM (the default recurrent models' ``_StackedLSTM``), whose
latents feed twin LayerNorm MLP chains; the action mask adds FMIN-clipped
logits. It declares a
:class:`~rl8_tpu_torch.ops.fused_mlp.FusedRecurrentApplySpec`, so that
with ``fused_forward=True`` the chains run through the chain kernels on
the ``[B * T, hidden_size]`` latents, whose ``dx`` carries the gradient
back through time. ``dtype=torch.bfloat16`` is flax's compute dtype; the
new states leave the model as f32.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.models import GenericRecurrentModel, lecun_normal_, small_uniform_
from rl8_tpu_torch.models._recurrent import _lstm_state_spec, _StackedLSTM
from rl8_tpu_torch.nn import MLP, OneHotEmbed, dense, get_activation
from rl8_tpu_torch.nn.modules.mlp import prefixed
from rl8_tpu_torch.ops.fused_mlp import FusedRecurrentApplySpec
from rl8_tpu_torch.specs import Composite, Spec

from ._common import action_mask_logits

__all__ = ["LazyLemur"]


class LazyLemur(GenericRecurrentModel):
    """LSTM over (invested embedding, log price changes) with action
    masking.

    Args:
        observation_spec: ``AlgoTrading``'s composite observation spec.
        action_spec: ``Discrete(3, shape=(1,))``.
        invested_embed_dim: Embedding size for the invested flag.
        hidden_size: LSTM hidden width.
        num_layers: Number of stacked LSTM cells.
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
        hidden_size: int = 64,
        num_layers: int = 1,
        hiddens: Sequence[int] = (64, 64),
        activation_fn: str = "relu",
        dtype: Any = None,
    ) -> None:
        super().__init__(observation_spec, action_spec)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.hiddens = tuple(hiddens)
        self.activation_fn = activation_fn
        self.dtype = dtype
        self.invested_embedding = OneHotEmbed(2, invested_embed_dim)
        self.lstm = _StackedLSTM(invested_embed_dim + 2, hidden_size, num_layers, dtype)
        self.feature_model = MLP(hidden_size, self.hiddens, activation_fn=activation_fn, layer_norm=True, dtype=dtype)
        self.feature_head = nn.Linear(self.hiddens[-1], 3)
        self.vf_model = MLP(hidden_size, self.hiddens, activation_fn=activation_fn, layer_norm=True, dtype=dtype)
        self.vf_head = nn.Linear(self.hiddens[-1], 1)
        self._act = get_activation(activation_fn)

    @property
    def state_spec(self) -> Composite:
        return _lstm_state_spec(self.num_layers, self.hidden_size)

    def extra_jax_params(self) -> dict[tuple[str, ...], Any]:
        """The flax tree's leaves outside the chains and ``lstm``
        (``models/convert.py``)."""
        return prefixed(("invested_embedding",), self.invested_embedding.jax_leaves())

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers: the embedding's variance scaling,
        ``OptimizedLSTMCell``'s, lecun-normal kernels and zero biases,
        LayerNorm scale 1 and bias 0, and a small-uniform ``feature_head``
        kernel."""
        with torch.no_grad():
            self.invested_embedding.reset_parameters(generator)
            self.lstm.reset_parameters(generator)
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

    def _assemble(self, batch: Any, states: Any) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The chains' input ``[B * T, hidden_size]`` (the LSTM latents over
        ``batch [B, T, ...]`` from ``states``) and the new f32 states."""
        obs = batch[DataKeys.OBS]
        B, T = obs["invested"].shape[:2]
        x = torch.cat(
            [
                self.invested_embedding(obs["invested"].reshape(-1)).reshape(B, T, -1),
                obs["LOG_CHANGE(price, position)"].to(torch.float32),
                obs["LOG_CHANGE(price)"].to(torch.float32),
            ],
            dim=-1,
        )
        if self.dtype is not None:
            x = x.to(self.dtype)
        latents, h_n, c_n = self.lstm(x, states[DataKeys.HIDDEN_STATES], states[DataKeys.CELL_STATES])
        new_states = {DataKeys.HIDDEN_STATES: h_n.to(torch.float32), DataKeys.CELL_STATES: c_n.to(torch.float32)}
        return latents.reshape(B * T, -1), new_states

    def forward(self, batch: Any, states: Any) -> tuple[tuple[dict[str, torch.Tensor], torch.Tensor], Any]:
        latents, new_states = self._assemble(batch, states)
        logits = dense(self.feature_head, self._act(self.feature_model(latents)), self.dtype).reshape(-1, 1, 3)
        values = dense(self.vf_head, self._act(self.vf_model(latents)), self.dtype)
        features = {"logits": logits.to(torch.float32) + action_mask_logits(batch[DataKeys.OBS])}
        return (features, values.to(torch.float32)), new_states

    def fused_apply_spec(self) -> FusedRecurrentApplySpec:
        """The embedding and the LSTM stay in plain PyTorch (the states
        thread serially over time); the twin post-LSTM LayerNorm-MLP chains
        and their heads run through the chain kernels."""

        def finalize(batch: Any, outs: Any) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
            (logits,), (values,) = outs
            return {"logits": logits.reshape(-1, 1, 3) + action_mask_logits(batch[DataKeys.OBS])}, values

        return FusedRecurrentApplySpec(
            assemble=self._assemble,
            finalize=finalize,
            chain_names=(
                ("feature_model", ("feature_head",)),
                ("vf_model", ("vf_head",)),
            ),
        )
