"""Multi-layer perceptron.

PyTorch counterpart of ``rl8_tpu/nn/modules/mlp.py`` with the same
layout: an activation after every hidden linear layer except the last,
which is a plain projection, and with ``layer_norm`` flax's LayerNorm
between each of those hidden layers and its activation. ``layers[i]``
holds the flax ``Dense_i`` and ``norms[i]`` the flax ``LayerNorm_i``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .activations import get_activation
from .normalization import LayerNorm

__all__ = ["MLP"]


class MLP(nn.Module):
    """Simple multi-layer perceptron.

    Args:
        in_features: Input dimension.
        hiddens: Hidden (and output) layer dimensions.
        activation_fn: Activation following each hidden linear layer but
            the last.
        layer_norm: Whether to apply layer norm after each hidden linear
            layer but the last, before its activation.
        bias: Whether to include biases.

    """

    def __init__(
        self,
        in_features: int,
        hiddens: Sequence[int],
        *,
        activation_fn: str = "relu",
        layer_norm: bool = False,
        bias: bool = True,
    ) -> None:
        super().__init__()
        widths = [in_features, *hiddens]
        self.layers = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1], bias=bias) for i in range(len(hiddens))
        )
        self.norms = nn.ModuleList(LayerNorm(w) for w in hiddens[:-1]) if layer_norm else nn.ModuleList()
        self.activation_fn = activation_fn
        self._act = get_activation(activation_fn)

    @property
    def layer_norm(self) -> bool:
        return len(self.norms) > 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers[:-1]):
            x = layer(x)
            if self.layer_norm:
                x = self.norms[i](x)
            x = self._act(x)
        return self.layers[-1](x)
