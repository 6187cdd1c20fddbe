"""Multi-layer perceptron.

PyTorch counterpart of ``rl8_tpu/nn/modules/mlp.py`` with the same
layout: an activation after every hidden linear layer except the last,
which is a plain projection. ``layers[i]`` holds the flax ``Dense_i``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .activations import get_activation

__all__ = ["MLP"]


class MLP(nn.Module):
    """Simple multi-layer perceptron.

    Args:
        in_features: Input dimension.
        hiddens: Hidden (and output) layer dimensions.
        activation_fn: Activation following each hidden linear layer but
            the last.
        bias: Whether to include biases.

    """

    def __init__(
        self,
        in_features: int,
        hiddens: Sequence[int],
        *,
        activation_fn: str = "relu",
        bias: bool = True,
    ) -> None:
        super().__init__()
        widths = [in_features, *hiddens]
        self.layers = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1], bias=bias) for i in range(len(hiddens))
        )
        self.activation_fn = activation_fn
        self._act = get_activation(activation_fn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = self._act(layer(x))
        return self.layers[-1](x)
