"""Multi-layer perceptron.

PyTorch counterpart of ``rl8_tpu/nn/modules/mlp.py`` with the same
layout: an activation after every hidden linear layer except the last,
which is a plain projection, and with ``layer_norm`` flax's LayerNorm
between each of those hidden layers and its activation. ``layers[i]``
holds the flax ``Dense_i`` and ``norms[i]`` the flax ``LayerNorm_i``.

A ``dtype`` is flax's compute dtype (``nn.Dense(dtype=...)``): the
parameters stay f32, and each layer casts its input and parameters to
``dtype`` and returns ``dtype`` (:func:`dense`).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from .activations import get_activation
from .normalization import LayerNorm

__all__ = ["MLP", "dense"]


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Any = None) -> torch.Tensor:
    """``layer(x)`` as flax's ``nn.Dense(dtype=dtype)`` computes it: with a
    ``dtype``, the input, the weight and the bias are cast to it, the
    product and the bias add run in it, and the output is ``dtype``;
    ``None`` is ``layer(x)``.

    Examples:
        >>> import torch
        >>> from torch import nn
        >>> from rl8_tpu_torch.nn.modules.mlp import dense
        >>> dense(nn.Linear(3, 2), torch.ones(4, 3), torch.bfloat16).dtype
        torch.bfloat16

    """
    if dtype is None:
        return layer(x)
    y = x.to(dtype) @ layer.weight.to(dtype).t()
    return y if layer.bias is None else y + layer.bias.to(dtype)


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
        dtype: Compute dtype (flax's ``dtype``; the parameters stay f32):
            each layer computes in it, each LayerNorm's statistics and
            normalization run in f32 and return it (:class:`LayerNorm`).

    """

    def __init__(
        self,
        in_features: int,
        hiddens: Sequence[int],
        *,
        activation_fn: str = "relu",
        layer_norm: bool = False,
        bias: bool = True,
        dtype: Any = None,
    ) -> None:
        super().__init__()
        widths = [in_features, *hiddens]
        self.layers = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1], bias=bias) for i in range(len(hiddens))
        )
        self.norms = nn.ModuleList(LayerNorm(w, dtype=dtype) for w in hiddens[:-1]) if layer_norm else nn.ModuleList()
        self.activation_fn = activation_fn
        self.dtype = dtype
        self._act = get_activation(activation_fn)

    @property
    def layer_norm(self) -> bool:
        return len(self.norms) > 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers[:-1]):
            x = dense(layer, x, self.dtype)
            if self.layer_norm:
                x = self.norms[i](x)
            x = self._act(x)
        return dense(self.layers[-1], x, self.dtype)
