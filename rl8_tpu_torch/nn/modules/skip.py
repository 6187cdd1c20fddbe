"""Skip connection modules (counterpart of ``rl8_tpu/nn/modules/skip.py``).

As in ``rl8_tpu``, the layers are given up front: for ``kind="cat"`` a
fan-in linear restores the embedding width after each concatenation, and
the flax tree names the fan-ins ``Dense_i`` and each layer after its
class (``_FFN_0``), counted in the order flax creates them.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ..functional import skip_connection
from .mlp import JaxLeaf, dense, dense_leaves, prefixed

__all__ = ["SequentialSkipConnection"]


class SequentialSkipConnection(nn.Module):
    """Sequential skip connection through a series of layers: the two
    seeds ``x`` and ``y`` (both ``embed_dim`` wide) are skip-connected,
    then for each layer the running value goes through a fan-in (for
    ``"cat"``), the layer, and a skip connection with the layer's output;
    a last fan-in closes a ``"cat"`` stack with layers.

    Args:
        embed_dim: Input feature size of both seeds (the output size as
            well, but for ``"cat"`` without layers).
        kind: ``"residual"`` (sum), ``"cat"`` (concatenate + fan-in
            linear), or ``None`` (pass-through).
        layers: Modules mapping ``embed_dim`` to ``embed_dim`` features;
            keyword arguments of :meth:`forward` reach each of them.
        dtype: Compute dtype of the fan-in linears (the parameters stay
            f32).

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.nn import SequentialSkipConnection
        >>> skip = SequentialSkipConnection(4, kind="cat", layers=[torch.nn.Identity()])
        >>> tuple(skip(torch.zeros(2, 4), torch.zeros(2, 4)).shape), len(skip.fan_ins)
        ((2, 4), 2)

    """

    def __init__(
        self, embed_dim: int, kind: None | str = "cat", layers: Sequence[nn.Module] = (), dtype: Any = None
    ) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.kind = kind
        self.dtype = dtype
        self.layers = nn.ModuleList(layers)
        n_fan_ins = len(self.layers) + 1 if kind == "cat" and len(self.layers) else 0
        self.fan_ins = nn.ModuleList(nn.Linear(2 * embed_dim, embed_dim) for _ in range(n_fan_ins))

    def forward(self, x: torch.Tensor, y: torch.Tensor, **layer_kwargs: Any) -> torch.Tensor:
        y = skip_connection(x, y, kind=self.kind)
        for i, layer in enumerate(self.layers):
            if self.kind == "cat":
                y = dense(self.fan_ins[i], y, self.dtype)
            y = skip_connection(y, layer(y, **layer_kwargs), kind=self.kind)
        if self.fan_ins:
            y = dense(self.fan_ins[-1], y, self.dtype)
        return y

    def jax_leaves(self) -> dict[tuple[str, ...], JaxLeaf]:
        """The flax tree's leaves: fan-ins ``Dense_i`` and each layer under
        its class name, numbered per name in creation order."""
        counts: dict[str, int] = {}
        leaves: dict[tuple[str, ...], JaxLeaf] = {}

        def name(cls_name: str) -> str:
            counts[cls_name] = counts.get(cls_name, 0) + 1
            return f"{cls_name}_{counts[cls_name] - 1}"

        for i, layer in enumerate(self.layers):
            if self.fan_ins:
                leaves.update(prefixed((name("Dense"),), dense_leaves(self.fan_ins[i])))
            leaves.update(prefixed((name(type(layer).__name__),), layer.jax_leaves()))
        if self.fan_ins:
            leaves.update(prefixed((name("Dense"),), dense_leaves(self.fan_ins[-1])))
        return leaves
