"""Multi-layer perceptron.

PyTorch counterpart of ``rl8_tpu/nn/modules/mlp.py`` with the same
layout: an activation after every hidden linear layer except the last,
which is a plain projection, and with ``layer_norm`` flax's LayerNorm
between each of those hidden layers and its activation. ``layers[i]``
holds the flax ``Dense_i`` and ``norms[i]`` the flax ``LayerNorm_i``.

A ``dropout`` acts after each hidden activation only when ``forward``
is called with ``deterministic=False``.

A ``dtype`` is flax's compute dtype (``nn.Dense(dtype=...)``): the
parameters stay f32, and each layer casts its input and parameters to
``dtype`` and returns ``dtype`` (:func:`dense`).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .activations import get_activation
from .normalization import LayerNorm

__all__ = ["MLP", "JaxLeaf", "dense", "dense_leaves", "flax_init_", "lecun_normal_", "prefixed"]

#: Std of the unit normal truncated to [-2, 2]; flax's truncated-normal
#: variance scaling divides by it so the kept draws have unit variance.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default ``Dense`` kernel init for an ``[out, in]`` weight:
    a normal truncated at two stds, variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers on every submodule of ``module``, in
    ``modules()`` order: lecun-normal linear weights (a ``DenseGeneral``'s
    fan-in is its contracted width, the ``in`` of its ``nn.Linear``), zero
    biases, LayerNorm scale 1 and bias 0. Other parameters keep their
    values."""
    from .normalization import LayerNorm

    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, nn.Linear):
                lecun_normal_(sub.weight, generator)
                if sub.bias is not None:
                    sub.bias.zero_()
            elif isinstance(sub, LayerNorm):
                sub.reset_parameters()


class JaxLeaf(NamedTuple):
    """A parameter and the shape of its leaf in ``rl8_tpu``'s flax tree
    (``models/convert.py`` reads these). With ``kernel``, ``param`` is an
    ``nn.Linear`` weight ``[out, in]`` whose flax kernel is its transpose
    reshaped to ``shape`` (a ``Dense`` kernel ``[in, out]``, or a
    ``DenseGeneral`` one such as attention's ``[E, H, dh]``); else the leaf
    is ``param`` reshaped to ``shape``."""

    param: torch.Tensor
    shape: tuple[int, ...]
    kernel: bool = False


def prefixed(prefix: tuple[str, ...], leaves: dict[tuple[str, ...], JaxLeaf]) -> dict[tuple[str, ...], JaxLeaf]:
    """``leaves`` with ``prefix`` before every path."""
    return {(*prefix, *path): leaf for path, leaf in leaves.items()}


def dense_leaves(
    layer: nn.Linear, kernel_shape: None | tuple[int, ...] = None, bias_shape: None | tuple[int, ...] = None
) -> dict[tuple[str, ...], JaxLeaf]:
    """The flax leaves of a ``Dense`` (or, with the shapes, a
    ``DenseGeneral``) held by ``layer``."""
    out_f, in_f = layer.weight.shape
    leaves = {("kernel",): JaxLeaf(layer.weight, kernel_shape or (in_f, out_f), True)}
    if layer.bias is not None:
        leaves[("bias",)] = JaxLeaf(layer.bias, bias_shape or (out_f,))
    return leaves


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


def _dropout(x: torch.Tensor, rate: float, generator: None | torch.Generator) -> torch.Tensor:
    """Inverted dropout at ``rate``: each element is zeroed with
    probability ``rate`` and the survivors are scaled by ``1 / (1 -
    rate)``, as flax's ``nn.Dropout`` does. With a ``generator`` the keep
    mask is ``torch.rand(..., generator=generator) >= rate`` (f32 draws on
    ``x``'s device), so a seeded generator repeats its mask; without one,
    ``F.dropout`` draws from the global stream."""
    if generator is None:
        return F.dropout(x, rate)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


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
        dropout: Dropout rate after each hidden activation, never after
            the last layer (``rl8_tpu/nn/modules/mlp.py:39,52-53``). It
            acts only when :meth:`forward` is called with
            ``deterministic=False``; the default ``0.0`` computes exactly
            what an MLP without dropout does.
        dtype: Compute dtype (flax's ``dtype``; the parameters stay f32):
            each layer computes in it, each LayerNorm's statistics and
            normalization run in f32 and return it (:class:`LayerNorm`).

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.nn import MLP
        >>> mlp, x = MLP(3, (8, 2), dropout=0.5), torch.ones(4, 3)
        >>> draw = lambda: mlp(x, deterministic=False, generator=torch.Generator().manual_seed(0))
        >>> torch.equal(draw(), draw())  # a seeded generator repeats its mask
        True

    """

    def __init__(
        self,
        in_features: int,
        hiddens: Sequence[int],
        *,
        activation_fn: str = "relu",
        layer_norm: bool = False,
        bias: bool = True,
        dropout: float = 0.0,
        dtype: Any = None,
    ) -> None:
        super().__init__()
        widths = [in_features, *hiddens]
        self.layers = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1], bias=bias) for i in range(len(hiddens))
        )
        self.norms = nn.ModuleList(LayerNorm(w, dtype=dtype) for w in hiddens[:-1]) if layer_norm else nn.ModuleList()
        self.activation_fn = activation_fn
        self.dropout = dropout
        self.dtype = dtype
        self._act = get_activation(activation_fn)

    @property
    def layer_norm(self) -> bool:
        return len(self.norms) > 0

    def jax_leaves(self) -> dict[tuple[str, ...], JaxLeaf]:
        """The flax tree's leaves: ``Dense_i`` and ``LayerNorm_i``."""
        leaves: dict[tuple[str, ...], JaxLeaf] = {}
        for i, layer in enumerate(self.layers):
            leaves.update(prefixed((f"Dense_{i}",), dense_leaves(layer)))
        for i, norm in enumerate(self.norms):
            leaves.update(prefixed((f"LayerNorm_{i}",), norm.jax_leaves()))
        return leaves

    def forward(
        self, x: torch.Tensor, *, deterministic: bool = True, generator: None | torch.Generator = None
    ) -> torch.Tensor:
        """``x [..., in_features]`` -> ``[..., hiddens[-1]]``. With
        ``deterministic=False`` and a ``dropout``, each hidden activation
        is dropped out, its mask drawn from ``generator`` when one is
        given (``rl8_tpu``'s ``__call__(x, deterministic=...)``, whose
        mask comes from the ``"dropout"`` RNG stream)."""
        for i, layer in enumerate(self.layers[:-1]):
            x = dense(layer, x, self.dtype)
            if self.layer_norm:
                x = self.norms[i](x)
            x = self._act(x)
            if self.dropout and not deterministic:
                x = _dropout(x, self.dropout, generator)
        return dense(self.layers[-1], x, self.dtype)
