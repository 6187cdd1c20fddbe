"""Activation function registry (the same 18 names as
``rl8_tpu/nn/modules/activations.py``), as plain callables on tensors."""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "get_activation", "squared_relu"]


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU squared, from `Primer <https://arxiv.org/abs/2109.08668>`_."""
    return torch.square(F.relu(x))


def _hard_shrink(x: torch.Tensor, lambd: float = 0.5) -> torch.Tensor:
    return torch.where(x.abs() > lambd, x, torch.zeros_like(x))


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


ACTIVATIONS: dict[str, Callable[..., torch.Tensor]] = {
    "elu": F.elu,
    # The exact erf form, as the JAX registry selects with approximate=False.
    "gelu": F.gelu,
    "hard_shrink": _hard_shrink,
    "hard_sigmoid": F.hardsigmoid,
    "hard_swish": F.hardswish,
    "hard_tanh": F.hardtanh,
    "identity": _identity,
    "leaky_relu": F.leaky_relu,
    "log_sigmoid": F.logsigmoid,
    "log_softmax": functools.partial(F.log_softmax, dim=-1),
    "relu": F.relu,
    "relu6": F.relu6,
    "selu": F.selu,
    "sigmoid": torch.sigmoid,
    "squared_relu": squared_relu,
    "softmax": functools.partial(F.softmax, dim=-1),
    "swish": F.silu,
    "tanh": torch.tanh,
}


def get_activation(name: str, /, **params: Any) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return an activation callable by its ``name``."""
    fn = ACTIVATIONS[name]
    if params:
        return lambda x: fn(x, **params)
    return fn
