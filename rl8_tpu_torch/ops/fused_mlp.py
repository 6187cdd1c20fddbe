"""Twin-chain MLP layout and its plain forward.

PyTorch counterpart of the forward part of ``rl8_tpu/ops/fused_mlp.py``
(``_default_chains``, ``_flatten_params``, ``_forward_block``): the ONE
definition of which submodules of the default model the act kernel
reads and in what order. A chain is ``(layers, heads)``, each layer and
head a ``(W [in, out], b [out])`` pair; every layer is followed by the
activation (the MLP's inner activations plus the model's trailing one),
heads are linear.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

__all__ = ["ACT_FNS", "default_chains", "flatten_chains", "forward_chains"]

#: Activations the act kernel implements, by name (its ``act`` code is
#: the position in this dict).
ACT_FNS = {"relu": torch.relu, "tanh": torch.tanh}

Chain = tuple[tuple[tuple[torch.Tensor, torch.Tensor], ...], tuple[tuple[torch.Tensor, torch.Tensor], ...]]

#: Per-model (torso, heads) layout of ``DefaultDiscreteModel``.
_DISCRETE_CHAIN_NAMES = (
    ("feature_model", ("feature_head",)),
    ("vf_model", ("vf_head",)),
)


def _pair(linear: Any) -> tuple[torch.Tensor, torch.Tensor]:
    if linear.bias is None:
        raise ValueError("The act kernel needs biased linear layers.")
    return linear.weight.detach().t(), linear.bias.detach()


def default_chains(model: Any) -> tuple[Chain, ...]:
    """``(layers, heads)`` chains of a ``DefaultDiscreteModel``, with
    weights as ``[in, out]`` views of the ``nn.Linear`` weights."""
    return tuple(
        (
            tuple(_pair(layer) for layer in getattr(model, torso).layers),
            tuple(_pair(getattr(model, head)) for head in heads),
        )
        for torso, heads in _DISCRETE_CHAIN_NAMES
    )


def flatten_chains(chains: Sequence[Chain]) -> torch.Tensor:
    """All weights and biases in kernel order (per chain: each layer's
    ``W [in, out]`` then ``b``, then each head's) as one contiguous f32
    vector."""
    parts = []
    for layers, heads in chains:
        for w, b in (*layers, *heads):
            parts.append(w.reshape(-1))
            parts.append(b.reshape(-1))
    return torch.cat(parts).to(torch.float32).contiguous()


def forward_chains(x: torch.Tensor, chains: Sequence[Chain], activation: str) -> list[list[torch.Tensor]]:
    """Plain forward of every chain on the shared input ``x [N, d]``;
    returns each chain's head outputs."""
    act = ACT_FNS[activation]
    outs = []
    for layers, heads in chains:
        h = x
        for w, b in layers:
            h = act(h @ w + b)
        outs.append([h @ w + b for w, b in heads])
    return outs
