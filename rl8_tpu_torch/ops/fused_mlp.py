"""Twin-chain MLP layout, its plain forward and its plain backward.

PyTorch counterpart of ``rl8_tpu/ops/fused_mlp.py``'s
``_default_chains``, ``_flatten_params``, ``_forward_block`` and
``_chains_backward`` (without LayerNorm, which the default models do
not have): the ONE definition of which submodules of each default model
the act and update kernels read and in what order. A chain is
``(layers, heads)``, each layer and head a ``(W [in, out], b [out])``
pair; every layer is followed by the activation (the MLP's inner
activations plus the model's trailing one), heads are linear.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

__all__ = [
    "ACT_FNS",
    "chain_names",
    "chains_backward_plain",
    "default_chains",
    "flatten_chains",
    "forward_chains",
    "load_flat_params",
]

#: Activations the kernels implement, by name (their ``act`` code is
#: the position in this dict).
ACT_FNS = {"relu": torch.relu, "tanh": torch.tanh}
#: Each activation's derivative from its *output* (what the backward
#: keeps), as ``fused_mlp._ACT_GRAD_FROM_OUT`` computes it.
_ACT_GRAD_FROM_OUT = {
    "relu": lambda h: (h > 0.0).to(h.dtype),
    "tanh": lambda h: 1.0 - h * h,
}

Chain = tuple[tuple[tuple[torch.Tensor, torch.Tensor], ...], tuple[tuple[torch.Tensor, torch.Tensor], ...]]

#: Per-model (torso, heads) layouts, which are also the flax trees'
#: names (``models/convert.py``). Chain 0 is the policy, chain 1 the value.
_DISCRETE_CHAIN_NAMES = (
    ("feature_model", ("feature_head",)),
    ("vf_model", ("vf_head",)),
)
_CONTINUOUS_CHAIN_NAMES = (
    ("latent_model", ("action_mean", "action_log_std")),
    ("vf_model", ("vf_head",)),
)


def chain_names(model: Any) -> tuple[tuple[str, tuple[str, ...]], ...]:
    """``(torso, heads)`` submodule names of a default model, per chain."""
    from ..models import DefaultContinuousModel, DefaultDiscreteModel

    if isinstance(model, DefaultDiscreteModel):
        return _DISCRETE_CHAIN_NAMES
    if isinstance(model, DefaultContinuousModel):
        return _CONTINUOUS_CHAIN_NAMES
    raise TypeError(f"No chain layout is known for {type(model).__name__}.")


def _pair(linear: Any) -> tuple[torch.Tensor, torch.Tensor]:
    if linear.bias is None:
        raise ValueError("The act kernel needs biased linear layers.")
    return linear.weight.detach().t(), linear.bias.detach()


def _linears(model: Any) -> list[tuple[Any, ...]]:
    """Per chain, the ``nn.Linear`` modules in kernel order."""
    return [
        (*getattr(model, torso).layers, *(getattr(model, head) for head in heads))
        for torso, heads in chain_names(model)
    ]


def default_chains(model: Any) -> tuple[Chain, ...]:
    """``(layers, heads)`` chains of a default model, with weights as
    ``[in, out]`` views of the ``nn.Linear`` weights."""
    return tuple(
        (
            tuple(_pair(layer) for layer in getattr(model, torso).layers),
            tuple(_pair(getattr(model, head)) for head in heads),
        )
        for torso, heads in chain_names(model)
    )


def load_flat_params(model: Any, flat: torch.Tensor) -> None:
    """Write a flat vector in :func:`flatten_chains` order back into a
    default model's ``nn.Linear`` weights and biases, in
    place: the inverse of ``flatten_chains(default_chains(model))``."""
    off = 0
    with torch.no_grad():
        for linears in _linears(model):
            for linear in linears:
                n_out, n_in = linear.weight.shape
                linear.weight.copy_(flat[off : off + n_in * n_out].view(n_in, n_out).t())
                off += n_in * n_out
                linear.bias.copy_(flat[off : off + n_out])
                off += n_out
    if off != flat.numel():
        raise ValueError(f"The flat vector has {flat.numel()} values; the model takes {off}.")


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


def forward_chains(
    x: torch.Tensor, chains: Sequence[Chain], activation: str
) -> tuple[list[list[torch.Tensor]], list[list[torch.Tensor]]]:
    """Plain forward of every chain on the shared input ``x [N, d]``.

    Returns ``(outs, hs)``: each chain's head outputs, and each chain's
    activation stack ``[x, h_1, ..., h_L]`` that
    :func:`chains_backward_plain` reads."""
    act = ACT_FNS[activation]
    outs, all_hs = [], []
    for layers, heads in chains:
        hs = [x]
        for w, b in layers:
            hs.append(act(hs[-1] @ w + b))
        outs.append([hs[-1] @ w + b for w, b in heads])
        all_hs.append(hs)
    return outs, all_hs


def chains_backward_plain(
    chains: Sequence[Chain],
    activation: str,
    hs: Sequence[Sequence[torch.Tensor]],
    douts: Sequence[Sequence[torch.Tensor]],
) -> tuple[Chain, ...]:
    """Plain backward of the chains from their heads' cotangents.

    ``hs`` are the activation stacks from :func:`forward_chains` and
    ``douts[c][j]`` the cotangent of chain ``c``'s head ``j``
    ``[N, d_out]``. Returns the parameter gradients with the structure of
    ``chains`` (so :func:`flatten_chains` lays them out as the kernels
    do): ``dW = h_in^T @ dpre`` and ``db = sum(dpre)`` over rows, where
    ``dpre = dh * act'(h_out)`` is taken from each layer's output. The
    input's cotangent is not formed."""
    act_grad = _ACT_GRAD_FROM_OUT[activation]
    grads = []
    for (layers, heads), h, chain_douts in zip(chains, hs, douts):
        dheads = []
        dh = None
        for (w, _), dout in zip(heads, chain_douts):
            dheads.append((h[-1].t() @ dout, dout.sum(dim=0)))
            contrib = dout @ w.t()
            dh = contrib if dh is None else dh + contrib
        dlayers: list[tuple[torch.Tensor, torch.Tensor]] = []
        for layer in range(len(layers) - 1, -1, -1):
            dpre = dh * act_grad(h[layer + 1])
            dlayers.insert(0, (h[layer].t() @ dpre, dpre.sum(dim=0)))
            if layer > 0:
                dh = dpre @ layers[layer][0].t()
        grads.append((tuple(dlayers), tuple(dheads)))
    return tuple(grads)
