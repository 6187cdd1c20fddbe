"""Carry weights across to and from the JAX package.

:func:`load_jax_params` copies a flax parameter tree of one of
``rl8_tpu``'s models (as nested dicts of numpy arrays, e.g.
``jax.device_get(params)``) into this package's model of the same name;
:func:`to_jax_params` is its inverse. A feedforward model's tree is its
chains (``ops/fused_mlp.py:chain_names``: each torso's ``Dense_i`` and
``LayerNorm_i``, each head) plus the leaves its ``extra_jax_params()``
names (e.g. ``MischievousMule``'s ``invested_embedding/embedding``). A flax ``kernel`` is ``[in, out]``;
``nn.Linear.weight`` is ``[out, in]``, so kernels are transposed on the
way across. The recurrent models' LSTM layers are flax
``OptimizedLSTMCell``s, one kernel per gate (``ii``, ``if``, ``ig``, ``io``
without bias, ``hi``, ``hf``, ``hg``, ``ho`` with one), which this package
holds concatenated in i, f, g, o order.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from ..ops.fused_mlp import chain_names
from ..ops.fused_rnn_act import rnn_head_names
from ._feedforward import GenericModel
from ._recurrent import RecurrentModel

__all__ = ["load_jax_params", "to_jax_params"]

_GATES = ("i", "f", "g", "o")


def _copy_dense(layer: nn.Linear, dense: Mapping[str, Any]) -> None:
    kernel = np.asarray(dense["kernel"], dtype=np.float32)
    if kernel.T.shape != tuple(layer.weight.shape):
        raise ValueError(
            f"Kernel of shape {kernel.shape} does not fit a weight of shape"
            f" {tuple(layer.weight.shape)} (transposed)."
        )
    layer.weight.copy_(torch.tensor(kernel.T))
    if layer.bias is not None:
        layer.bias.copy_(torch.tensor(np.asarray(dense["bias"], dtype=np.float32)))


def _load_lstm(model: RecurrentModel, params: Mapping[str, Any]) -> None:
    lstm = params["lstm"]
    if len(lstm) != model.num_layers:
        raise ValueError(f"The flax tree has {len(lstm)} LSTM layers but the model has {model.num_layers}.")
    for l in range(model.num_layers):
        cell = lstm[f"lstm_{l}"]
        for name, got in (
            ("wi", np.concatenate([np.asarray(cell[f"i{g}"]["kernel"], np.float32) for g in _GATES], axis=1)),
            ("wh", np.concatenate([np.asarray(cell[f"h{g}"]["kernel"], np.float32) for g in _GATES], axis=1)),
            ("b", np.concatenate([np.asarray(cell[f"h{g}"]["bias"], np.float32) for g in _GATES])),
        ):
            param = getattr(model.lstm, name)[l]
            if got.shape != tuple(param.shape):
                raise ValueError(f"lstm_{l}'s {name} is {got.shape} in the flax tree, {tuple(param.shape)} here.")
            param.copy_(torch.tensor(got))


def _extra_params(model: Any) -> dict[tuple[str, ...], nn.Parameter]:
    extra = getattr(model, "extra_jax_params", None)
    return extra() if extra is not None else {}


def load_jax_params(model: Any, params: Mapping[str, Any], /) -> Any:
    """Load a flax param tree into ``model`` in place and return it: for
    the discrete model ``feature_model/Dense_i``, ``feature_head``,
    ``vf_model/Dense_i``, ``vf_head``; for the continuous one
    ``latent_model/Dense_i``, ``action_mean``, ``action_log_std``,
    ``vf_model/Dense_i``, ``vf_head``; for a custom feedforward model its
    chains (torsos with ``LayerNorm_i {scale, bias}`` where they have
    them) and its extra leaves; for the recurrent ones ``lstm/lstm_l``
    and the heads ``feature_head``, ``vf_head`` or ``action_mean``,
    ``action_log_std``, ``vf_model``."""
    if isinstance(model, RecurrentModel):
        with torch.no_grad():
            _load_lstm(model, params)
            for head_name in rnn_head_names(model):
                _copy_dense(getattr(model, head_name), params[head_name])
        return model
    layout = chain_names(model)  # the flax tree's top-level keys, per chain
    with torch.no_grad():
        for torso_name, head_names in layout:
            torso = getattr(model, torso_name)
            sub = params[torso_name]
            n_dense = sum(key.startswith("Dense_") for key in sub)
            n_norm = sum(key.startswith("LayerNorm_") for key in sub)
            if (n_dense, n_norm) != (len(torso.layers), len(torso.norms)):
                raise ValueError(
                    f"{torso_name} has {n_dense} flax Dense and {n_norm} LayerNorm layers but"
                    f" the model has {len(torso.layers)} and {len(torso.norms)}."
                )
            for i, layer in enumerate(torso.layers):
                _copy_dense(layer, sub[f"Dense_{i}"])
            for i, norm in enumerate(torso.norms):
                for name in ("scale", "bias"):
                    _copy_leaf(getattr(norm, name), sub[f"LayerNorm_{i}"][name], f"{torso_name}/LayerNorm_{i}/{name}")
            for head_name in head_names:
                _copy_dense(getattr(model, head_name), params[head_name])
        for path, param in _extra_params(model).items():
            leaf: Any = params
            for key in path:
                leaf = leaf[key]
            _copy_leaf(param, leaf, "/".join(path))
    return model


def _copy_leaf(param: torch.Tensor, value: Any, name: str) -> None:
    value = np.asarray(value, dtype=np.float32)
    if value.shape != tuple(param.shape):
        raise ValueError(f"{name} is {value.shape} in the flax tree, {tuple(param.shape)} here.")
    param.copy_(torch.tensor(value))


def _dense(layer: nn.Linear) -> dict[str, np.ndarray]:
    out = {"kernel": layer.weight.detach().t().cpu().numpy().copy()}
    if layer.bias is not None:
        out["bias"] = layer.bias.detach().cpu().numpy().copy()
    return out


def to_jax_params(model: GenericModel | RecurrentModel, /) -> dict[str, Any]:
    """The inverse of :func:`load_jax_params`: ``model``'s parameters as
    the flax tree of the ``rl8_tpu`` model of the same name, nested dicts
    of f32 numpy arrays (host copies).

    Examples:
        >>> from rl8_tpu_torch.models import DefaultDiscreteModel, to_jax_params
        >>> from rl8_tpu_torch.specs import Discrete, Unbounded
        >>> tree = to_jax_params(DefaultDiscreteModel(Unbounded(3), Discrete(2), hiddens=(8,)))
        >>> sorted(tree), tree["feature_model"]["Dense_0"]["kernel"].shape
        (['feature_head', 'feature_model', 'vf_head', 'vf_model'], (3, 8))

    """
    tree: dict[str, Any] = {}
    if isinstance(model, RecurrentModel):
        H = model.hidden_size
        tree["lstm"] = {}
        for l in range(model.num_layers):
            wi, wh, b = (getattr(model.lstm, name)[l].detach().cpu().numpy() for name in ("wi", "wh", "b"))
            cell: dict[str, Any] = {}
            for k, g in enumerate(_GATES):
                cols = slice(k * H, (k + 1) * H)
                cell[f"i{g}"] = {"kernel": wi[:, cols].copy()}
                cell[f"h{g}"] = {"kernel": wh[:, cols].copy(), "bias": b[cols].copy()}
            tree["lstm"][f"lstm_{l}"] = cell
        for head_name in rnn_head_names(model):
            tree[head_name] = _dense(getattr(model, head_name))
        return tree
    for torso_name, head_names in chain_names(model):
        torso = getattr(model, torso_name)
        tree[torso_name] = {f"Dense_{i}": _dense(layer) for i, layer in enumerate(torso.layers)}
        for i, norm in enumerate(torso.norms):
            tree[torso_name][f"LayerNorm_{i}"] = {
                name: getattr(norm, name).detach().cpu().numpy().copy() for name in ("scale", "bias")
            }
        for head_name in head_names:
            tree[head_name] = _dense(getattr(model, head_name))
    for path, param in _extra_params(model).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = param.detach().cpu().numpy().copy()
    return tree
