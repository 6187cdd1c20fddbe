"""Carry weights across to and from the JAX package.

:func:`load_jax_params` copies a flax parameter tree of one of
``rl8_tpu``'s models (as nested dicts of numpy arrays, e.g.
``jax.device_get(params)``) into this package's model of the same name;
:func:`to_jax_params` is its inverse. A feedforward model's tree is its
chains (``ops/fused_mlp.py:chain_names``: each torso's ``Dense_i`` and
``LayerNorm_i``, each head) plus the leaves its ``extra_jax_params()``
names (e.g. ``MischievousMule``'s ``invested_embedding/embedding``, or
``AttentiveAlpaca``'s embedding and attention stack), each a
:class:`~rl8_tpu_torch.nn.modules.mlp.JaxLeaf`. A flax ``kernel`` is
``[in, out]``; ``nn.Linear.weight`` is ``[out, in]``, so kernels are
transposed on the way across, and a ``DenseGeneral``'s (attention's
``[E, H, dh]`` and ``[H, dh, E]``) is reshaped too. The recurrent models'
LSTM layers are flax ``OptimizedLSTMCell``s, one kernel per gate (``ii``,
``if``, ``ig``, ``io`` without bias, ``hi``, ``hf``, ``hg``, ``ho`` with
one), which this package holds concatenated in i, f, g, o order; a custom
recurrent model (``LazyLemur``) has them under ``lstm`` beside its chains
and extra leaves.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..nn.modules.mlp import JaxLeaf, dense_leaves, prefixed
from ..ops.fused_mlp import chain_names
from ..ops.fused_rnn_act import rnn_head_names
from ._feedforward import DefaultContinuousModel, DefaultDiscreteModel, Model
from ._recurrent import DefaultContinuousRecurrentModel, DefaultDiscreteRecurrentModel, RecurrentModel

__all__ = ["load_jax_params", "to_jax_params"]

_GATES = ("i", "f", "g", "o")


def _load_lstm(model: RecurrentModel, params: Mapping[str, Any]) -> None:
    lstm = params["lstm"]
    if len(lstm) != model.lstm.num_layers:
        raise ValueError(f"The flax tree has {len(lstm)} LSTM layers but the model has {model.lstm.num_layers}.")
    for l in range(model.lstm.num_layers):
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


def _lstm_tree(model: RecurrentModel) -> dict[str, Any]:
    H, tree = model.lstm.hidden_size, {}
    for l in range(model.lstm.num_layers):
        wi, wh, b = (getattr(model.lstm, name)[l].detach().cpu().numpy() for name in ("wi", "wh", "b"))
        cell: dict[str, Any] = {}
        for k, g in enumerate(_GATES):
            cols = slice(k * H, (k + 1) * H)
            cell[f"i{g}"] = {"kernel": wi[:, cols].copy()}
            cell[f"h{g}"] = {"kernel": wh[:, cols].copy(), "bias": b[cols].copy()}
        tree[f"lstm_{l}"] = cell
    return tree


def _chain_layout(model: Any) -> tuple[tuple[str, tuple[str, ...]], ...]:
    """The model's chains (:func:`chain_names`); none for an ``nn`` module,
    a default recurrent model, or a custom model without a fused apply
    spec."""
    if not isinstance(model, (Model, RecurrentModel)) or _is_default_recurrent(model):
        return ()
    custom = isinstance(model, Model) and not isinstance(model, (DefaultContinuousModel, DefaultDiscreteModel))
    if custom and type(model).fused_apply_spec is Model.fused_apply_spec:
        return ()
    return chain_names(model)


def _is_default_recurrent(model: Any) -> bool:
    return type(model) in (DefaultDiscreteRecurrentModel, DefaultContinuousRecurrentModel)


def _leaves(model: Any) -> dict[tuple[str, ...], JaxLeaf]:
    """Every leaf of ``model``'s flax tree but the LSTM's: its chains'
    torsos (``Dense_i``, ``LayerNorm_i``) and heads, a default recurrent
    model's heads, and a custom model's ``extra_jax_params()``, or an
    ``nn`` module's ``jax_leaves()``."""
    leaves: dict[tuple[str, ...], JaxLeaf] = {}
    heads = rnn_head_names(model) if _is_default_recurrent(model) else ()
    for torso_name, head_names in _chain_layout(model):
        leaves.update(prefixed((torso_name,), getattr(model, torso_name).jax_leaves()))
        heads += tuple(head_names)
    for head_name in heads:
        leaves.update(prefixed((head_name,), dense_leaves(getattr(model, head_name))))
    extra = getattr(model, "extra_jax_params", None) or getattr(model, "jax_leaves", None)
    if extra is not None:
        leaves.update(extra())
    return leaves


def _load_leaf(leaf: JaxLeaf, value: Any, name: str) -> None:
    value = np.asarray(value, dtype=np.float32)
    if value.shape != leaf.shape:
        raise ValueError(f"{name} is {value.shape} in the flax tree, {leaf.shape} here.")
    got = value.reshape(-1, leaf.param.shape[0]).T if leaf.kernel else value.reshape(leaf.param.shape)
    leaf.param.copy_(torch.tensor(np.ascontiguousarray(got)))


def _leaf_value(leaf: JaxLeaf) -> np.ndarray:
    value = leaf.param.detach().cpu().numpy()
    return (value.T if leaf.kernel else value).reshape(leaf.shape).copy()


def load_jax_params(model: Any, params: Mapping[str, Any], /) -> Any:
    """Load a flax param tree into ``model`` (a model, or an ``nn`` module
    with ``jax_leaves()`` such as ``SelfAttentionStack``) in place and
    return it: for the discrete model ``feature_model/Dense_i``,
    ``feature_head``, ``vf_model/Dense_i``, ``vf_head``; for the
    continuous one ``latent_model/Dense_i``, ``action_mean``,
    ``action_log_std``, ``vf_model/Dense_i``, ``vf_head``; for a custom
    model its chains (torsos with ``LayerNorm_i {scale, bias}`` where they
    have them) and its extra leaves, after ``lstm/lstm_l`` for a recurrent
    one; for the default recurrent ones ``lstm/lstm_l`` and the heads
    ``feature_head``, ``vf_head`` or ``action_mean``, ``action_log_std``,
    ``vf_model``. A tree of another shape raises ``ValueError``."""
    with torch.no_grad():
        if isinstance(model, RecurrentModel):
            _load_lstm(model, params)
        for torso_name, _ in _chain_layout(model):
            torso, sub = getattr(model, torso_name), params[torso_name]
            n_dense = sum(key.startswith("Dense_") for key in sub)
            n_norm = sum(key.startswith("LayerNorm_") for key in sub)
            if (n_dense, n_norm) != (len(torso.layers), len(torso.norms)):
                raise ValueError(
                    f"{torso_name} has {n_dense} flax Dense and {n_norm} LayerNorm layers but"
                    f" the model has {len(torso.layers)} and {len(torso.norms)}."
                )
        for path, leaf in _leaves(model).items():
            value: Any = params
            for key in path:
                value = value[key]
            _load_leaf(leaf, value, "/".join(path))
    return model


def to_jax_params(model: Any, /) -> dict[str, Any]:
    """The inverse of :func:`load_jax_params`: ``model``'s parameters as
    the flax tree of the ``rl8_tpu`` model (or ``nn`` module) of the same
    name, nested dicts of f32 numpy arrays (host copies).

    Examples:
        >>> from rl8_tpu_torch.models import DefaultDiscreteModel, to_jax_params
        >>> from rl8_tpu_torch.specs import Discrete, Unbounded
        >>> tree = to_jax_params(DefaultDiscreteModel(Unbounded(3), Discrete(2), hiddens=(8,)))
        >>> sorted(tree), tree["feature_model"]["Dense_0"]["kernel"].shape
        (['feature_head', 'feature_model', 'vf_head', 'vf_model'], (3, 8))

    """
    tree: dict[str, Any] = {}
    if isinstance(model, RecurrentModel):
        tree["lstm"] = _lstm_tree(model)
    for path, leaf in _leaves(model).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _leaf_value(leaf)
    return tree
