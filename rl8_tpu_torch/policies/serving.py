"""Inference and serving wrappers for exported policies (counterpart of
``rl8_tpu/policies/serving.py``).

:class:`PolicyModel` and :class:`RecurrentPolicyModel` load a policy
pickled with ``Policy.save`` and serve deterministic samples of
``[B, T, ...]`` NumPy observations as DataFrames. They implement MLflow
pyfunc's ``load_context``/``predict`` protocol duck-typed, and work
without MLflow.

As in ``rl8_tpu``, request batch sizes are bucketed to the next power of
two (at least 8; edge-padded rows, sliced off after), so a server sees
O(log max-batch) distinct shapes, and a predict makes one device-to-host
copy for all of its outputs. ``predict`` builds its DataFrames from
:meth:`PolicyModel._predict_arrays`'s NumPy arrays, importing pandas
only there.
"""

from __future__ import annotations

from os import PathLike
from typing import Any

import numpy as np
import torch

from ..data import DataKeys
from ._feedforward import Policy
from ._recurrent import RecurrentPolicy

__all__ = [
    "PolicyModel",
    "RecurrentPolicyModel",
    "MLflowPolicyModel",
    "MLflowRecurrentPolicyModel",
    "get_batch_size_from_model_input",
]


def get_batch_size_from_model_input(x: Any, /) -> tuple[int, int]:
    """Recursively sniff the ``[B, T]`` batch size from a (possibly
    nested) mapping of NumPy arrays."""
    if isinstance(x, dict):
        for v in x.values():
            return get_batch_size_from_model_input(v)
        raise TypeError("Empty mapping has no batch size.")
    arr = np.asarray(x)
    if arr.ndim < 3:
        raise ValueError("Serving inputs must be batched `[B, T, ...]` arrays (ndim >= 3).")
    return int(arr.shape[0]), int(arr.shape[1])


def _resolve_model_input(context: Any, model_input: Any, cls_name: str) -> tuple[Any, Any]:
    """Disambiguate the two ``predict`` calling conventions (MLflow
    pyfunc's positional ``(context, model_input, params)`` and the
    standalone ``predict(model_input)``) and validate the input."""
    if model_input is None:
        context, model_input = None, context
    if not isinstance(model_input, dict) or DataKeys.OBS not in model_input:
        raise TypeError(
            f"{cls_name}.predict expects a mapping with an"
            f" {DataKeys.OBS!r} key as the model input, passed either as"
            " the single argument (`predict(model_input)`) or in MLflow"
            " pyfunc's positional order"
            " (`predict(context, model_input, params)`); got"
            f" {type(model_input).__name__} instead."
        )
    return context, model_input


def _bucket(n: int, /) -> int:
    """Next power of two >= ``n`` (min 8)."""
    b = 8
    while b < n:
        b *= 2
    return b


def _pad_rows(tree: Any, target: int, /) -> Any:
    """Edge-pad every leaf's leading (batch) dim to ``target`` rows. Edge
    rows (not zeros) stay valid inputs, e.g. for action masks."""
    if isinstance(tree, dict):
        return {k: _pad_rows(v, target) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.shape[0] == target:
        return arr
    return np.pad(arr, [(0, target - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1), mode="edge")


def _fetch(tensors: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """NumPy copies of ``tensors`` in one device-to-host copy: their bytes
    are laid end to end on the device, copied once and split on the host."""
    parts = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors.values()]
    host = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.uint8)
    out: dict[str, np.ndarray] = {}
    offset = 0
    for (key, t), part in zip(tensors.items(), parts):
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[key] = host[offset : offset + part.numel()].view(dtype).reshape(tuple(t.shape)).copy()
        offset += part.numel()
    return out


def _to_dataframe(batch: dict[str, Any], n_rows: int) -> Any:
    """A DataFrame of ``n_rows`` rows from a flat mapping of ``[N, ...]``
    arrays (pandas is imported here only)."""
    import pandas as pd

    df = pd.DataFrame(index=range(n_rows))
    for k, v in batch.items():
        df[k] = np.asarray(v).tolist()
    return df


def _device(policy: Any) -> torch.device:
    return next(policy.model.parameters()).device


class PolicyModel:
    """Serving wrapper for a feedforward policy.

    Args:
        policy: The policy to serve (its model holds the parameters).
        device: Where :meth:`load` and :meth:`load_context` put the
            parameters: the card unless ``"cpu"`` is asked for.

    Examples:
        >>> import numpy as np
        >>> import torch
        >>> from rl8_tpu_torch.policies import Policy
        >>> from rl8_tpu_torch.policies.serving import PolicyModel
        >>> from rl8_tpu_torch.specs import Discrete, Unbounded
        >>> policy = Policy(Unbounded(3), Discrete(2, shape=(1,)), model_config={"hiddens": (8,)})
        >>> policy.init_params(torch.Generator().manual_seed(0))
        >>> arrays = PolicyModel(policy)._predict_arrays({"obs": np.zeros((2, 1, 3), np.float32)})
        >>> sorted(arrays), arrays["actions"].shape  # one row per (batch, time) element
        (['actions', 'logp', 'values'], (2, 1))

        Production paths load an exported policy instead:
        ``PolicyModel.load("policy.pkl")``.

    """

    policy: Policy

    def __init__(self, policy: None | Policy = None, *, device: Any = None) -> None:
        self.device = device
        if policy is not None:
            self.policy = policy

    @classmethod
    def load(cls, path: str | PathLike[str], /, device: Any = None) -> "PolicyModel":
        """Load a policy exported with ``Policy.save`` onto ``device``."""
        return cls(Policy.load(path, device), device=device)

    def load_context(self, context: Any) -> None:
        """MLflow pyfunc hook: load from the ``"policy"`` artifact."""
        self.policy = Policy.load(context.artifacts["policy"], self.device)

    def _predict_arrays(self, model_input: dict[str, Any]) -> dict[str, np.ndarray]:
        """The deterministic sample of ``model_input["obs"]`` (``[B, T,
        ...]``) as NumPy arrays of ``B * (T - drop_size)`` rows: actions,
        log-probs and values."""
        obs = model_input[DataKeys.OBS]
        B, T = get_batch_size_from_model_input(obs)
        obs = self.policy.observation_spec.encode(_pad_rows(obs, _bucket(B)), _device(self.policy))
        out = self.policy.sample(
            {DataKeys.OBS: obs},
            kind="all",
            deterministic=True,
            return_actions=True,
            return_logp=True,
            return_values=True,
        )
        # Sample-dropping views shrink the batch; kind="all" flattens
        # batch-major, so the true batch's rows come first.
        rows = B * (T - self.policy.model.drop_size)
        return _fetch({k: out[k][:rows] for k in (DataKeys.ACTIONS, DataKeys.LOGP, DataKeys.VALUES)})

    def predict(
        self,
        context: Any = None,
        model_input: None | dict[str, Any] = None,
        params: None | dict[str, Any] = None,
    ) -> Any:
        """Deterministically sample the policy for a ``[B, T, ...]`` obs
        batch, returning a DataFrame of ``B * T`` rows (less the model's
        drop size per batch element) of actions, log-probabilities and
        value estimates.

        Callable both ways: MLflow's pyfunc wrapper passes ``(context,
        model_input, params)`` positionally; standalone callers may pass
        the model input alone.
        """
        context, model_input = _resolve_model_input(context, model_input, type(self).__name__)
        arrays = self._predict_arrays(model_input)
        return _to_dataframe(arrays, len(arrays[DataKeys.ACTIONS]))


class RecurrentPolicyModel:
    """Serving wrapper for a recurrent policy; ``predict`` also takes and
    returns recurrent states.

    Args:
        policy: The policy to serve (its model holds the parameters).
        device: Where :meth:`load` and :meth:`load_context` put the
            parameters: the card unless ``"cpu"`` is asked for.

    """

    policy: RecurrentPolicy

    def __init__(self, policy: None | RecurrentPolicy = None, *, device: Any = None) -> None:
        self.device = device
        if policy is not None:
            self.policy = policy

    @classmethod
    def load(cls, path: str | PathLike[str], /, device: Any = None) -> "RecurrentPolicyModel":
        """Load a policy exported with ``RecurrentPolicy.save`` onto ``device``."""
        return cls(RecurrentPolicy.load(path, device), device=device)

    def load_context(self, context: Any) -> None:
        """MLflow pyfunc hook: load from the ``"policy"`` artifact."""
        self.policy = RecurrentPolicy.load(context.artifacts["policy"], self.device)

    def _predict_arrays(self, model_input: dict[str, Any]) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
        """The deterministic sample of ``model_input["obs"]`` (``[B, T,
        ...]``) from ``model_input["states"]`` (``[B, ...]``; the initial
        states when absent) as NumPy arrays: ``(outputs, new_states)``,
        ``B * T`` and ``B`` rows."""
        obs = model_input[DataKeys.OBS]
        B, T = get_batch_size_from_model_input(obs)
        B_pad = _bucket(B)
        dev = _device(self.policy)
        obs = self.policy.observation_spec.encode(_pad_rows(obs, B_pad), dev)
        if DataKeys.STATES in model_input:
            states = self.policy.state_spec.encode(_pad_rows(model_input[DataKeys.STATES], B_pad), dev)
        else:
            states = self.policy.init_states(B_pad, dev)
        out, new_states = self.policy.sample(
            {DataKeys.OBS: obs},
            states,
            deterministic=True,
            return_actions=True,
            return_logp=True,
            return_values=True,
        )
        # One copy for outputs and states: the batch-major rows of the
        # true batch come first.
        fetched = _fetch(
            {
                **{k: out[k][: B * T] for k in (DataKeys.ACTIONS, DataKeys.LOGP, DataKeys.VALUES)},
                **{f"{DataKeys.STATES}/{k}": v[:B] for k, v in new_states.items()},
            }
        )
        prefix = f"{DataKeys.STATES}/"
        outputs = {k: v for k, v in fetched.items() if not k.startswith(prefix)}
        return outputs, {k[len(prefix) :]: v for k, v in fetched.items() if k.startswith(prefix)}

    def predict(
        self,
        context: Any = None,
        model_input: None | dict[str, Any] = None,
        params: None | dict[str, Any] = None,
    ) -> tuple[Any, Any]:
        """Deterministically sample for a ``[B, T, ...]`` obs batch (and
        optional ``"states"``), returning ``(outputs_df, states_df)``.

        Accepts MLflow's positional ``(context, model_input, params)``
        order or a standalone single-argument model input.
        """
        context, model_input = _resolve_model_input(context, model_input, type(self).__name__)
        outputs, states = self._predict_arrays(model_input)
        B = len(next(iter(states.values())))
        return _to_dataframe(outputs, len(outputs[DataKeys.ACTIONS])), _to_dataframe(states, B)


#: ``rl8_tpu``'s aliases under the MLflow names
#: (``rl8_tpu/policies/serving.py:341-342``).
MLflowPolicyModel = PolicyModel
MLflowRecurrentPolicyModel = RecurrentPolicyModel
