"""Feedforward models (counterpart of ``rl8_tpu/models/_feedforward.py``).

``forward(batch) -> (features, values)``. Parameters are initialized as
flax initializes the JAX package's models (lecun-normal kernels, zero
biases, small-uniform policy heads), from an explicit generator.
"""

from __future__ import annotations

import math
from typing import Any, Protocol, Sequence

import torch
from torch import nn

from ..data import DataKeys
from ..nn.modules import MLP, get_activation
from ..specs import Discrete, Spec, Unbounded, assert_1d_spec
from ..utils import set_nested
from ..views import ViewKind, ViewRequirement
from ._base import GenericModelBase

__all__ = [
    "Model",
    "ModelFactory",
    "GenericModel",
    "DefaultContinuousModel",
    "DefaultDiscreteModel",
    "lecun_normal_",
    "small_uniform_",
]

#: Std of the unit normal truncated to [-2, 2]; flax's truncated-normal
#: variance scaling divides by it so the kept draws have unit variance.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default ``Dense`` kernel init for an ``[out, in]`` weight:
    a normal truncated at two stds, variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def small_uniform_(weight: torch.Tensor, generator: torch.Generator, scale: float = 1e-3) -> torch.Tensor:
    """Symmetric small-uniform init used for output heads."""
    return nn.init.uniform_(weight, -scale, scale, generator=generator)


class Model(GenericModelBase):
    """Feedforward policy component that processes environment observations
    into action-distribution features and a value function estimate.

    Subclasses implement ``forward(batch) -> (features, values)`` where
    ``batch`` is the view-requirement-processed input with batch shape
    ``[B, ...]``, ``features`` is a dict of tensors consumed by the
    action distribution, and ``values`` is ``[B, 1]``.
    """

    @property
    def view_requirements(self) -> dict[str | tuple[str, ...], ViewRequirement]:
        """Requirements on how a batch is preprocessed before the forward
        pass. Defaults to passing observations with no shifting."""
        return {DataKeys.OBS: ViewRequirement(shift=0)}

    def apply_view_requirements(self, batch: Any, /, *, kind: ViewKind = "last") -> Any:
        """Apply the model's view requirements to a ``[B, T, ...]`` batch:
        ``"last"`` keeps the latest step, ``"all"`` folds time into batch."""
        out: dict[str, Any] = {}
        for key, view_requirement in self.view_requirements.items():
            match kind:
                case "all":
                    item = view_requirement.apply_all(key, batch)
                case "last":
                    item = view_requirement.apply_last(key, batch)
                case _:
                    raise ValueError(
                        f"Unknown view kind {kind!r}; expected 'last' or 'all'."
                    )
            set_nested(out, key, item)
        return out

    @staticmethod
    def default_model_cls(observation_spec: Spec, action_spec: Spec, /) -> type["Model"]:
        """Return a default model class based on the given specs."""
        if not isinstance(observation_spec, Unbounded):
            raise TypeError(
                f"Observation spec {observation_spec} has no default model support."
            )
        assert_1d_spec(observation_spec)
        assert_1d_spec(action_spec)
        if isinstance(action_spec, Discrete):
            return DefaultDiscreteModel
        if isinstance(action_spec, Unbounded):
            return DefaultContinuousModel
        raise TypeError(f"Action spec {action_spec} has no default model support.")

    def _drop_sizes(self) -> dict[str, int]:
        drop_sizes = {key: vr.drop_size for key, vr in self.view_requirements.items()}
        if not drop_sizes:
            raise RuntimeError(
                f"{self} has empty `view_requirements`. A model must"
                " declare at least one view requirement (the default is"
                " `{DataKeys.OBS: ViewRequirement(shift=0)}`)."
            )
        return drop_sizes

    @property
    def drop_size(self) -> int:
        """The model's drop size."""
        return next(iter(self._drop_sizes().values()))

    def validate_view_requirements(self) -> None:
        """Raise if view requirements imply an ambiguous batch size."""
        drop_sizes = self._drop_sizes()
        if len(set(drop_sizes.values())) > 1:
            raise RuntimeError(
                f"{self} view requirements with drop sizes {drop_sizes} result"
                " in an ambiguous batch size."
            )

    def fused_apply_spec(self) -> Any:
        """Optional fused-kernel decomposition for custom MLP-style models
        (see :class:`rl8_tpu_torch.ops.fused_mlp.FusedApplySpec`).

        Return a ``FusedApplySpec`` to run this model's torso/head chains
        through the chain kernels when ``fused_forward=True`` (input
        assembly and output postprocessing stay in plain PyTorch,
        differentiably). The default ``None`` keeps the module forward.
        """
        return None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialize every parameter from ``generator``."""
        raise NotImplementedError


class ModelFactory(Protocol):
    """Factory protocol describing how to create a model instance."""

    def __call__(self, observation_spec: Spec, action_spec: Spec, /, **config: Any) -> Model:
        ...


class GenericModel(Model):
    """Generic model for constructing models from fixed observation and
    action specs."""


class DefaultContinuousModel(GenericModel):
    """Default model for 1D continuous observations and action spaces:
    twin MLP torsos, small-init mean and log-std heads with the log-std
    bounded by ``tanh``, and a value head.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.models import DefaultContinuousModel
        >>> from rl8_tpu_torch.specs import Unbounded
        >>> model = DefaultContinuousModel(Unbounded(3), Unbounded(2), hiddens=(8,))
        >>> features, values = model({"obs": torch.zeros(5, 3)})
        >>> tuple(features["mean"].shape), tuple(features["log_std"].shape), tuple(values.shape)
        ((5, 2), (5, 2), (5, 1))

    """

    def __init__(
        self,
        observation_spec: Spec,
        action_spec: Spec,
        /,
        *,
        hiddens: Sequence[int] = (256, 256),
        activation_fn: str = "relu",
        bias: bool = True,
    ) -> None:
        super().__init__(observation_spec, action_spec)
        if not isinstance(action_spec, Unbounded):
            raise TypeError(f"{type(self).__name__} needs an Unbounded action spec.")
        self.hiddens = tuple(hiddens)
        self.activation_fn = activation_fn
        self.bias = bias
        d_in = observation_spec.shape[0]
        action_dim = action_spec.shape[0]
        self.latent_model = MLP(d_in, self.hiddens, activation_fn=activation_fn, bias=bias)
        self.action_mean = nn.Linear(self.hiddens[-1], action_dim)
        self.action_log_std = nn.Linear(self.hiddens[-1], action_dim)
        self.vf_model = MLP(d_in, self.hiddens, activation_fn=activation_fn, bias=bias)
        self.vf_head = nn.Linear(self.hiddens[-1], 1)
        self._act = get_activation(activation_fn)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for torso in (self.latent_model, self.vf_model):
                for layer in torso.layers:
                    lecun_normal_(layer.weight, generator)
                    if layer.bias is not None:
                        layer.bias.zero_()
            for head, head_init in (
                (self.action_mean, small_uniform_),
                (self.action_log_std, small_uniform_),
                (self.vf_head, lecun_normal_),
            ):
                head_init(head.weight, generator)
                head.bias.zero_()

    def forward(self, batch: Any) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        obs = batch[DataKeys.OBS]
        if obs.dtype != torch.float32:
            obs = obs.to(torch.float32)
        latents = self._act(self.latent_model(obs))
        features = {
            "mean": self.action_mean(latents),
            "log_std": torch.tanh(self.action_log_std(latents)),
        }
        values = self.vf_head(self._act(self.vf_model(obs)))
        return features, values


class DefaultDiscreteModel(GenericModel):
    """Default model for 1D continuous observations and discrete action
    spaces: twin MLP torsos, a small-init logits head reshaped to
    ``[B, A, n]`` and a value head.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.models import DefaultDiscreteModel
        >>> from rl8_tpu_torch.specs import Discrete, Unbounded
        >>> model = DefaultDiscreteModel(Unbounded(3), Discrete(4, shape=(2,)), hiddens=(8,))
        >>> features, values = model({"obs": torch.zeros(5, 3)})
        >>> tuple(features["logits"].shape), tuple(values.shape)
        ((5, 2, 4), (5, 1))

    """

    def __init__(
        self,
        observation_spec: Spec,
        action_spec: Spec,
        /,
        *,
        hiddens: Sequence[int] = (256, 256),
        activation_fn: str = "relu",
        bias: bool = True,
    ) -> None:
        super().__init__(observation_spec, action_spec)
        if not isinstance(action_spec, Discrete):
            raise TypeError(f"{type(self).__name__} needs a Discrete action spec.")
        self.hiddens = tuple(hiddens)
        self.activation_fn = activation_fn
        self.bias = bias
        d_in = observation_spec.shape[0]
        n_logits = action_spec.shape[0] * action_spec.n
        self.feature_model = MLP(d_in, self.hiddens, activation_fn=activation_fn, bias=bias)
        self.feature_head = nn.Linear(self.hiddens[-1], n_logits)
        self.vf_model = MLP(d_in, self.hiddens, activation_fn=activation_fn, bias=bias)
        self.vf_head = nn.Linear(self.hiddens[-1], 1)
        self._act = get_activation(activation_fn)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for torso, head, head_init in (
                (self.feature_model, self.feature_head, small_uniform_),
                (self.vf_model, self.vf_head, lecun_normal_),
            ):
                for layer in torso.layers:
                    lecun_normal_(layer.weight, generator)
                    if layer.bias is not None:
                        layer.bias.zero_()
                head_init(head.weight, generator)
                head.bias.zero_()

    def forward(self, batch: Any) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        obs = batch[DataKeys.OBS]
        if obs.dtype != torch.float32:
            obs = obs.to(torch.float32)
        A, n = self.action_spec.shape[0], self.action_spec.n
        logits = self.feature_head(self._act(self.feature_model(obs))).reshape(-1, A, n)
        values = self.vf_head(self._act(self.vf_model(obs)))
        return {"logits": logits}, values
