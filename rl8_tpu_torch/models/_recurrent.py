"""Recurrent models (counterpart of ``rl8_tpu/models/_recurrent.py``).

``forward(batch [B, T, ...], states [B, ...]) -> ((features [B*T, ...],
values [B*T, 1]), new_states [B, ...])``. The recurrence is a stack of
LSTM cells with flax ``OptimizedLSTMCell``'s math and layout, written
as explicit products on each layer's concatenated input kernel ``Wi
[d_in, 4H]``, hidden kernel ``Wh [H, 4H]`` and bias ``b [4H]``, gates in
flax's i, f, g, o order (the layout both recurrent kernels read; see
``ops/fused_rnn_act.py``). States stay ``[B, K, H]`` for ``K`` layers.
"""

from __future__ import annotations

from typing import Any, Protocol

import torch
from torch import nn

from ..data import DataKeys
from ..ops.fused_rnn_act import lstm_cell
from ..specs import Composite, Discrete, Spec, Unbounded, assert_1d_spec
from ._base import GenericModelBase
from ._feedforward import lecun_normal_, small_uniform_

__all__ = [
    "RecurrentModel",
    "RecurrentModelFactory",
    "GenericRecurrentModel",
    "DefaultContinuousRecurrentModel",
    "DefaultDiscreteRecurrentModel",
]


class RecurrentModel(GenericModelBase):
    """Recurrent policy component processing observations and recurrent
    states into features, a value estimate, and updated states."""

    @property
    def state_spec(self) -> Composite:
        """Spec defining recurrent model states (part of forward IO).
        Must be overridden by subclasses."""
        raise NotImplementedError

    @staticmethod
    def default_model_cls(observation_spec: Spec, action_spec: Spec, /) -> type["RecurrentModel"]:
        """Return a default recurrent model class based on the given specs."""
        if not isinstance(observation_spec, Unbounded):
            raise TypeError(f"Observation spec {observation_spec} has no default model support.")
        assert_1d_spec(observation_spec)
        assert_1d_spec(action_spec)
        if isinstance(action_spec, Discrete):
            return DefaultDiscreteRecurrentModel
        if isinstance(action_spec, Unbounded):
            return DefaultContinuousRecurrentModel
        raise TypeError(f"Action spec {action_spec} has no default model support.")

    def init_states(self, n: int, /, device: Any = None) -> dict[str, torch.Tensor]:
        """Return zeroed initial recurrent states for ``n`` batch elements,
        on ``device``, or by default on the device of the model's first
        parameter (the CPU for a model without parameters), as
        ``rl8_tpu``'s states land beside its parameters."""
        if device is None:
            param = next(self.parameters(), None)
            device = "cpu" if param is None else param.device
        return self.state_spec.zero((n,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialize every parameter from ``generator``."""
        raise NotImplementedError


class RecurrentModelFactory(Protocol):
    """Factory protocol describing how to create a recurrent model."""

    def __call__(self, observation_spec: Spec, action_spec: Spec, /, **config: Any) -> RecurrentModel:
        ...


class GenericRecurrentModel(RecurrentModel):
    """Generic recurrent model with fixed specs."""


class _StackedLSTM(nn.Module):
    """``num_layers`` LSTM cells over a ``[B, T, D]`` sequence with explicit
    ``[B, K, H]`` hidden and cell states; layer ``l``'s parameters are
    ``wi[l] [d_l, 4H]``, ``wh[l] [H, 4H]`` and ``b[l] [4H]``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        widths = [input_size] + [hidden_size] * (num_layers - 1)
        self.wi = nn.ParameterList([nn.Parameter(torch.empty(d, 4 * hidden_size)) for d in widths])
        self.wh = nn.ParameterList(
            [nn.Parameter(torch.empty(hidden_size, 4 * hidden_size)) for _ in range(num_layers)]
        )
        self.b = nn.ParameterList([nn.Parameter(torch.empty(4 * hidden_size)) for _ in range(num_layers)])

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``OptimizedLSTMCell``'s init, per gate: lecun-normal input
        kernels, orthogonal ``[H, H]`` hidden kernels, zero biases."""
        H = self.hidden_size
        with torch.no_grad():
            for wi, wh, b in zip(self.wi, self.wh, self.b):
                for g in range(4):
                    cols = slice(g * H, (g + 1) * H)
                    wi[:, cols] = lecun_normal_(torch.empty(H, wi.shape[0]), generator).t()
                    wh[:, cols] = nn.init.orthogonal_(torch.empty(H, H), generator=generator)
                b.zero_()

    def forward(
        self, x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        hs = [h0[:, l] for l in range(self.num_layers)]
        cs = [c0[:, l] for l in range(self.num_layers)]
        outs = []
        for t in range(x.shape[1]):
            inp = x[:, t]
            for l in range(self.num_layers):
                hs[l], cs[l] = lstm_cell(inp, hs[l], cs[l], self.wi[l], self.wh[l], self.b[l])[:2]
                inp = hs[l]
            outs.append(inp)
        return torch.stack(outs, dim=1), torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def _lstm_state_spec(num_layers: int, hidden_size: int) -> Composite:
    return Composite(
        {
            DataKeys.HIDDEN_STATES: Unbounded((num_layers, hidden_size)),
            DataKeys.CELL_STATES: Unbounded((num_layers, hidden_size)),
        }
    )


class _DefaultRecurrentModel(GenericRecurrentModel):
    """The LSTM torso both default recurrent models share."""

    def __init__(
        self,
        observation_spec: Spec,
        action_spec: Spec,
        /,
        *,
        hidden_size: int = 256,
        num_layers: int = 1,
        bias: bool = True,
    ) -> None:
        super().__init__(observation_spec, action_spec)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bias = bias
        self.lstm = _StackedLSTM(observation_spec.shape[0], hidden_size, num_layers)

    @property
    def state_spec(self) -> Composite:
        return _lstm_state_spec(self.num_layers, self.hidden_size)

    def _torso(self, batch: Any, states: Any) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Flattened ``[B*T, H]`` latents and the new states."""
        if not self.bias:
            raise NotImplementedError(
                "`bias=False` is not supported for the default recurrent"
                " models: flax's LSTM cells have no bias toggle, so the"
                " flag would be silently ignored rather than matching"
                " the reference's `nn.LSTM(bias=False)` architecture."
            )
        obs = batch[DataKeys.OBS]
        if obs.dtype != torch.float32:
            obs = obs.to(torch.float32)
        latents, h_n, c_n = self.lstm(obs, states[DataKeys.HIDDEN_STATES], states[DataKeys.CELL_STATES])
        new_states = {DataKeys.HIDDEN_STATES: h_n, DataKeys.CELL_STATES: c_n}
        return latents.reshape(-1, self.hidden_size), new_states


class DefaultContinuousRecurrentModel(_DefaultRecurrentModel):
    """Default recurrent model for 1D continuous observations and action
    spaces: LSTM torso with small-init mean and log-std heads (the log-std
    bounded by ``tanh``) and a value head.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.models import DefaultContinuousRecurrentModel
        >>> from rl8_tpu_torch.specs import Unbounded
        >>> model = DefaultContinuousRecurrentModel(Unbounded(3), Unbounded(2), hidden_size=8)
        >>> batch, states = {"obs": torch.zeros(5, 4, 3)}, model.init_states(5)
        >>> (features, values), new_states = model(batch, states)
        >>> tuple(features["mean"].shape), tuple(values.shape), tuple(new_states["hidden_states"].shape)
        ((20, 2), (20, 1), (5, 1, 8))

    """

    def __init__(self, observation_spec: Spec, action_spec: Spec, /, **config: Any) -> None:
        super().__init__(observation_spec, action_spec, **config)
        if not isinstance(action_spec, Unbounded):
            raise TypeError(f"{type(self).__name__} needs an Unbounded action spec.")
        action_dim = action_spec.shape[0]
        self.action_mean = nn.Linear(self.hidden_size, action_dim)
        self.action_log_std = nn.Linear(self.hidden_size, action_dim)
        self.vf_model = nn.Linear(self.hidden_size, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.lstm.reset_parameters(generator)
        with torch.no_grad():
            for head, head_init in (
                (self.action_mean, small_uniform_),
                (self.action_log_std, small_uniform_),
                (self.vf_model, lecun_normal_),
            ):
                head_init(head.weight, generator)
                head.bias.zero_()

    def forward(self, batch: Any, states: Any) -> tuple[tuple[dict[str, torch.Tensor], torch.Tensor], Any]:
        latents, new_states = self._torso(batch, states)
        features = {
            "mean": self.action_mean(latents),
            "log_std": torch.tanh(self.action_log_std(latents)),
        }
        return (features, self.vf_model(latents)), new_states


class DefaultDiscreteRecurrentModel(_DefaultRecurrentModel):
    """Default recurrent model for 1D continuous observations and discrete
    action spaces: LSTM torso, a small-init logits head reshaped to
    ``[B*T, A, n]`` and a value head.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.models import DefaultDiscreteRecurrentModel
        >>> from rl8_tpu_torch.specs import Discrete, Unbounded
        >>> model = DefaultDiscreteRecurrentModel(Unbounded(3), Discrete(4, shape=(2,)), hidden_size=8)
        >>> (features, values), _ = model({"obs": torch.zeros(5, 4, 3)}, model.init_states(5))
        >>> tuple(features["logits"].shape), tuple(values.shape)
        ((20, 2, 4), (20, 1))

    """

    def __init__(self, observation_spec: Spec, action_spec: Spec, /, **config: Any) -> None:
        super().__init__(observation_spec, action_spec, **config)
        if not isinstance(action_spec, Discrete):
            raise TypeError(f"{type(self).__name__} needs a Discrete action spec.")
        self.feature_head = nn.Linear(self.hidden_size, action_spec.shape[0] * action_spec.n)
        self.vf_head = nn.Linear(self.hidden_size, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.lstm.reset_parameters(generator)
        with torch.no_grad():
            for head, head_init in ((self.feature_head, small_uniform_), (self.vf_head, lecun_normal_)):
                head_init(head.weight, generator)
                head.bias.zero_()

    def forward(self, batch: Any, states: Any) -> tuple[tuple[dict[str, torch.Tensor], torch.Tensor], Any]:
        latents, new_states = self._torso(batch, states)
        A, n = self.action_spec.shape[0], self.action_spec.n
        logits = self.feature_head(latents).reshape(-1, A, n)
        return ({"logits": logits}, self.vf_head(latents)), new_states
