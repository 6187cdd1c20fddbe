"""Action distributions (counterpart of ``rl8_tpu/distributions.py``).

``logp``/``entropy`` reduce over the action-component axis with
``keepdim`` so outputs are ``[B, 1]``. Sampling takes an explicit
``torch.Generator``. Log-probs use the kernels' formulas
(``ops/distmath.py``), so they agree with the act and update kernels to
f32 rounding.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import torch

from .ops.distmath import LOG_2PI, log_softmax_rows, normal_per_dim_logp, squashed_normal_logp
from .specs import Discrete, Spec, Unbounded, assert_1d_spec

__all__ = ["Distribution", "Categorical", "Normal", "SquashedNormal"]


class Distribution(ABC):
    """Policy component defining a probability distribution over a feature
    set from a model.

    Args:
        features: Mapping of feature names to tensors from the model's
            forward pass (e.g. ``{"logits": ...}``).
        model: Model for parameterizing the distribution; optional.

    """

    features: dict[str, torch.Tensor]
    model: Any

    def __init__(self, features: dict[str, torch.Tensor], model: Any = None, /) -> None:
        self.features = features
        self.model = model

    @staticmethod
    def default_dist_cls(action_spec: Spec, /) -> type["Distribution"]:
        """Return a default distribution given an action spec."""
        assert_1d_spec(action_spec)
        if isinstance(action_spec, Discrete):
            return Categorical
        if isinstance(action_spec, Unbounded):
            return Normal
        raise TypeError(f"Action spec {action_spec} has no default distribution support.")

    @abstractmethod
    def deterministic_sample(self) -> Any:
        """Return the distribution's deterministic (mode) sample."""

    @abstractmethod
    def entropy(self) -> torch.Tensor:
        """Compute the distribution's entropy, shape ``[B, 1]``."""

    @abstractmethod
    def logp(self, samples: Any) -> torch.Tensor:
        """Compute the log probability of ``samples``, shape ``[B, 1]``."""

    @abstractmethod
    def sample(self, generator: torch.Generator) -> Any:
        """Draw a random sample using the given generator."""


class Categorical(Distribution):
    """Categorical (discrete) distribution over per-component logits.

    ``features["logits"]`` has shape ``[B, A, n]``: ``A`` independent
    action components, each with ``n`` categories. Samples are ``[B, A]``
    int32.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.distributions import Categorical
        >>> dist = Categorical({"logits": torch.tensor([[[0.0, 9.0, 0.0]]])})
        >>> dist.deterministic_sample().tolist()
        [[1]]
        >>> float(dist.logp(torch.tensor([[1]]))[0, 0]) > -1e-3
        True

    """

    @property
    def _logits(self) -> torch.Tensor:
        return self.features["logits"]

    def deterministic_sample(self) -> torch.Tensor:
        return torch.argmax(self._logits, dim=-1).to(torch.int32)

    def entropy(self) -> torch.Tensor:
        logp = log_softmax_rows(self._logits)
        ent = -(logp.exp() * logp).sum(dim=-1)
        return ent.sum(dim=-1, keepdim=True)

    def logp(self, samples: torch.Tensor) -> torch.Tensor:
        logp = log_softmax_rows(self._logits)
        chosen = torch.gather(logp, -1, samples.to(torch.int64).unsqueeze(-1)).squeeze(-1)
        return chosen.sum(dim=-1, keepdim=True)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        logits = self._logits
        u = torch.rand(
            logits.shape, generator=generator, dtype=logits.dtype, device=logits.device
        ).clamp_min(1e-7)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


class Normal(Distribution):
    """Diagonal normal (gaussian) distribution.

    ``features["mean"]`` and ``features["log_std"]`` have shape ``[B, A]``;
    samples are ``[B, A]`` f32.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.distributions import Normal
        >>> dist = Normal({"mean": torch.zeros(1, 2), "log_std": torch.zeros(1, 2)})
        >>> round(float(dist.logp(torch.zeros(1, 2))[0, 0]), 4)  # -log(2 pi)
        -1.8379

    """

    @property
    def _mean(self) -> torch.Tensor:
        return self.features["mean"]

    @property
    def _log_std(self) -> torch.Tensor:
        return self.features["log_std"]

    def deterministic_sample(self) -> torch.Tensor:
        return self._mean

    def entropy(self) -> torch.Tensor:
        return (0.5 * (1.0 + LOG_2PI) + self._log_std).sum(dim=-1, keepdim=True)

    def logp(self, samples: torch.Tensor) -> torch.Tensor:
        inv_var = torch.exp(-2.0 * self._log_std)
        return normal_per_dim_logp(samples - self._mean, self._log_std, inv_var).sum(dim=-1, keepdim=True)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        mean = self._mean
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
        return mean + torch.exp(self._log_std) * noise


class SquashedNormal(Normal):
    """Normal squashed through ``tanh``, so samples lie in ``[-1, 1]``.

    Its log-prob inverts the squash through an atanh of the samples
    clipped to ``1 - eps`` and clamps each dim's base log-prob to ±100.
    """

    def deterministic_sample(self) -> torch.Tensor:
        return torch.tanh(super().deterministic_sample())

    def entropy(self) -> torch.Tensor:
        raise NotImplementedError(
            f"{self.__class__.__name__} has no closed-form entropy;"
            " train with the entropy coefficient set to `0`."
        )

    def logp(self, samples: torch.Tensor) -> torch.Tensor:
        inv_var = torch.exp(-2.0 * self._log_std)
        return squashed_normal_logp(samples, self._mean, self._log_std, inv_var)[0]

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return torch.tanh(super().sample(generator))
