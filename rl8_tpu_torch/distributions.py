"""Action distributions (counterpart of ``rl8_tpu/distributions.py``).

``logp``/``entropy`` reduce over the action-component axis with
``keepdim`` so outputs are ``[B, 1]``. Sampling takes an explicit
``torch.Generator``. ``Normal`` and ``SquashedNormal`` come with the
continuous slice.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import torch

from .ops.distmath import log_softmax_rows
from .specs import Discrete, Spec, assert_1d_spec

__all__ = ["Distribution", "Categorical"]


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
        raise TypeError(
            f"Action spec {action_spec} has no default distribution support"
            " in this port yet (continuous distributions come later)."
        )

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
