"""Recurrent policy (counterpart of ``rl8_tpu/policies/_recurrent.py``).

Parameters live in the model (an ``nn.Module``), so ``sample`` takes no
params argument; recurrent states are threaded explicitly: ``sample``
takes states of batch shape ``[B, ...]`` and returns updated states of
the same shape alongside outputs of batch shape ``[B * T, ...]``.
Sampling runs without autograd.
"""

from __future__ import annotations

from typing import Any

import torch

from ..data import DataKeys
from ..distributions import Distribution
from ..models import RecurrentModel, RecurrentModelFactory
from ..specs import Composite, Spec
from ._base import GenericPolicyBase

__all__ = ["RecurrentPolicy"]


class RecurrentPolicy(GenericPolicyBase[RecurrentModel]):
    """The union of a recurrent model and an action distribution.

    Args:
        observation_spec: Spec defining environment observations and model
            forward inputs.
        action_spec: Spec defining action distribution outputs and
            environment inputs.
        model: Model instance to use. Mutually exclusive with ``model_cls``.
        model_cls: Model class or factory to use.
        model_config: Model class kwargs.
        distribution_cls: Action distribution class; inferred from
            ``action_spec`` when not provided.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.policies import RecurrentPolicy
        >>> from rl8_tpu_torch.specs import Discrete, Unbounded
        >>> policy = RecurrentPolicy(Unbounded(1), Discrete(2), model_config={"hidden_size": 8})
        >>> policy.init_params(torch.Generator().manual_seed(0))
        >>> out, states = policy.sample({"obs": torch.zeros(3, 5, 1)}, policy.init_states(3), deterministic=True)
        >>> tuple(out["actions"].shape), tuple(states["cell_states"].shape)
        ((15, 1), (3, 1, 8))

    """

    def __init__(
        self,
        observation_spec: Spec,
        action_spec: Spec,
        /,
        *,
        model: None | RecurrentModel = None,
        model_cls: None | RecurrentModelFactory = None,
        model_config: None | dict[str, Any] = None,
        distribution_cls: None | type[Distribution] = None,
    ) -> None:
        self.model_config = model_config or {}
        if model and model_cls:
            raise ValueError(
                "`model` and `model_cls` args are mutually exclusive."
                " Provide one or the other, but not both."
            )
        if model is None:
            model_cls = model_cls or RecurrentModel.default_model_cls(observation_spec, action_spec)
            self.model = model_cls(observation_spec, action_spec, **self.model_config)
        else:
            self.model = model
        self.distribution_cls = distribution_cls or Distribution.default_dist_cls(action_spec)

    @property
    def state_spec(self) -> Composite:
        """Spec defining the recurrent model states."""
        return self.model.state_spec

    def init_states(self, n: int, /, device: Any = None) -> dict[str, torch.Tensor]:
        """Return initial recurrent states for ``n`` parallel environments,
        on ``device`` or by default on the model's own
        (:meth:`RecurrentModel.init_states`)."""
        return self.model.init_states(n, device)

    def init_params(self, generator: torch.Generator, /) -> None:
        """Initialize the model's parameters in place from ``generator``."""
        self.model.reset_parameters(generator)

    @torch.no_grad()
    def sample(
        self,
        batch: Any,
        states: Any,
        /,
        *,
        generator: None | torch.Generator = None,
        deterministic: bool = False,
        return_actions: bool = True,
        return_logp: bool = False,
        return_values: bool = False,
    ) -> tuple[dict[str, Any], Any]:
        """Sample the policy: run the recurrent forward pass and optionally
        draw actions, log-probs and values.

        Args:
            batch: Nested dict with leading ``[B, T, ...]`` dims.
            states: Recurrent states with leading ``[B, ...]`` dims.
            generator: Generator on the model's device; required when
                ``return_actions`` and not ``deterministic``.
            deterministic: Whether to sample deterministically.
            return_actions / return_logp / return_values: Which optional
                outputs to include.

        Returns:
            ``(out, new_states)`` where ``out`` has batch shape ``[B * T,
            ...]`` and ``new_states`` has batch shape ``[B, ...]``.

        """
        (features, values), new_states = self.model(batch, states)
        out: dict[str, Any] = {DataKeys.FEATURES: features}
        if return_actions:
            dist = self.distribution_cls(features, self.model)
            if deterministic:
                actions = dist.deterministic_sample()
            else:
                if generator is None:
                    raise ValueError("A `generator` is required for stochastic sampling.")
                actions = dist.sample(generator)
            out[DataKeys.ACTIONS] = actions
            if return_logp:
                out[DataKeys.LOGP] = dist.logp(actions)
        if return_values:
            out[DataKeys.VALUES] = values
        return out, new_states
