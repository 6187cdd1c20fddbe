"""Feedforward policy (counterpart of ``rl8_tpu/policies/_feedforward.py``).

Parameters live in the model (an ``nn.Module``), so ``sample`` takes no
params argument. Sampling runs without autograd.
"""

from __future__ import annotations

from typing import Any

import torch

from ..data import DataKeys
from ..distributions import Distribution
from ..models import Model, ModelFactory
from ..specs import Spec
from ..views import ViewKind
from ._base import GenericPolicyBase

__all__ = ["Policy"]


class Policy(GenericPolicyBase[Model]):
    """The union of a feedforward model and an action distribution.

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

    """

    def __init__(
        self,
        observation_spec: Spec,
        action_spec: Spec,
        /,
        *,
        model: None | Model = None,
        model_cls: None | ModelFactory = None,
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
            model_cls = model_cls or Model.default_model_cls(observation_spec, action_spec)
            self.model = model_cls(observation_spec, action_spec, **self.model_config)
        else:
            self.model = model
        self.distribution_cls = distribution_cls or Distribution.default_dist_cls(action_spec)

    def init_params(self, generator: torch.Generator, /) -> None:
        """Initialize the model's parameters in place from ``generator``."""
        self.model.reset_parameters(generator)

    @torch.no_grad()
    def sample(
        self,
        batch: Any,
        /,
        *,
        kind: ViewKind = "last",
        generator: None | torch.Generator = None,
        deterministic: bool = False,
        return_actions: bool = True,
        return_logp: bool = False,
        return_values: bool = False,
        return_views: bool = False,
    ) -> dict[str, Any]:
        """Sample the policy: run views + model forward and optionally draw
        actions/log-probs/values.

        Args:
            batch: Nested dict with leading ``[B, T, ...]`` dims. If a
                ``"views"`` key is present it is used directly as the
                preprocessed model input.
            kind: ``"last"`` (sample for latest observations) or ``"all"``
                (sample over the whole horizon, folding time into batch).
            generator: Generator on the model's device; required when
                ``return_actions`` and not ``deterministic``.
            deterministic: Whether to sample deterministically.
            return_actions / return_logp / return_values / return_views:
                Which optional outputs to include.

        Returns:
            Mapping with at least ``"features"``, batch size ``[B * T, ...]``
            (or ``[B, ...]`` for ``kind="last"``).

        """
        if isinstance(batch, dict) and DataKeys.VIEWS in batch:
            in_batch = batch[DataKeys.VIEWS]
        else:
            in_batch = self.model.apply_view_requirements(batch, kind=kind)
        features, values = self.model(in_batch)
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
        if return_views:
            out[DataKeys.VIEWS] = in_batch
        return out
