"""Models (counterpart of ``rl8_tpu/models``)."""

from ._base import GenericModelBase
from ._feedforward import (
    DefaultContinuousModel,
    DefaultDiscreteModel,
    GenericModel,
    Model,
    ModelFactory,
    lecun_normal_,
    small_uniform_,
)
from ._recurrent import (
    DefaultContinuousRecurrentModel,
    DefaultDiscreteRecurrentModel,
    GenericRecurrentModel,
    RecurrentModel,
    RecurrentModelFactory,
)
from .convert import load_jax_params, to_jax_params

__all__ = [
    "DefaultContinuousModel",
    "DefaultContinuousRecurrentModel",
    "DefaultDiscreteModel",
    "DefaultDiscreteRecurrentModel",
    "GenericModel",
    "GenericModelBase",
    "GenericRecurrentModel",
    "Model",
    "ModelFactory",
    "RecurrentModel",
    "RecurrentModelFactory",
    "lecun_normal_",
    "load_jax_params",
    "small_uniform_",
    "to_jax_params",
]
