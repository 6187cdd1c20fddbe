"""Feedforward trainer (counterpart of ``rl8_tpu/trainers/_feedforward.py``)."""

from ..algorithms import Algorithm
from ._base import GenericTrainerBase

__all__ = ["Trainer"]


class Trainer(GenericTrainerBase[Algorithm]):
    """Higher-level training interface that interops with experiment
    tracking.

    This is the preferred training interface for feedforward
    (non-recurrent) policies.

    Examples:
        >>> from rl8_tpu_torch import AlgorithmConfig, Trainer
        >>> from rl8_tpu_torch.conditions import HitsUpperBound
        >>> from rl8_tpu_torch.env import DiscreteDummyEnv
        >>> trainer = Trainer(
        ...     AlgorithmConfig(num_envs=4, horizon=4, model_config={"hiddens": (8,)}, device="cpu")
        ...     .build(DiscreteDummyEnv)
        ... )
        >>> stats = trainer.run(stop_conditions=[HitsUpperBound("algorithm/steps", 2)])
        >>> stats["algorithm/steps"], stats["env/steps"]
        (2, 32)

    """
