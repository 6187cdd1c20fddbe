"""PPO trainers: abstractions over algorithms and interfaces to experiment
tracking (counterpart of ``rl8_tpu/trainers``)."""

from ._base import GenericTrainerBase
from ._feedforward import Trainer
from ._recurrent import RecurrentTrainer
from .config import TrainConfig
from .tracking import JsonlRun, MlflowRun, NoopRun, Run, set_default_run

__all__ = [
    "GenericTrainerBase",
    "JsonlRun",
    "MlflowRun",
    "NoopRun",
    "RecurrentTrainer",
    "Run",
    "TrainConfig",
    "Trainer",
    "set_default_run",
]
