"""Recurrent trainer (counterpart of ``rl8_tpu/trainers/_recurrent.py``)."""

from ..algorithms import RecurrentAlgorithm
from ._base import GenericTrainerBase

__all__ = ["RecurrentTrainer"]


class RecurrentTrainer(GenericTrainerBase[RecurrentAlgorithm]):
    """Higher-level training interface for recurrent policies."""
