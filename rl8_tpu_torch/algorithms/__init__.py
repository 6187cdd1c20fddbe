"""Algorithms (counterpart of ``rl8_tpu/algorithms``)."""

from ._base import GenericAlgorithmBase
from ._feedforward import Algorithm, AlgorithmConfig
from ._recurrent import RecurrentAlgorithm, RecurrentAlgorithmConfig

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "GenericAlgorithmBase",
    "RecurrentAlgorithm",
    "RecurrentAlgorithmConfig",
]
