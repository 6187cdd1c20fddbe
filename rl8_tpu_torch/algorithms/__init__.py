"""Algorithms (counterpart of ``rl8_tpu/algorithms``)."""

from ._base import GenericAlgorithmBase
from ._feedforward import Algorithm, AlgorithmConfig

__all__ = ["Algorithm", "AlgorithmConfig", "GenericAlgorithmBase"]
