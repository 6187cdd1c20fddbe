"""Custom algotrading models (counterpart of
``examples/algotrading/models``)."""

from .lstm import LazyLemur
from .mlp import MischievousMule
from .transformer import AttentiveAlpaca

__all__ = ["AttentiveAlpaca", "LazyLemur", "MischievousMule"]
