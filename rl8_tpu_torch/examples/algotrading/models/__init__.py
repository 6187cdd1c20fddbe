"""Custom algotrading models (counterpart of
``examples/algotrading/models``). ``AttentiveAlpaca`` and ``LazyLemur``
come in a later slice (ROADMAP Queue 1 #5)."""

from .mlp import MischievousMule

__all__ = ["MischievousMule"]
