"""Policies (counterpart of ``rl8_tpu/policies``)."""

from ._base import GenericPolicyBase
from ._feedforward import Policy
from ._recurrent import RecurrentPolicy

__all__ = ["GenericPolicyBase", "Policy", "RecurrentPolicy"]
