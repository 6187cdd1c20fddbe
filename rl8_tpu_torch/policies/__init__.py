"""Policies (counterpart of ``rl8_tpu/policies``)."""

from ._base import GenericPolicyBase
from ._feedforward import Policy

__all__ = ["GenericPolicyBase", "Policy"]
