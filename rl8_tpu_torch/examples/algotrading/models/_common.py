"""Shared helpers for the algotrading example models.

A model adds the same action-mask logits in its module forward and in
its fused ``finalize``; keeping the expression in one place keeps the two
paths from diverging.
"""

from __future__ import annotations

import torch

__all__ = ["FMIN", "action_mask_logits"]

#: The most negative f32: masked logits are clipped here rather than set
#: to -inf, since ``0 * -inf`` is NaN in the entropy and its gradient.
FMIN = torch.finfo(torch.float32).min


def action_mask_logits(obs: dict) -> torch.Tensor:
    """``[B, 1, 3]`` additive logits: 0 for valid actions, :data:`FMIN`
    (``log(0)`` clipped, as ``examples/algotrading/models/_common.py``
    computes it) for masked ones."""
    mask = obs["action_mask"] != 0
    return torch.where(mask, 0.0, FMIN).to(torch.float32).reshape(-1, 1, 3)
