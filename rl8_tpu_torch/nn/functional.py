"""Functional NN definitions (counterpart of ``rl8_tpu/nn/functional.py``).

Time-major layout ``[T, B, ...]`` is used for sequence inputs, as in the
rollout buffer.
"""

from __future__ import annotations

import torch

__all__ = ["generalized_advantage_estimate"]


def generalized_advantage_estimate(
    rewards: torch.Tensor,
    values: torch.Tensor,
    /,
    *,
    gae_lambda: float = 0.95,
    gamma: float = 0.95,
    normalize_advantages: bool = True,
    return_returns: bool = True,
    reward_scale: torch.Tensor | float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Compute Generalized Advantage Estimates (and, optionally, returns)
    from rewards and value estimates: a reverse loop over ``T``.

    Args:
        rewards: Time-major rewards ``[T, B, 1]``.
        values: Time-major value estimates ``[T + 1, B, 1]`` (the final
            entry is the bootstrap value).
        gae_lambda: GAE bias/variance trade-off parameter.
        gamma: Discount factor.
        normalize_advantages: Whether to standardize advantages with the
            batch mean and (``ddof=1``) std before returning.
        return_returns: Whether to also return ``advantages + values[:-1]``.
        reward_scale: Scale rewards by ``1 / (reward_scale + 1e-8)``.

    Returns:
        ``(advantages [T, B, 1], returns [T, B, 1] | None)``; the returns
        use the *unnormalized* advantages.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.nn.functional import generalized_advantage_estimate
        >>> adv, ret = generalized_advantage_estimate(
        ...     torch.ones(3, 1, 1), torch.zeros(4, 1, 1), gamma=1.0,
        ...     gae_lambda=1.0, normalize_advantages=False)
        >>> [round(a, 4) for a in adv.flatten().tolist()]
        [3.0, 2.0, 1.0]

    """
    rewards = rewards / (reward_scale + 1e-8)
    deltas = rewards + gamma * values[1:] - values[:-1]
    advantages = torch.empty_like(deltas)
    prev = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        prev = deltas[t] + gamma * gae_lambda * prev
        advantages[t] = prev
    returns = advantages + values[:-1] if return_returns else None
    if normalize_advantages:
        advantages = (advantages - advantages.mean()) / (advantages.std(correction=1) + 1e-8)
    return advantages, returns
