"""Functional NN definitions (counterpart of ``rl8_tpu/nn/functional.py``).

Time-major layout ``[T, B, ...]`` is used for sequence inputs, as in the
rollout buffer. :func:`ppo_losses` is the autodiff-able PPO loss; the
update's main path computes the same losses and their gradients in the
fused kernel (``ops/fused_ppo.py``), and the tests differentiate this one
with ``torch.autograd`` to hold the kernel's hand-derived backward.
"""

from __future__ import annotations

from typing import Any

import torch

from ..data import DataKeys

__all__ = ["generalized_advantage_estimate", "ppo_losses"]


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


def _smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber, beta=1) matching ``F.smooth_l1_loss``."""
    diff = torch.abs(pred - target)
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def ppo_losses(
    buffer_batch: dict[str, Any],
    values: torch.Tensor,
    sample_distribution: Any,
    /,
    *,
    clip_param: float = 0.2,
    dual_clip_param: None | float = 5.0,
    entropy_coeff: float | torch.Tensor = 0.0,
    vf_clip_param: float = 1.0,
    vf_coeff: float = 1.0,
) -> dict[str, torch.Tensor]:
    """Proximal Policy Optimization losses: dual-clipped policy loss,
    clamped smooth-L1 value loss, optional entropy bonus, and their total
    ``vf_coeff * vf - policy - entropy_coeff * entropy`` (the semantics of
    ``rl8_tpu.nn.ppo_losses``).

    Args:
        buffer_batch: Mapping with ``"actions"``, ``"advantages"``,
            ``"logp"`` and ``"returns"`` tensors of leading shape ``[B]``.
        values: Current value estimates ``[B, 1]``.
        sample_distribution: Distribution built from the *current* model
            features, used for the policy and entropy losses.
        entropy_coeff: A number or a 0-d tensor. When it is a literal
            number 0 the entropy term is skipped entirely.

    Returns:
        ``{"entropy", "policy", "vf", "total"}`` scalar losses.

    """
    logp = sample_distribution.logp(buffer_batch[DataKeys.ACTIONS])
    p_ratio = torch.exp(logp.reshape(-1) - buffer_batch[DataKeys.LOGP].reshape(-1))
    vf_loss = torch.mean(
        torch.clamp(
            _smooth_l1(values.reshape(-1), buffer_batch[DataKeys.RETURNS].reshape(-1)),
            0.0,
            vf_clip_param,
        )
    )
    advantages = buffer_batch[DataKeys.ADVANTAGES].reshape(-1)
    surr1 = advantages * p_ratio
    surr2 = advantages * torch.clamp(p_ratio, 1 - clip_param, 1 + clip_param)
    if dual_clip_param:
        clip1 = torch.minimum(surr1, surr2)
        clip2 = torch.maximum(clip1, dual_clip_param * advantages)
        policy_loss = torch.mean(torch.where(advantages < 0, clip2, clip1))
    else:
        policy_loss = torch.mean(torch.minimum(surr1, surr2))
    total_loss = vf_coeff * vf_loss - policy_loss
    skip_entropy = isinstance(entropy_coeff, (int, float)) and entropy_coeff == 0
    if not skip_entropy:
        entropy_loss = torch.mean(sample_distribution.entropy())
        total_loss = total_loss - entropy_coeff * entropy_loss
    else:
        entropy_loss = torch.zeros((), device=values.device)
    return {
        "entropy": entropy_loss,
        "policy": policy_loss,
        "vf": vf_loss,
        "total": total_loss,
    }
