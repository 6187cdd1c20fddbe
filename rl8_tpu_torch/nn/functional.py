"""Functional NN definitions (counterpart of ``rl8_tpu/nn/functional.py``).

Time-major layout ``[T, B, ...]`` is used for sequence inputs, as in the
rollout buffer. :func:`ppo_losses` is the autodiff-able PPO loss; the
update's main path computes the same losses and their gradients in the
fused kernel (``ops/fused_ppo.py``), and the tests differentiate this one
with ``torch.autograd`` to hold the kernel's hand-derived backward.

The masked ops keep ``rl8_tpu``'s finite masking: a mask enters logits as
``log(mask)`` clipped to f32's finite range, ``masked_max`` fills with
f32's finite minimum, and ``masked_avg`` floors its denominator at 1e-9,
so a fully masked row gives 0 or a uniform result, never NaN. (In bf16
the clip bounds round to infinities, as they do in ``rl8_tpu``.)
"""

from __future__ import annotations

from typing import Any

import torch

from ..data import DataKeys

__all__ = [
    "binary_mask_to_float_mask",
    "float_mask_to_binary_mask",
    "generalized_advantage_estimate",
    "mask_from_lengths",
    "masked_avg",
    "masked_categorical_sample",
    "masked_log_softmax",
    "masked_max",
    "ppo_losses",
    "skip_connection",
]

#: f32's finite extremes: the clip bounds of ``log(mask)`` and the fill of
#: :func:`masked_max`.
FMIN = float(torch.finfo(torch.float32).min)
FMAX = float(torch.finfo(torch.float32).max)


def binary_mask_to_float_mask(mask: torch.Tensor, /) -> torch.Tensor:
    """Convert ``0``/``1`` mask elements to ``-inf``/``0`` (f32)."""
    return torch.where(mask == 0, float("-inf"), 0.0).to(torch.float32)


def float_mask_to_binary_mask(mask: torch.Tensor, /) -> torch.Tensor:
    """Convert ``0``/``-inf`` mask elements to ``True``/``False``."""
    return mask == 0.0


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


def mask_from_lengths(x: torch.Tensor, lengths: torch.Tensor, /) -> torch.Tensor:
    """Sequence mask ``[B, T]`` of ``x [B, T, ...]``, ``True`` where the
    position is below the row's ``lengths [B]``.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.nn import mask_from_lengths
        >>> mask_from_lengths(torch.zeros(2, 3), torch.tensor([1, 3])).tolist()
        [[True, False, False], [True, True, True]]

    """
    T = x.shape[1]
    return torch.arange(T, device=x.device)[None, :] < lengths.to(torch.int32).reshape(-1, 1)


def _broadcast_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    while mask.dim() < x.dim():
        mask = mask[..., None]
    return mask


def _mask_logits(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``x + clip(log(mask), FMIN, FMAX)`` in ``x``'s dtype."""
    log_mask = torch.log(_broadcast_mask(mask, x).to(x.dtype))
    lo, hi = (torch.tensor(v, dtype=x.dtype, device=x.device) for v in (FMIN, FMAX))
    return x + torch.clamp(log_mask, lo, hi)


def masked_avg(
    x: torch.Tensor,
    /,
    *,
    mask: None | torch.Tensor = None,
    dim: int = 1,
    keepdim: bool = False,
) -> torch.Tensor:
    """Masked average of ``x`` along ``dim`` (``mask`` ``True`` = keep);
    a fully masked row averages to 0.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.nn import masked_avg
        >>> x = torch.tensor([[1.0, 2.0, 9.0]])
        >>> masked_avg(x, mask=torch.tensor([[True, True, False]]), dim=1).tolist()
        [1.5]

    """
    if mask is not None:
        mask = _broadcast_mask(mask, x).to(x.dtype)
        denom = torch.clamp_min(mask.sum(dim=dim, keepdim=True), 1e-9)
        avg = (mask * x).sum(dim=dim, keepdim=True) / denom
    else:
        avg = x.mean(dim=dim, keepdim=True)
    return avg if keepdim else avg.squeeze(dim)


def masked_categorical_sample(
    x: torch.Tensor,
    /,
    *,
    generator: None | torch.Generator = None,
    mask: None | torch.Tensor = None,
    dim: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample indices along ``dim`` from the logits ``x`` with the masked
    entries (``mask`` ``False``) excluded; returns the sampled (masked)
    logits and their indices, both with ``dim`` kept. ``generator`` takes
    the place of ``rl8_tpu``'s PRNG key."""
    if mask is not None:
        x = _mask_logits(x, mask)
    moved = x.movedim(dim, -1)
    probs = torch.softmax(moved.to(torch.float32), dim=-1).reshape(-1, moved.shape[-1])
    samples = torch.multinomial(probs, 1, generator=generator).reshape(*moved.shape[:-1], 1).movedim(-1, dim)
    return torch.gather(x, dim, samples), samples


def masked_log_softmax(x: torch.Tensor, /, *, mask: None | torch.Tensor = None, dim: int = -1) -> torch.Tensor:
    """Log-softmax of ``x`` along ``dim`` with the masked entries (``mask``
    ``False``) pushed to f32's finite minimum."""
    if mask is not None:
        x = _mask_logits(x, mask)
    return torch.log_softmax(x, dim=dim)


def masked_max(
    x: torch.Tensor, /, *, mask: None | torch.Tensor = None, dim: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Max of ``x`` along ``dim`` over the entries ``mask`` keeps, and its
    (first) index, both with ``dim`` kept."""
    if mask is not None:
        fill = torch.tensor(FMIN, dtype=x.dtype, device=x.device)
        x = torch.where(_broadcast_mask(mask, x).to(torch.bool), x, fill)
    idx = torch.argmax(x, dim=dim, keepdim=True)
    return torch.gather(x, dim, idx), idx


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


def skip_connection(x: torch.Tensor, y: torch.Tensor, /, *, kind: None | str = "cat", dim: int = -1) -> torch.Tensor:
    """Combine ``x`` and ``y`` by residual sum (``"residual"``),
    concatenation along ``dim`` (``"cat"``), or pass ``y`` through
    (``None``)."""
    match kind:
        case "residual":
            return x + y
        case "cat":
            return torch.cat([x, y], dim=dim)
        case None:
            return y
    raise ValueError(f"No skip connection type for {kind}.")
