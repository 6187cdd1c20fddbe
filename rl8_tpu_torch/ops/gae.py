"""GAE kernel: unnormalized advantages and returns in one launch.

PyTorch/CUDA counterpart of ``rl8_tpu/ops/gae.py`` (``_gae_kernel``);
the kernel is ``csrc/gae.cu``. :func:`fused_gae` launches it for CUDA
tensors and raises if it cannot; for CPU tensors it runs
:func:`gae_plain`, the same recurrence in plain PyTorch.
"""

from __future__ import annotations

import torch

from ._build import check, load

__all__ = ["fused_gae", "gae_plain"]


def gae_plain(
    rewards: torch.Tensor,
    values: torch.Tensor,
    reward_scale: torch.Tensor,
    *,
    gamma: float,
    gae_lambda: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the GAE kernel, with the kernel's
    arithmetic: rewards times ``1 / (reward_scale + 1e-8)``.

    Args:
        rewards: Time-major ``[T, B, 1]`` f32 rewards.
        values: Time-major ``[T + 1, B, 1]`` f32 value estimates.
        reward_scale: 0-d f32 tensor.
        gamma / gae_lambda: Discount and GAE parameters.

    Returns:
        ``(advantages [T, B, 1], returns [T, B, 1])``.

    """
    inv_scale = 1.0 / (reward_scale + 1e-8)
    gamma_lambda = gamma * gae_lambda
    adv = torch.empty_like(rewards)
    prev = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] * inv_scale + gamma * values[t + 1] - values[t]
        prev = delta + gamma_lambda * prev
        adv[t] = prev
    return adv, adv + values[:-1]


def fused_gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    reward_scale: torch.Tensor,
    *,
    gamma: float,
    gae_lambda: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compute unnormalized GAE advantages and returns (see
    :func:`gae_plain` for the arguments).

    CUDA tensors launch ``csrc/gae.cu`` (and count one launch in
    ``fused_gae.launches``) or raise; CPU tensors run :func:`gae_plain`.
    The reward scale is read on the device, never fetched to the host.
    """
    if rewards.dim() != 3 or rewards.shape[2] != 1:
        raise ValueError(f"rewards must be [T, B, 1], got {tuple(rewards.shape)}.")
    T, B = rewards.shape[:2]
    if T == 0 or B == 0:
        raise ValueError("rewards must be non-empty.")
    if tuple(values.shape) != (T + 1, B, 1):
        raise ValueError(f"values must be [{T + 1}, {B}, 1], got {tuple(values.shape)}.")
    if reward_scale.dim() != 0:
        raise ValueError("reward_scale must be a 0-d tensor.")
    tensors = (rewards, values, reward_scale)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("The GAE inputs must be float32.")
    if any(t.device != rewards.device for t in tensors):
        raise ValueError("The GAE inputs must be on one device.")
    if rewards.device.type == "cpu":
        return gae_plain(rewards, values, reward_scale, gamma=gamma, gae_lambda=gae_lambda)
    if rewards.device.type != "cuda":
        raise ValueError(f"No GAE kernel for device {rewards.device}.")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("The GAE kernel needs contiguous inputs.")
    adv = torch.empty_like(rewards)
    ret = torch.empty_like(rewards)
    code = load().rl8_gae(
        rewards.data_ptr(), values.data_ptr(), reward_scale.data_ptr(),
        adv.data_ptr(), ret.data_ptr(), T, B, gamma, gamma * gae_lambda,
        rewards.device.index or 0, torch.cuda.current_stream(rewards.device).cuda_stream,
    )
    check(code, "The GAE kernel")
    fused_gae.launches += 1
    return adv, ret


#: Kernel launches so far (CUDA tensors only; the CPU path counts none).
fused_gae.launches = 0
