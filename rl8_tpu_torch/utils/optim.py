"""The update's optimizer: clip by global norm, then Adam, over one flat
f32 parameter vector.

Counterpart of ``optax.chain(optax.clip_by_global_norm(max_grad_norm),
optax.adam(lr, ...))`` wrapped by ``rl8_tpu/utils/optim.py``'s
``flatten_optimizer`` (the JAX default ``flatten_optimizer=True``), with
the learning rate set each step as ``optax.inject_hyperparams`` does.
optax's semantics are written out by hand:

- the clip has no epsilon: ``g * max_norm / ||g||`` unless
  ``||g|| < max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
  the norm and so differs);
- Adam's step count is incremented first, and the moments are bias
  corrected: ``m_hat / (sqrt(v_hat + eps_root) + eps)``.

Every tensor stays on the parameters' device; nothing is read back to
the host, so a caller can gate an update on a device flag
(:func:`adam_step` takes ``apply``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Adam", "AdamState", "adam_step"]


@dataclass(frozen=True)
class Adam:
    """Adam's hyperparameters other than the learning rate (optax's
    ``adam`` defaults)."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0


@dataclass
class AdamState:
    """Adam's moments (flat f32, the parameters' layout) and its step
    count (0-d int32), all on the parameters' device."""

    m: torch.Tensor
    v: torch.Tensor
    count: torch.Tensor

    @classmethod
    def zeros_like(cls, params: torch.Tensor) -> "AdamState":
        return cls(
            m=torch.zeros_like(params),
            v=torch.zeros_like(params),
            count=torch.zeros((), dtype=torch.int32, device=params.device),
        )


def adam_step(
    params: torch.Tensor,
    grads: torch.Tensor,
    state: AdamState,
    *,
    lr: float,
    max_grad_norm: float,
    adam: Adam,
    apply: torch.Tensor | None = None,
) -> tuple[torch.Tensor, AdamState]:
    """One clipped Adam update of the flat ``params``.

    Args:
        params: Flat f32 parameters.
        grads: Their gradient, same shape.
        state: Adam's state before the update.
        lr: This step's learning rate.
        max_grad_norm: Global-norm clip threshold.
        adam: Adam's other hyperparameters.
        apply: Optional 0-d bool device tensor; where it is false the
            parameters and the state come back unchanged (the
            ``lax.cond`` that skips an update after a KL early stop).

    Returns:
        ``(new_params, new_state)``.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.utils.optim import Adam, AdamState, adam_step
        >>> p = torch.zeros(3)
        >>> p, s = adam_step(p, torch.tensor([3.0, -4.0, 0.0]), AdamState.zeros_like(p),
        ...                  lr=0.1, max_grad_norm=1.0, adam=Adam())
        >>> [round(x, 4) for x in p.tolist()], int(s.count)
        ([-0.1, 0.1, 0.0], 1)

    """
    norm = torch.linalg.vector_norm(grads)
    grads = torch.where(norm < max_grad_norm, grads, grads / norm * max_grad_norm)
    count = state.count + 1
    m = (1 - adam.b1) * grads + adam.b1 * state.m
    v = (1 - adam.b2) * grads**2 + adam.b2 * state.v
    steps = count.to(torch.float32)
    m_hat = m / (1 - adam.b1**steps)
    v_hat = v / (1 - adam.b2**steps)
    new_params = params + -lr * (m_hat / (torch.sqrt(v_hat + adam.eps_root) + adam.eps))
    if apply is None:
        return new_params, AdamState(m=m, v=v, count=count)
    return torch.where(apply, new_params, params), AdamState(
        m=torch.where(apply, m, state.m),
        v=torch.where(apply, v, state.v),
        count=torch.where(apply, count, state.count),
    )
