"""flax's LayerNorm, with its fast variance.

``flax.linen.LayerNorm`` (which ``rl8_tpu``'s ``MLP(layer_norm=True)``
uses) takes the variance as ``E[z^2] - E[z]^2`` clamped at 0, not as
``torch.nn.LayerNorm``'s two-pass ``E[(z - E[z])^2]``; the two differ by
more than the port's tolerances on rows whose mean is large against
their spread. This is flax's formula, with its epsilon of 1e-6 and its
``scale`` and ``bias``, which the fused chain kernels compute too
(``rl8_tpu/ops/fused_mlp.py:276-290``).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["LN_EPS", "LayerNorm", "layer_norm_stats"]

#: flax ``LayerNorm``'s default epsilon.
LN_EPS = 1e-6


def layer_norm_stats(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(xhat, s)`` over the last dim of ``z``: ``s = rsqrt(max(E[z^2] -
    E[z]^2, 0) + eps)`` and ``xhat = (z - E[z]) s``, ``s`` with a kept
    last dim of 1."""
    mu = z.mean(dim=-1, keepdim=True)
    var = (z * z).mean(dim=-1, keepdim=True) - mu * mu
    s = torch.rsqrt(torch.clamp_min(var, 0.0) + LN_EPS)
    return (z - mu) * s, s


class LayerNorm(nn.Module):
    """flax's ``LayerNorm`` over the last dim: ``xhat * scale + bias``
    (``scale`` starts at 1, ``bias`` at 0, as flax initializes them).

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.nn.modules import LayerNorm
        >>> out = LayerNorm(4)(torch.tensor([[1.0, 2.0, 3.0, 4.0]]))
        >>> [round(v, 4) for v in out[0].tolist()]
        [-1.3416, -0.4472, 0.4472, 1.3416]

    """

    def __init__(self, features: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return layer_norm_stats(z)[0] * self.scale + self.bias
