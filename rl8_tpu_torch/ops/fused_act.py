"""Discrete act kernel: model forward + action sampling + logp in one
launch per rollout step.

PyTorch/CUDA counterpart of ``rl8_tpu/ops/fused_act.py``
(``_discrete_act_kernel``); the kernel is ``csrc/act.cu``. The
continuous variant comes with the continuous slice.

:func:`fused_act` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it runs :func:`act_plain`, the same function in
plain PyTorch, which is also what the kernel is held against.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any

import torch

from ._build import check, load
from .distmath import philox_uniform, sample_discrete_actions
from .fused_mlp import ACT_FNS, Chain, default_chains, flatten_chains, forward_chains

__all__ = ["ActParams", "act_plain", "fused_act", "pack_act_params"]

_MAX_LAYERS = 8


@dataclass(frozen=True)
class ActParams:
    """The default discrete model's parameters packed for the act kernel:
    ``flat`` holds both chains in kernel order (see
    :func:`~rl8_tpu_torch.ops.fused_mlp.flatten_chains`)."""

    flat: torch.Tensor
    d_in: int
    hiddens: tuple[int, ...]
    #: ``A * n``: action components times categories.
    n_logits: int
    #: Categories per action component.
    n: int
    activation: str

    @property
    def action_dim(self) -> int:
        return self.n_logits // self.n

    def chains(self) -> tuple[Chain, ...]:
        """``(layers, heads)`` chains as views into :attr:`flat`."""
        off = 0

        def take(rows: int, cols: int) -> tuple[torch.Tensor, torch.Tensor]:
            nonlocal off
            w = self.flat[off : off + rows * cols].view(rows, cols)
            off += rows * cols
            b = self.flat[off : off + cols]
            off += cols
            return w, b

        chains = []
        for n_out in (self.n_logits, 1):
            widths = (self.d_in, *self.hiddens)
            layers = tuple(take(widths[i], widths[i + 1]) for i in range(len(self.hiddens)))
            chains.append((layers, (take(widths[-1], n_out),)))
        return tuple(chains)


def pack_act_params(model: Any) -> ActParams:
    """Pack a ``DefaultDiscreteModel``'s current parameters (a copy, on
    the model's device) for :func:`fused_act`."""
    if model.activation_fn not in ACT_FNS:
        raise ValueError(
            f"The act kernel supports activations {tuple(ACT_FNS)}, not"
            f" {model.activation_fn!r}."
        )
    if len(model.hiddens) > _MAX_LAYERS:
        raise ValueError(f"The act kernel supports at most {_MAX_LAYERS} hidden layers.")
    chains = default_chains(model)
    with torch.no_grad():
        flat = flatten_chains(chains)
    return ActParams(
        flat=flat,
        d_in=model.observation_spec.shape[0],
        hiddens=tuple(int(h) for h in model.hiddens),
        n_logits=model.action_spec.shape[0] * model.action_spec.n,
        n=model.action_spec.n,
        activation=model.activation_fn,
    )


def act_plain(
    params: ActParams,
    obs: torch.Tensor,
    key: tuple[int, int],
    *,
    deterministic: bool,
    noise: None | torch.Tensor = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the act kernel.

    Args:
        params: Packed model parameters.
        obs: f32 observations ``[B, d_in]``.
        key: The step's Philox ``(seed, offset)``; its uniforms are the
            kernel's draws (ignored when deterministic or when ``noise``
            is given).
        deterministic: Take the per-group argmax instead of sampling.
        noise: Optional uniforms ``[B, A * n]`` in ``(0, 1)`` to use in
            place of the Philox draws.

    Returns:
        ``(actions [B, A] int32, logp [B, 1], values [B, 1])``.

    """
    ((logits,), (values,)), _ = forward_chains(obs, params.chains(), params.activation)
    if not deterministic and noise is None:
        noise = philox_uniform(*key, obs.shape[0], params.action_dim, params.n, obs.device)
    actions, logp = sample_discrete_actions(logits, params.n, deterministic, noise)
    return actions, logp, values


def fused_act(
    params: ActParams,
    obs: torch.Tensor,
    key: tuple[int, int],
    *,
    deterministic: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample actions, their log-probs and values for one rollout step.

    CUDA tensors launch ``csrc/act.cu`` (and count one launch in
    ``fused_act.launches``) or raise; CPU tensors run :func:`act_plain`.
    Non-f32 observations are widened to f32 first. Returns
    ``(actions [B, A] int32, logp [B, 1], values [B, 1])``.
    """
    if obs.dtype != torch.float32:
        obs = obs.to(torch.float32)
    if obs.dim() != 2 or obs.shape[1] != params.d_in:
        raise ValueError(f"obs must be [B, {params.d_in}], got {tuple(obs.shape)}.")
    if obs.device != params.flat.device:
        raise ValueError(f"obs is on {obs.device} but the params are on {params.flat.device}.")
    seed, offset = key
    if not (0 <= seed < 2**32 and 0 <= offset < 2**32):
        raise ValueError("The Philox key words must be 32-bit unsigned ints.")
    if obs.device.type == "cpu":
        return act_plain(params, obs, key, deterministic=deterministic)
    if obs.device.type != "cuda":
        raise ValueError(f"No act kernel for device {obs.device}.")
    if not (obs.is_contiguous() and params.flat.is_contiguous()):
        raise ValueError("The act kernel needs contiguous obs and params.")
    B = obs.shape[0]
    actions = torch.empty((B, params.action_dim), dtype=torch.int32, device=obs.device)
    logp = torch.empty((B, 1), dtype=torch.float32, device=obs.device)
    values = torch.empty((B, 1), dtype=torch.float32, device=obs.device)
    hidden = (ctypes.c_int * len(params.hiddens))(*params.hiddens)
    code = load().rl8_discrete_act(
        obs.data_ptr(), params.flat.data_ptr(), actions.data_ptr(), logp.data_ptr(),
        values.data_ptr(), B, params.d_in, len(params.hiddens), hidden,
        params.n_logits, params.n, list(ACT_FNS).index(params.activation),
        seed, offset, int(deterministic),
        obs.device.index or 0, torch.cuda.current_stream(obs.device).cuda_stream,
    )
    check(code, "The discrete act kernel")
    fused_act.launches += 1
    return actions, logp, values


#: Kernel launches so far (CUDA tensors only; the CPU path counts none).
fused_act.launches = 0
