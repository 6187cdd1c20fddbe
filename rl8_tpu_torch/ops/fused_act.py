"""Act kernels: model forward + action sampling + logp in one launch per
rollout step.

PyTorch/CUDA counterpart of ``rl8_tpu/ops/fused_act.py``: the default
discrete model with ``Categorical`` (``_discrete_act_kernel``) and the
default continuous model with ``Normal`` or ``SquashedNormal``
(``_continuous_act_kernel``); both kernels are in ``csrc/act.cu``.

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
from .distmath import philox_normal, philox_uniform, sample_continuous_actions, sample_discrete_actions
from .fused_mlp import ACT_FNS, Chain, default_chains, flatten_chains, forward_chains

__all__ = ["KINDS", "ActParams", "act_plain", "fused_act", "pack_act_params"]

_MAX_LAYERS = 8
#: Distribution kinds the kernels sample and score: ``Categorical``,
#: ``Normal`` and ``SquashedNormal``.
KINDS = ("categorical", "normal", "squashed")


@dataclass(frozen=True)
class ActParams:
    """A default model's parameters packed for the kernels, and what they
    parameterize: ``flat`` holds both chains in kernel order (see
    :func:`~rl8_tpu_torch.ops.fused_mlp.flatten_chains`)."""

    flat: torch.Tensor
    d_in: int
    hiddens: tuple[int, ...]
    #: Action components ``A``.
    action_dim: int
    #: Categories per action component (categorical only; 0 otherwise).
    n: int
    activation: str
    #: One of :data:`KINDS`.
    kind: str = "categorical"

    @property
    def continuous(self) -> bool:
        return self.kind != "categorical"

    @property
    def policy_heads(self) -> tuple[int, ...]:
        """Widths of the policy chain's heads: the ``A * n`` logits, or
        the mean and the pre-tanh log-std, ``A`` each."""
        if self.continuous:
            return (self.action_dim, self.action_dim)
        return (self.action_dim * self.n,)

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
        widths = (self.d_in, *self.hiddens)
        for heads in (self.policy_heads, (1,)):
            layers = tuple(take(widths[i], widths[i + 1]) for i in range(len(self.hiddens)))
            chains.append((layers, tuple(take(widths[-1], n_out) for n_out in heads)))
        return tuple(chains)


def pack_act_params(model: Any, *, squashed: bool = False) -> ActParams:
    """Pack a default model's current parameters (a copy, on the model's
    device) for :func:`fused_act` and the update kernel. The discrete
    model's kind is ``"categorical"``; the continuous model's is
    ``"squashed"`` when ``squashed`` (``SquashedNormal``), else
    ``"normal"``."""
    from ..models import DefaultContinuousModel

    continuous = isinstance(model, DefaultContinuousModel)
    if squashed and not continuous:
        raise ValueError("Only the continuous model's actions can be squashed.")
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
        action_dim=model.action_spec.shape[0],
        n=0 if continuous else model.action_spec.n,
        activation=model.activation_fn,
        kind=("squashed" if squashed else "normal") if continuous else "categorical",
    )


def act_plain(
    params: ActParams,
    obs: torch.Tensor,
    key: tuple[int, int],
    *,
    deterministic: bool,
    noise: None | torch.Tensor = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the act kernels.

    Args:
        params: Packed model parameters.
        obs: f32 observations ``[B, d_in]``.
        key: The step's Philox ``(seed, offset)``; its draws are the
            kernel's (ignored when deterministic or when ``noise`` is
            given).
        deterministic: Take the per-group argmax, or the mean (squashed
            when the kind is), instead of sampling.
        noise: Optional draws to use in place of Philox's: uniforms
            ``[B, A * n]`` in ``(0, 1)`` for the categorical kind,
            standard normals ``[B, A]`` for the continuous kinds.

    Returns:
        ``(actions [B, A], logp [B, 1], values [B, 1])``; actions are int32
        for the categorical kind and f32 otherwise.

    """
    (policy_heads, (values,)), _ = forward_chains(obs, params.chains(), params.activation)
    B, A = obs.shape[0], params.action_dim
    if params.continuous:
        if not deterministic and noise is None:
            noise = philox_normal(*key, B, A, obs.device)
        mean, pre_log_std = policy_heads
        actions, logp = sample_continuous_actions(
            mean, pre_log_std, deterministic, params.kind == "squashed", noise
        )
    else:
        if not deterministic and noise is None:
            noise = philox_uniform(*key, B, A, params.n, obs.device)
        actions, logp = sample_discrete_actions(policy_heads[0], params.n, deterministic, noise)
    return actions, logp, values


def fused_act(
    params: ActParams,
    obs: torch.Tensor,
    key: tuple[int, int],
    *,
    deterministic: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample actions, their log-probs and values for one rollout step.

    CUDA tensors launch the kind's kernel in ``csrc/act.cu`` (and count
    one launch in ``fused_act.launches`` for the categorical kind, in
    ``fused_act.continuous_launches`` for the others) or raise; CPU
    tensors run :func:`act_plain`. The shapes pick each kernel's route: the
    categorical kind takes the wgmma route (64-row blocks, products on the
    tensor cores in 3xTF32) where the observation and every hidden layer
    are at most 256 wide and the parameters are 16-byte aligned; the
    continuous kinds, and the categorical kind that the wgmma route does
    not take, take the tiled route (64-row blocks, weights streamed through
    shared memory, register-tiled f32 products) where every hidden layer is
    at most 256 wide; the streaming route takes wider layers. Non-f32
    observations are widened to f32 first. Returns ``(actions [B, A], logp [B, 1], values [B, 1])``,
    actions int32 for the categorical kind and f32 otherwise.
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
    action_dtype = torch.float32 if params.continuous else torch.int32
    actions = torch.empty((B, params.action_dim), dtype=action_dtype, device=obs.device)
    logp = torch.empty((B, 1), dtype=torch.float32, device=obs.device)
    values = torch.empty((B, 1), dtype=torch.float32, device=obs.device)
    hidden = (ctypes.c_int * len(params.hiddens))(*params.hiddens)
    lib = load()
    ptrs = (obs.data_ptr(), params.flat.data_ptr(), actions.data_ptr(), logp.data_ptr(), values.data_ptr())
    dims = (B, params.d_in, len(params.hiddens), hidden)
    act = list(ACT_FNS).index(params.activation)
    stream = (obs.device.index or 0, torch.cuda.current_stream(obs.device).cuda_stream)
    if params.continuous:
        code = lib.rl8_continuous_act(
            *ptrs, *dims, params.action_dim, act, int(params.kind == "squashed"),
            seed, offset, int(deterministic), *stream,
        )
        check(code, "The continuous act kernel")
        fused_act.continuous_launches += 1
    else:
        code = lib.rl8_discrete_act(
            *ptrs, *dims, params.action_dim * params.n, params.n, act,
            seed, offset, int(deterministic), *stream,
        )
        check(code, "The discrete act kernel")
        fused_act.launches += 1
    return actions, logp, values


#: Kernel launches so far, per kernel (CUDA tensors only; the CPU path
#: counts none): the discrete act kernel's and the continuous one's.
fused_act.launches = 0
fused_act.continuous_launches = 0
