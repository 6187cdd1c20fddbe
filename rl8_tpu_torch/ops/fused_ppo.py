"""PPO update kernel: the losses and every parameter gradient of one
packed minibatch in one call.

PyTorch/CUDA counterpart of ``rl8_tpu/ops/fused_ppo.py``: the default
discrete model with ``Categorical`` (``_discrete_kernel``) and the default
continuous model with ``Normal`` or, without an entropy bonus,
``SquashedNormal`` (``_continuous_kernel``). Both are ``csrc/ppo.cu``,
one row pass per distribution over shared weight products.

:func:`fused_ppo_grads` launches the kernel for CUDA tensors and raises
if it cannot; for CPU tensors it runs :func:`ppo_grads_plain`, the
kernel's arithmetic in plain PyTorch (forward, the distribution's
log-prob and entropy, :func:`_policy_grad_terms`, :func:`_vf_grad_terms`,
the head cotangents and
:func:`~rl8_tpu_torch.ops.fused_mlp.chains_backward_plain`), which is
also what the kernel is held against.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any

import torch

from ..data import DataKeys
from ._build import check, load
from .distmath import LOG_2PI, log_softmax_rows, normal_per_dim_logp, squashed_normal_logp
from .fused_act import KINDS, ActParams
from .fused_mlp import ACT_FNS, chains_backward_plain, flatten_chains, forward_chains, supports_fused_apply
from .packing import RowUnpacker

__all__ = [
    "PPOLossConfig",
    "PackedColumns",
    "card_takes_update",
    "fused_ppo_grads",
    "ppo_grads_plain",
    "supports_distribution",
    "supports_fused_update",
]


@dataclass(frozen=True)
class PPOLossConfig:
    """Static PPO loss hyperparameters (the subset of ``AlgorithmHparams``
    the loss reads)."""

    clip_param: float
    vf_clip_param: float
    vf_coeff: float
    dual_clip_param: None | float
    #: Rows of the minibatch (the loss is their mean).
    n_rows: int
    #: Gradient-accumulation divisor of the total loss.
    accum: int
    use_entropy: bool
    #: Squash continuous actions through tanh (``SquashedNormal``): the
    #: log-probs invert through the clamped atanh with the ±100 clamp.
    #: Needs ``use_entropy=False``.
    squashed: bool = False


@dataclass(frozen=True)
class PackedColumns:
    """First column (and end, for multi-column leaves) of each leaf the
    kernel reads in the packed training batch."""

    obs: tuple[int, int]
    actions: tuple[int, int]
    logp: int
    advantages: int
    returns: int

    @classmethod
    def from_unpacker(cls, unpacker: RowUnpacker) -> "PackedColumns":
        idx = unpacker.leaf_index_tree()

        def span(i: int) -> tuple[int, int]:
            return unpacker.metas[i].start, unpacker.metas[i].stop

        return cls(
            obs=span(idx[DataKeys.VIEWS][DataKeys.OBS]),
            actions=span(idx[DataKeys.ACTIONS]),
            logp=span(idx[DataKeys.LOGP])[0],
            advantages=span(idx[DataKeys.ADVANTAGES])[0],
            returns=span(idx[DataKeys.RETURNS])[0],
        )


def supports_distribution(model: Any, distribution_cls: Any, *, zero_entropy: bool = False) -> bool:
    """Whether this model/distribution pair is one the port trains: a
    default model, the discrete one with ``Categorical``, the continuous
    one with ``Normal`` or, only when the entropy bonus is statically zero
    (it has no entropy), with ``SquashedNormal``."""
    from ..distributions import Categorical, Normal, SquashedNormal
    from ..models import DefaultContinuousModel, DefaultDiscreteModel

    if type(model) is DefaultDiscreteModel:
        return distribution_cls is Categorical
    if type(model) is DefaultContinuousModel:
        return distribution_cls is Normal or (distribution_cls is SquashedNormal and zero_entropy)
    return False


def supports_fused_update(model: Any, distribution_cls: Any, *, zero_entropy: bool = False) -> bool:
    """Whether the kernels can evaluate this model/distribution pair:
    ``rl8_tpu``'s gate, a model :func:`~rl8_tpu_torch.ops.fused_mlp.
    supports_fused_apply` takes (relu or tanh, biased layers, float
    observations, no compute dtype: ``rl8_tpu`` keeps an AMP model,
    ``dtype=bfloat16``, off its kernels too) in a pair
    :func:`supports_distribution` takes, at any depth."""
    return supports_fused_apply(model) and supports_distribution(model, distribution_cls, zero_entropy=zero_entropy)


def card_takes_update(params: ActParams) -> bool:
    """Whether ``csrc/ppo.cu`` takes these shapes: its narrow route keeps
    a row block's activations and heads in shared memory (layers up to 736
    wide at the dummy envs' shapes, any depth), its wide route keeps them
    in the row scratch and stages each product through shared memory (any
    width, any heads); both read their layers from a table in the
    workspace and run over chunks of rows within its 12 GiB budget, so a
    model whose weight copies and partials leave no room for one row block
    is refused. This builds the kernels, if they are not built yet, and
    asks them; the algorithms ask at build, so that a shape the kernel does
    not take raises there and never at a step."""
    hidden = (ctypes.c_int * len(params.hiddens))(*params.hiddens)
    kind = KINDS.index(params.kind)
    return load().rl8_ppo_workspace(1, params.d_in, len(params.hiddens), hidden, kind, params.action_dim, params.n) >= 0


def _policy_grad_terms(
    new_logp: torch.Tensor,
    old_logp: torch.Tensor,
    adv: torch.Tensor,
    cfg: PPOLossConfig,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row policy-loss elements, the upstream cotangent on
    ``new_logp`` and the KL elements, with the JAX package's
    boundary conventions: ``take1 = surr1 <= surr2``, a strict clip
    interval, and the dual-clip gate ``clip1 >= dual * adv``."""
    lr = new_logp - old_logp
    r = torch.exp(lr)
    c = cfg.clip_param
    rc = torch.clamp(r, 1.0 - c, 1.0 + c)
    surr1 = adv * r
    surr2 = adv * rc
    clip1 = torch.minimum(surr1, surr2)
    take1 = surr1 <= surr2
    in_clip = (r > 1.0 - c) & (r < 1.0 + c)
    zero = torch.zeros_like(adv)
    dclip1_dr = torch.where(take1, adv, torch.where(in_clip, adv, zero))
    if cfg.dual_clip_param:
        dual_adv = cfg.dual_clip_param * adv
        clip2 = torch.maximum(clip1, dual_adv)
        pol_elem = torch.where(adv < 0.0, clip2, clip1)
        delem_dr = torch.where(
            adv < 0.0, torch.where(clip1 >= dual_adv, dclip1_dr, zero), dclip1_dr
        )
    else:
        pol_elem = clip1
        delem_dr = dclip1_dr
    # The total has ``- policy_loss`` (the policy term is maximized).
    u_pol = -scale * delem_dr * r
    kl_elem = (r - 1.0) - lr
    return pol_elem, u_pol, kl_elem


def _vf_grad_terms(
    values: torch.Tensor, returns: torch.Tensor, cfg: PPOLossConfig, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Clamped smooth-L1 value-loss elements and d(loss)/d(values); the
    gradient is zeroed with the strict ``sl1 < vf_clip_param``."""
    d = values - returns
    ad = torch.abs(d)
    sl1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
    vf_elem = torch.clamp(sl1, 0.0, cfg.vf_clip_param)
    dsl1 = torch.where(ad < 1.0, d, torch.sign(d))
    dv = torch.where(sl1 < cfg.vf_clip_param, dsl1, torch.zeros_like(d)) * (cfg.vf_coeff * scale)
    return vf_elem, dv


def _losses(
    stats: torch.Tensor, entropy_coeff: torch.Tensor, cfg: PPOLossConfig, steps: int = 1
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """``(losses, kl)`` means from the four stat sums (policy, vf,
    entropy, kl) over ``n_rows * steps`` samples (``steps`` per recurrent
    sequence), as ``rl8_tpu``'s ``fused_ppo_grads`` and
    ``fused_rnn_ppo_grads`` form them."""
    n = float(cfg.n_rows * steps)
    policy, vf, entropy, kl = (stats[i] / n for i in range(4))
    total = cfg.vf_coeff * vf - policy
    if cfg.use_entropy:
        total = total - entropy_coeff * entropy
    return {"entropy": entropy, "policy": policy, "vf": vf, "total": total}, kl


def _check(
    params: ActParams,
    packed: torch.Tensor,
    cols: PackedColumns,
    entropy_coeff: torch.Tensor,
    cfg: PPOLossConfig,
) -> None:
    if packed.dtype != torch.int32 or packed.dim() != 2:
        raise ValueError(f"packed must be an int32 [N, D] matrix, got {packed.dtype} {tuple(packed.shape)}.")
    if packed.shape[0] != cfg.n_rows:
        raise ValueError(
            f"packed has {packed.shape[0]} rows but cfg.n_rows is {cfg.n_rows}: the loss is"
            " a mean over exactly n_rows rows."
        )
    if cols.obs[1] - cols.obs[0] != params.d_in:
        raise ValueError(f"The packed obs has {cols.obs[1] - cols.obs[0]} columns, the model {params.d_in}.")
    if params.kind not in KINDS:
        raise ValueError(f"Unknown distribution kind {params.kind!r}; expected one of {KINDS}.")
    if cfg.squashed != (params.kind == "squashed"):
        raise ValueError(f"cfg.squashed is {cfg.squashed} but the params' kind is {params.kind!r}.")
    if cfg.squashed and cfg.use_entropy:
        raise ValueError(
            "SquashedNormal has no defined entropy; the update kernel requires a statically-zero"
            " entropy coefficient."
        )
    if cols.actions[1] - cols.actions[0] != params.action_dim:
        raise ValueError(
            f"The packed actions have {cols.actions[1] - cols.actions[0]} columns, the model"
            f" {params.action_dim}."
        )
    if max(cols.obs[1], cols.actions[1], cols.logp + 1, cols.advantages + 1, cols.returns + 1) > packed.shape[1]:
        raise ValueError("A column lies past the packed matrix.")
    if entropy_coeff.dim() != 0 or entropy_coeff.dtype != torch.float32:
        raise ValueError("entropy_coeff must be a 0-d float32 tensor.")
    if not (packed.device == params.flat.device == entropy_coeff.device):
        raise ValueError("packed, the params and entropy_coeff must be on one device.")
    if cfg.n_rows <= 0 or cfg.accum <= 0:
        raise ValueError("cfg.n_rows and cfg.accum must be positive.")
    if params.activation not in ACT_FNS:
        raise ValueError(f"The update kernel supports activations {tuple(ACT_FNS)}.")


def ppo_grads_plain(
    params: ActParams,
    packed: torch.Tensor,
    unpacker: RowUnpacker,
    entropy_coeff: torch.Tensor,
    cfg: PPOLossConfig,
) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the update kernel (see
    :func:`fused_ppo_grads` for the arguments and results). With float64
    ``params.flat`` it computes in float64 (the packed f32 columns widened;
    the gradient is returned rounded to f32): a reference for inputs whose
    f32 rounding the loss magnifies."""
    cols = PackedColumns.from_unpacker(unpacker)
    _check(params, packed, cols, entropy_coeff, cfg)
    def as_f32(lo: int, hi: int) -> torch.Tensor:
        return packed[:, lo:hi].contiguous().view(torch.float32).to(params.flat.dtype)

    x = as_f32(*cols.obs)
    old_logp = as_f32(cols.logp, cols.logp + 1)
    adv = as_f32(cols.advantages, cols.advantages + 1)
    ret = as_f32(cols.returns, cols.returns + 1)

    chains = params.chains()
    (policy_heads, (values,)), hs = forward_chains(x, chains, params.activation)
    scale = 1.0 / (cfg.n_rows * cfg.accum)
    if params.continuous:
        new_logp, ent_rows, dpolicy = _continuous_terms(as_f32(*cols.actions), *policy_heads, cfg)
    else:
        new_logp, ent_rows, dpolicy = _categorical_terms(
            packed[:, cols.actions[0] : cols.actions[1]], policy_heads[0], params.n, cfg
        )
    pol_elem, u_pol, kl_elem = _policy_grad_terms(new_logp, old_logp, adv, cfg, scale)
    vf_elem, dv = _vf_grad_terms(values, ret, cfg, scale)
    dheads = dpolicy(u_pol, entropy_coeff * scale)
    grads = flatten_chains(chains_backward_plain(chains, params.activation, hs, [dheads, [dv]]))
    ent_total = ent_rows.sum() if ent_rows is not None else torch.zeros((), device=packed.device)
    stats = torch.stack([pol_elem.sum(), vf_elem.sum(), ent_total, kl_elem.sum()])
    losses, kl = _losses(stats, entropy_coeff, cfg)
    return losses, kl, grads


def _categorical_terms(actions: torch.Tensor, logits: torch.Tensor, n: int, cfg: PPOLossConfig):
    """``Categorical``'s per-row ``new_logp``, entropy (or ``None``) and a
    function from ``(u_pol, ec * scale)`` to the logits head's cotangent
    (``_discrete_kernel``'s formulas)."""
    new_logp = None
    ent_rows = None
    groups = []
    cats = torch.arange(n, device=logits.device)
    for a in range(actions.shape[1]):
        logp_all = log_softmax_rows(logits[:, a * n : (a + 1) * n])
        p = torch.exp(logp_all)
        onehot = cats == actions[:, a : a + 1]
        chosen = torch.where(onehot, logp_all, torch.zeros_like(logp_all)).sum(dim=1, keepdim=True)
        new_logp = chosen if new_logp is None else new_logp + chosen
        h_a = None
        if cfg.use_entropy:
            h_a = -(p * logp_all).sum(dim=1, keepdim=True)
            ent_rows = h_a if ent_rows is None else ent_rows + h_a
        groups.append((p, logp_all, onehot, h_a))

    def dheads(u_pol: torch.Tensor, ec_scale: torch.Tensor) -> list[torch.Tensor]:
        dz = []
        for p, logp_all, onehot, h_a in groups:
            dz_a = u_pol * (onehot.to(torch.float32) - p)
            if cfg.use_entropy:
                # The total has ``- ec * mean(H)``; dH/dz = -p (logp + H).
                dz_a = dz_a + ec_scale * p * (logp_all + h_a)
            dz.append(dz_a)
        return [torch.cat(dz, dim=1)]

    return new_logp, ent_rows, dheads


def _continuous_terms(
    actions: torch.Tensor, mean: torch.Tensor, pre_log_std: torch.Tensor, cfg: PPOLossConfig
):
    """``Normal``'s (or, with ``cfg.squashed``, ``SquashedNormal``'s)
    per-row ``new_logp``, entropy (or ``None``) and a function from
    ``(u_pol, ec * scale)`` to the mean and pre-tanh log-std heads'
    cotangents (``_continuous_kernel``'s formulas). With the squash, the
    ±100 clamp also zeroes both cotangents where it cuts."""
    log_std = torch.tanh(pre_log_std)
    inv_var = torch.exp(-2.0 * log_std)
    if cfg.squashed:
        new_logp, diff, gate = squashed_normal_logp(actions, mean, log_std, inv_var)
    else:
        diff = actions - mean
        gate = None
        new_logp = normal_per_dim_logp(diff, log_std, inv_var).sum(dim=1, keepdim=True)
    ent_rows = (0.5 * (1.0 + LOG_2PI) + log_std).sum(dim=1, keepdim=True) if cfg.use_entropy else None

    def dheads(u_pol: torch.Tensor, ec_scale: torch.Tensor) -> list[torch.Tensor]:
        # d new_logp / d mean = diff inv_var; / d log_std = diff^2 inv_var - 1.
        dmean = u_pol * (diff * inv_var)
        dlog_std = u_pol * (diff * diff * inv_var - 1.0)
        if gate is not None:
            dmean = dmean * gate
            dlog_std = dlog_std * gate
        if cfg.use_entropy:
            # H = sum(0.5 (1 + log 2 pi) + log_std); the total has -ec mean(H).
            dlog_std = dlog_std - ec_scale
        return [dmean, dlog_std * (1.0 - log_std * log_std)]

    return new_logp, ent_rows, dheads


def fused_ppo_grads(
    params: ActParams,
    packed: torch.Tensor,
    unpacker: RowUnpacker,
    entropy_coeff: torch.Tensor,
    cfg: PPOLossConfig,
) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """PPO losses, approximate KL and every parameter gradient for one
    packed minibatch: the same as differentiating ``ppo_losses(...)
    ["total"] / accum`` through the model (to f32 rounding).

    CUDA tensors launch ``csrc/ppo.cu`` (and count one launch in
    ``fused_ppo_grads.launches`` for the categorical kind, in
    ``fused_ppo_grads.continuous_launches`` for the others) or raise; CPU
    tensors run :func:`ppo_grads_plain`.

    Args:
        params: The model's parameters in kernel order (``flat`` may be
            any f32 vector of that layout, e.g. the optimizer's copy).
        packed: ``[n_rows, D]`` int32 minibatch from
            :func:`~rl8_tpu_torch.ops.packing.pack_rows` over the flat
            training batch (continuous actions as f32 bit patterns).
        unpacker: The matching unpacker (for the column layout).
        entropy_coeff: 0-d f32 tensor on the device (read there, never
            fetched).
        cfg: Static loss hyperparameters.

    Returns:
        ``(losses, kl, grads)``: ``losses`` has the ``ppo_losses`` keys
        (minibatch means), ``kl`` is the mean approximate KL, ``grads`` is
        flat f32 in :func:`~rl8_tpu_torch.ops.fused_mlp.flatten_chains`
        order; all on the device.

    """
    if packed.device.type == "cpu":
        return ppo_grads_plain(params, packed, unpacker, entropy_coeff, cfg)
    cols = PackedColumns.from_unpacker(unpacker)
    _check(params, packed, cols, entropy_coeff, cfg)
    if packed.device.type != "cuda":
        raise ValueError(f"No update kernel for device {packed.device}.")
    if not (packed.is_contiguous() and params.flat.is_contiguous()):
        raise ValueError("The update kernel needs a contiguous packed matrix and params.")
    lib = load()
    N, D = packed.shape
    hidden = (ctypes.c_int * len(params.hiddens))(*params.hiddens)
    kind = KINDS.index(params.kind)
    workspace = lib.rl8_ppo_workspace(
        N, params.d_in, len(params.hiddens), hidden, kind, params.action_dim, params.n
    )
    if workspace < 0:
        raise ValueError("The update kernel does not take these shapes.")
    dev = packed.device
    work = torch.empty(workspace, dtype=torch.float32, device=dev)
    grads = torch.empty_like(params.flat)
    stats = torch.empty(4, dtype=torch.float32, device=dev)
    col_starts = (ctypes.c_int * 5)(cols.obs[0], cols.actions[0], cols.logp, cols.advantages, cols.returns)
    scale = 1.0 / (cfg.n_rows * cfg.accum)
    code = lib.rl8_ppo_grads(
        packed.data_ptr(), N, D, col_starts, entropy_coeff.data_ptr(), params.flat.data_ptr(),
        grads.data_ptr(), stats.data_ptr(), work.data_ptr(), params.d_in, len(params.hiddens),
        hidden, kind, params.action_dim, params.n, list(ACT_FNS).index(params.activation),
        1.0 - cfg.clip_param, 1.0 + cfg.clip_param, float(cfg.dual_clip_param or 0.0),
        cfg.vf_clip_param, cfg.vf_coeff * scale, scale, int(cfg.use_entropy),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    check(code, "The PPO update kernel", grads, stats)
    if params.continuous:
        fused_ppo_grads.continuous_launches += 1
    else:
        fused_ppo_grads.launches += 1
    losses, kl = _losses(stats, entropy_coeff, cfg)
    return losses, kl, grads


#: Kernel launches so far, per distribution family (CUDA tensors only;
#: the CPU path counts none).
fused_ppo_grads.launches = 0
fused_ppo_grads.continuous_launches = 0
