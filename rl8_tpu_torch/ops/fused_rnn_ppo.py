"""Recurrent PPO update kernel: the losses and every parameter gradient of
one packed minibatch of sequences in one call.

PyTorch/CUDA counterpart of ``rl8_tpu/ops/fused_rnn_ppo.py`` (the Pallas
``_kernel``): per sequence, the stacked-LSTM forward over ``seq_len``
steps from the stored initial states, the heads and the PPO losses of
every step, and the hand-derived backward through time (the inter-layer
``dx`` included) into every LSTM and head gradient. One body holds the
discrete branch (``DefaultDiscreteRecurrentModel`` with ``Categorical``)
and the continuous one (``DefaultContinuousRecurrentModel`` with
``Normal`` or, without an entropy bonus, ``SquashedNormal``); the kernel
is ``csrc/rnn_ppo.cu``.

:func:`fused_rnn_ppo_grads` launches the kernel for CUDA tensors and
raises if it cannot; for CPU tensors it runs :func:`rnn_ppo_grads_plain`,
the kernel's arithmetic in plain PyTorch with the feedforward update's
loss terms (``fused_ppo._policy_grad_terms``, ``_vf_grad_terms``,
``_categorical_terms``, ``_continuous_terms``, so the clip-boundary
conventions are the same), which is also what the kernel is held against.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any

import torch

from ..data import DataKeys
from ._build import check, load
from .fused_ppo import (
    PPOLossConfig,
    _categorical_terms,
    _continuous_terms,
    _losses,
    _policy_grad_terms,
    _vf_grad_terms,
)
from .fused_rnn_act import MAX_RNN_LAYERS, RNN_KINDS, RnnParams, lstm_cell
from .packing import RowUnpacker

__all__ = [
    "RnnPackedColumns",
    "card_takes_rnn_update",
    "fused_rnn_ppo_grads",
    "rnn_ppo_grads_plain",
    "supports_fused_rnn_update",
]


@dataclass(frozen=True)
class RnnPackedColumns:
    """Column span of each leaf the kernel reads in the packed sequence
    batch ``{actions, advantages, logp, obs, returns, states}``, whose
    leaves are ``[N, L, ...]`` (states ``[N, K, H]``)."""

    obs: tuple[int, int]
    hidden: tuple[int, int]
    cell: tuple[int, int]
    actions: tuple[int, int]
    logp: tuple[int, int]
    advantages: tuple[int, int]
    returns: tuple[int, int]

    @classmethod
    def from_unpacker(cls, unpacker: RowUnpacker) -> "RnnPackedColumns":
        idx = unpacker.leaf_index_tree()

        def span(i: int) -> tuple[int, int]:
            return unpacker.metas[i].start, unpacker.metas[i].stop

        states = idx[DataKeys.STATES]
        return cls(
            obs=span(idx[DataKeys.OBS]),
            hidden=span(states[DataKeys.HIDDEN_STATES]),
            cell=span(states[DataKeys.CELL_STATES]),
            actions=span(idx[DataKeys.ACTIONS]),
            logp=span(idx[DataKeys.LOGP]),
            advantages=span(idx[DataKeys.ADVANTAGES]),
            returns=span(idx[DataKeys.RETURNS]),
        )

    @property
    def seq_len(self) -> int:
        """``L``, from the width of the log-prob leaf."""
        return self.logp[1] - self.logp[0]


def supports_fused_rnn_update(model: Any, distribution_cls: Any, *, zero_entropy: bool = False) -> bool:
    """Whether the recurrent update can evaluate this model/distribution
    pair: a default recurrent model with 1 to 8 biased LSTM layers and
    float observations, the discrete one with ``Categorical``, the
    continuous one with ``Normal`` or, only when the entropy bonus is
    statically zero (it has no entropy), with ``SquashedNormal``.

    These are ``rl8_tpu``'s gates without its VMEM residency limit on the
    width: the plain version takes any width, and the card kernel's own
    limit is asked of it by :func:`card_takes_rnn_update`."""
    from ..distributions import Categorical, Normal, SquashedNormal
    from ..models import DefaultContinuousRecurrentModel, DefaultDiscreteRecurrentModel

    if type(model) is DefaultDiscreteRecurrentModel:
        ok = distribution_cls is Categorical
    elif type(model) is DefaultContinuousRecurrentModel:
        ok = distribution_cls is Normal or (distribution_cls is SquashedNormal and zero_entropy)
    else:
        return False
    # The packed rows carry observations as f32 bit patterns.
    return (
        ok
        and 1 <= model.num_layers <= MAX_RNN_LAYERS
        and bool(model.bias)
        and model.observation_spec.dtype.is_floating_point
    )


def _kernel_dims(params: RnnParams, seq_len: int) -> tuple[int, ...]:
    """The shape arguments of ``rl8_rnn_ppo_workspace`` and
    ``rl8_rnn_ppo_grads`` after the row count."""
    kind = RNN_KINDS.index(params.kind)
    return (params.d_in, params.hidden, seq_len, params.num_layers, kind, params.action_dim, params.n)


def card_takes_rnn_update(params: RnnParams) -> bool:
    """Whether ``csrc/rnn_ppo.cu`` takes the model's widths. Its row pass
    keeps a block's sequences' layer inputs, gate cotangents and head rows
    in shared memory (32 sequences where they fit, else 16), which caps
    the width (``H`` near 700 at the main path's heads on an H100, where
    ``rl8_tpu``'s VMEM gate allows ~2048). The limit is the kernel's own;
    this builds the kernels, if they are not built yet, and asks them."""
    return load().rl8_rnn_ppo_workspace(1, *_kernel_dims(params, seq_len=1)) >= 0


def _check(
    params: RnnParams,
    packed: torch.Tensor,
    cols: RnnPackedColumns,
    entropy_coeff: torch.Tensor,
    cfg: PPOLossConfig,
) -> None:
    if packed.dtype != torch.int32 or packed.dim() != 2:
        raise ValueError(f"packed must be an int32 [N, D] matrix, got {packed.dtype} {tuple(packed.shape)}.")
    if packed.shape[0] != cfg.n_rows:
        raise ValueError(
            f"packed has {packed.shape[0]} rows but cfg.n_rows is {cfg.n_rows}: the loss is"
            " a mean over exactly n_rows sequences."
        )
    if params.kind not in RNN_KINDS:
        raise ValueError(f"Unknown distribution kind {params.kind!r}; expected one of {RNN_KINDS}.")
    if cfg.squashed != (params.kind == "squashed"):
        raise ValueError(f"cfg.squashed is {cfg.squashed} but the params' kind is {params.kind!r}.")
    if cfg.squashed and cfg.use_entropy:
        raise ValueError(
            "SquashedNormal has no defined entropy; the update kernel requires a statically-zero"
            " entropy coefficient."
        )
    L, KH = cols.seq_len, params.num_layers * params.hidden
    widths = {
        "obs": (cols.obs, L * params.d_in),
        "hidden states": (cols.hidden, KH),
        "cell states": (cols.cell, KH),
        "actions": (cols.actions, L * params.action_dim),
        "advantages": (cols.advantages, L),
        "returns": (cols.returns, L),
    }
    for name, ((lo, hi), want) in widths.items():
        if hi - lo != want:
            raise ValueError(f"The packed {name} have {hi - lo} columns; the model and seq_len {L} take {want}.")
        if hi > packed.shape[1]:
            raise ValueError("A column lies past the packed matrix.")
    if L <= 0:
        raise ValueError("seq_len must be positive.")
    if entropy_coeff.dim() != 0 or entropy_coeff.dtype != torch.float32:
        raise ValueError("entropy_coeff must be a 0-d float32 tensor.")
    if not (packed.device == params.flat.device == entropy_coeff.device):
        raise ValueError("packed, the params and entropy_coeff must be on one device.")
    if cfg.n_rows <= 0 or cfg.accum <= 0:
        raise ValueError("cfg.n_rows and cfg.accum must be positive.")
    if not 1 <= params.num_layers <= MAX_RNN_LAYERS:
        raise ValueError(f"The update kernel takes 1 to {MAX_RNN_LAYERS} LSTM layers.")


def rnn_ppo_grads_plain(
    params: RnnParams,
    packed: torch.Tensor,
    unpacker: RowUnpacker,
    entropy_coeff: torch.Tensor,
    cfg: PPOLossConfig,
) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the recurrent update kernel (see
    :func:`fused_rnn_ppo_grads` for the arguments and results)."""
    cols = RnnPackedColumns.from_unpacker(unpacker)
    _check(params, packed, cols, entropy_coeff, cfg)
    N, L, K, H, A = packed.shape[0], cols.seq_len, params.num_layers, params.hidden, params.action_dim

    def as_f32(span: tuple[int, int]) -> torch.Tensor:
        return packed[:, span[0] : span[1]].contiguous().view(torch.float32)

    obs = as_f32(cols.obs).view(N, L, params.d_in)
    hs = list(as_f32(cols.hidden).view(N, K, H).unbind(1))
    cs = list(as_f32(cols.cell).view(N, K, H).unbind(1))
    lstm = params.lstm()
    # Forward over the sequence: per step and layer the cell's input,
    # previous states, gates and tanh(c'), which the backward reads.
    saves, tops = [], []
    for t in range(L):
        x = obs[:, t]
        layer_saves = []
        for l, (wi, wh, b) in enumerate(lstm):
            h_new, c_new, gates, tc = lstm_cell(x, hs[l], cs[l], wi, wh, b)
            layer_saves.append((x, hs[l], cs[l], gates, tc))
            hs[l], cs[l], x = h_new, c_new, h_new
        saves.append(layer_saves)
        tops.append(x)
    # The heads and the loss terms of all N * L samples at once, rows in
    # (sequence, step) order.
    h_top = torch.stack(tops, dim=1).reshape(N * L, H)
    heads = params.heads()
    outs = [h_top @ w + b for w, b in heads]
    scale = 1.0 / (cfg.n_rows * L * cfg.accum)
    if params.continuous:
        actions = as_f32(cols.actions).reshape(N * L, A)
        new_logp, ent_rows, dpolicy = _continuous_terms(actions, outs[0], outs[1], cfg)
    else:
        actions = packed[:, cols.actions[0] : cols.actions[1]].reshape(N * L, A)
        new_logp, ent_rows, dpolicy = _categorical_terms(actions, outs[0], params.n, cfg)
    old_logp = as_f32(cols.logp).reshape(N * L, 1)
    adv = as_f32(cols.advantages).reshape(N * L, 1)
    ret = as_f32(cols.returns).reshape(N * L, 1)
    pol_elem, u_pol, kl_elem = _policy_grad_terms(new_logp, old_logp, adv, cfg, scale)
    vf_elem, dv = _vf_grad_terms(outs[-1], ret, cfg, scale)
    douts = [*dpolicy(u_pol, entropy_coeff * scale), dv]
    head_grads = [(h_top.t() @ dout, dout.sum(dim=0)) for dout in douts]
    dh_head = sum(dout @ w.t() for (w, _), dout in zip(heads, douts)).view(N, L, H)

    # Backward through time; head cotangents enter the top layer only.
    zeros = torch.zeros((N, H), dtype=torch.float32, device=packed.device)
    dh_time, dc_time = [zeros] * K, [zeros] * K
    lstm_grads = [[torch.zeros_like(p) for p in layer] for layer in lstm]
    for t in range(L - 1, -1, -1):
        dx_above = dh_head[:, t]
        for l in range(K - 1, -1, -1):
            x_in, h_prev, c_prev, (i, f, g, o), tc = saves[t][l]
            dh = dh_time[l] + dx_above
            dc = dh * o * (1.0 - tc * tc) + dc_time[l]
            dz = torch.cat(
                [dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f), dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)],
                dim=1,
            )
            dwi, dwh, db = lstm_grads[l]
            dwi += x_in.t() @ dz
            dwh += h_prev.t() @ dz
            db += dz.sum(dim=0)
            wi, wh, _ = lstm[l]
            if t > 0:  # the stored initial states take no gradient
                dh_time[l] = dz @ wh.t()
            dc_time[l] = dc * f
            if l > 0:
                dx_above = dz @ wi.t()
    flat_grads = [g for layer in lstm_grads for g in layer] + [g for pair in head_grads for g in pair]
    grads = torch.cat([g.reshape(-1) for g in flat_grads])
    ent_total = ent_rows.sum() if ent_rows is not None else torch.zeros((), device=packed.device)
    stats = torch.stack([pol_elem.sum(), vf_elem.sum(), ent_total, kl_elem.sum()])
    losses, kl = _losses(stats, entropy_coeff, cfg, steps=L)
    return losses, kl, grads


def fused_rnn_ppo_grads(
    params: RnnParams,
    packed: torch.Tensor,
    unpacker: RowUnpacker,
    entropy_coeff: torch.Tensor,
    cfg: PPOLossConfig,
) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Recurrent PPO losses, approximate KL and every parameter gradient
    for one packed minibatch of sequences: the same as differentiating
    ``ppo_losses(...)["total"] / accum`` over its ``n_rows * seq_len``
    samples through the model (to f32 rounding).

    CUDA tensors launch ``csrc/rnn_ppo.cu`` (and count one launch in
    ``fused_rnn_ppo_grads.launches`` for the categorical kind, in
    ``fused_rnn_ppo_grads.continuous_launches`` for the others) or raise;
    CPU tensors run :func:`rnn_ppo_grads_plain`.

    Args:
        params: The model's parameters in kernel order (``flat`` may be
            any f32 vector of that layout, e.g. the optimizer's copy).
        packed: ``[n_rows, D]`` int32 minibatch from
            :func:`~rl8_tpu_torch.ops.packing.pack_rows` over the sequence
            batch ``{actions, advantages, logp, obs, returns, states}``
            (continuous actions as f32 bit patterns).
        unpacker: The matching unpacker (for the column layout).
        entropy_coeff: 0-d f32 tensor on the device (read there, never
            fetched).
        cfg: Static loss hyperparameters; ``n_rows`` counts sequences.

    Returns:
        ``(losses, kl, grads)``: ``losses`` has the ``ppo_losses`` keys
        (means over samples), ``kl`` is the mean approximate KL, ``grads``
        is flat f32 in :class:`~rl8_tpu_torch.ops.fused_rnn_act.RnnParams`
        order; all on the device.

    """
    if packed.device.type == "cpu":
        return rnn_ppo_grads_plain(params, packed, unpacker, entropy_coeff, cfg)
    cols = RnnPackedColumns.from_unpacker(unpacker)
    _check(params, packed, cols, entropy_coeff, cfg)
    if packed.device.type != "cuda":
        raise ValueError(f"No recurrent update kernel for device {packed.device}.")
    if not (packed.is_contiguous() and params.flat.is_contiguous()):
        raise ValueError("The recurrent update kernel needs a contiguous packed matrix and params.")
    lib = load()
    N, D = packed.shape
    L = cols.seq_len
    dims = _kernel_dims(params, L)
    workspace = lib.rl8_rnn_ppo_workspace(N, *dims)
    if workspace < 0:
        raise NotImplementedError(
            f"The recurrent update kernel's row pass does not fit a block's shared memory at hidden size"
            f" {params.hidden} with {params.d_in} inputs (see card_takes_rnn_update)."
        )
    dev = packed.device
    work = torch.empty(workspace, dtype=torch.float32, device=dev)
    grads = torch.empty_like(params.flat)
    stats = torch.empty(4, dtype=torch.float32, device=dev)
    starts = (cols.obs, cols.hidden, cols.cell, cols.actions, cols.logp, cols.advantages, cols.returns)
    col_starts = (ctypes.c_int * 7)(*(span[0] for span in starts))
    scale = 1.0 / (cfg.n_rows * L * cfg.accum)
    code = lib.rl8_rnn_ppo_grads(
        packed.data_ptr(), N, D, col_starts, entropy_coeff.data_ptr(), params.flat.data_ptr(),
        grads.data_ptr(), stats.data_ptr(), work.data_ptr(), *dims,
        1.0 - cfg.clip_param, 1.0 + cfg.clip_param, float(cfg.dual_clip_param or 0.0),
        cfg.vf_clip_param, cfg.vf_coeff * scale, scale, int(cfg.use_entropy),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    check(code, "The recurrent PPO update kernel")
    if params.continuous:
        fused_rnn_ppo_grads.continuous_launches += 1
    else:
        fused_rnn_ppo_grads.launches += 1
    losses, kl = _losses(stats, entropy_coeff, cfg, steps=L)
    return losses, kl, grads


#: Kernel launches so far, per distribution family (CUDA tensors only;
#: the CPU path counts none).
fused_rnn_ppo_grads.launches = 0
fused_rnn_ppo_grads.continuous_launches = 0
