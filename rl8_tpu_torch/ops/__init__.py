"""Hand-written CUDA kernels for the hot ops, each beside its plain
PyTorch version (counterpart of ``rl8_tpu/ops``), and the row packing
that feeds the update kernel.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise. The kernels are built from ``csrc/`` at first use.
"""

from .fused_act import ActParams, act_plain, card_takes_act, fused_act, pack_act_params
from .fused_mlp import (
    FusedApplySpec,
    FusedRecurrentApplySpec,
    card_takes_chains,
    chains_fit_vmem,
    chains_vjp_plain,
    forward_chains,
    fused_chains,
    fused_chains_bwd,
    fused_chains_fwd,
    fused_custom_apply,
    fused_default_apply,
    fused_recurrent_custom_apply,
    model_fits_vmem,
    supports_fused_apply,
    supports_fused_recurrent_apply,
)
from .fused_ppo import PPOLossConfig, card_takes_update, fused_ppo_grads, ppo_grads_plain, supports_fused_update
from .fused_rnn_act import RnnParams, card_takes_rnn_act, fused_rnn_act, load_rnn_params, pack_rnn_params, rnn_act_plain
from .fused_rnn_ppo import card_takes_rnn_update, fused_rnn_ppo_grads, rnn_ppo_grads_plain, supports_fused_rnn_update
from .gae import fused_gae, gae_plain
from .packing import RowUnpacker, block_shuffle, pack_rows

__all__ = [
    "ActParams",
    "FusedApplySpec",
    "FusedRecurrentApplySpec",
    "PPOLossConfig",
    "RnnParams",
    "RowUnpacker",
    "act_plain",
    "block_shuffle",
    "card_takes_act",
    "card_takes_chains",
    "card_takes_rnn_act",
    "card_takes_rnn_update",
    "card_takes_update",
    "chains_fit_vmem",
    "chains_vjp_plain",
    "forward_chains",
    "fused_act",
    "fused_chains",
    "fused_chains_bwd",
    "fused_chains_fwd",
    "fused_custom_apply",
    "fused_default_apply",
    "fused_gae",
    "fused_recurrent_custom_apply",
    "fused_ppo_grads",
    "fused_rnn_act",
    "fused_rnn_ppo_grads",
    "gae_plain",
    "load_rnn_params",
    "model_fits_vmem",
    "pack_act_params",
    "pack_rnn_params",
    "pack_rows",
    "ppo_grads_plain",
    "rnn_act_plain",
    "rnn_ppo_grads_plain",
    "supports_fused_apply",
    "supports_fused_recurrent_apply",
    "supports_fused_rnn_update",
    "supports_fused_update",
]
