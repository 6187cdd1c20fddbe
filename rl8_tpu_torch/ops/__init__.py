"""Hand-written CUDA kernels for the hot ops, each beside its plain
PyTorch version (counterpart of ``rl8_tpu/ops``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise. The kernels are built from ``csrc/`` at first use.
"""

from .fused_act import ActParams, act_plain, fused_act, pack_act_params
from .gae import fused_gae, gae_plain

__all__ = ["ActParams", "act_plain", "fused_act", "fused_gae", "gae_plain", "pack_act_params"]
