"""rl8-tpu ported to PyTorch and CUDA for NVIDIA Hopper (H100).

The package mirrors ``rl8_tpu``'s layout and names. Its hot ops are
hand-written CUDA kernels (``csrc/``, built with ``nvcc`` at first use)
beside plain PyTorch versions: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise. It imports neither JAX nor
``rl8_tpu``; the tests hold it against ``rl8_tpu`` on the CPU.

Ported so far: the feedforward rollout (``Algorithm.collect``) through
the discrete act kernel, and the advantage stage through the GAE kernel.
"""

from .algorithms import Algorithm, AlgorithmConfig
from .env import Env

__all__ = ["Algorithm", "AlgorithmConfig", "Env"]
