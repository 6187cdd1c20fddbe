"""rl8-tpu ported to PyTorch and CUDA for NVIDIA Hopper (H100).

The package mirrors ``rl8_tpu``'s layout and names. Its hot ops are
hand-written CUDA kernels (``csrc/``, built with ``nvcc`` at first use)
beside plain PyTorch versions: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise. It imports neither JAX nor
``rl8_tpu``; the tests hold it against ``rl8_tpu`` on the CPU.

Ported so far: feedforward and recurrent PPO on the default models, end
to end: the discrete ones with ``Categorical`` and the continuous ones
with ``Normal`` or ``SquashedNormal``. The rollout (``collect``) runs
through the act kernel of the model (feedforward, or the stacked-LSTM
recurrent one), and the update (``step``) through the GAE kernel and the
PPO update kernel of the model (feedforward, or the recurrent one with
its backward through time), with clip-by-global-norm and Adam. Custom
models (``model``/``model_cls``; ``examples.algotrading``'s
``MischievousMule``, ``AttentiveAlpaca`` and the recurrent ``LazyLemur``)
run their torso and head chains, with ``fused_forward=True``, through the
chain kernels, and their update through autograd; their views may window
past actions, rewards, log-probs and values. The
trainers (``Trainer``, ``RecurrentTrainer``), stop conditions, tracking,
``TrainConfig`` and the ``train`` CLI (``python -m rl8_tpu_torch train -f
config.yaml``) drive those algorithms; ``examples`` holds the
classic-control envs (CartPole, Pendulum, MountainCar) and algotrading.
``checkpoint`` saves and restores a run bit for bit, ``preemption``
turns a SIGTERM into a final checkpoint, ``Policy.save``/``load`` export
a policy and ``policies.serving`` serves it; ``parity`` records and
judges the port's learning curves against the reference's.
"""

from .algorithms import Algorithm, AlgorithmConfig, RecurrentAlgorithm, RecurrentAlgorithmConfig
from .env import Env
from .trainers import RecurrentTrainer, TrainConfig, Trainer

#: ``rl8_tpu``'s version: the port follows that release's API.
__version__ = "0.5.0"

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "Env",
    "RecurrentAlgorithm",
    "RecurrentAlgorithmConfig",
    "RecurrentTrainer",
    "TrainConfig",
    "Trainer",
    "__version__",
]
