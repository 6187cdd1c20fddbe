"""The Pendulum example (counterpart of ``examples/pendulum``): train it
with ``python -m rl8_tpu_torch.examples.pendulum``, or through the CLI with
``python -m rl8_tpu_torch train -f rl8_tpu_torch/examples/pendulum/config.yaml``."""

from .env import Pendulum, PendulumConfig

__all__ = ["Pendulum", "PendulumConfig"]
