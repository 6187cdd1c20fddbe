"""The CartPole example (counterpart of ``examples/cartpole``): train it
with ``python -m rl8_tpu_torch.examples.cartpole``, or through the CLI with
``python -m rl8_tpu_torch train -f rl8_tpu_torch/examples/cartpole/config.yaml``."""

from .env import CartPole, CartPoleConfig

__all__ = ["CartPole", "CartPoleConfig"]
