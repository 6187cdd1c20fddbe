"""The MountainCar example (counterpart of ``examples/mountain_car``): train it
with ``python -m rl8_tpu_torch.examples.mountain_car``, or through the CLI with
``python -m rl8_tpu_torch train -f rl8_tpu_torch/examples/mountain_car/config.yaml``."""

from .env import MountainCar, MountainCarConfig

__all__ = ["MountainCar", "MountainCarConfig"]
