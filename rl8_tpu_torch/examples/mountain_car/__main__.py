"""Train MountainCar on the card (counterpart of
``examples/mountain_car/__main__.py``): ``python -m
rl8_tpu_torch.examples.mountain_car``."""

import sys
import tempfile

from rl8_tpu_torch import AlgorithmConfig, Trainer
from rl8_tpu_torch.conditions import HitsUpperBound
from rl8_tpu_torch.trainers.tracking import JsonlRun, set_default_run

from .env import MountainCar


def main() -> None:
    track_dir = tempfile.mkdtemp(prefix="rl8-tpu-torch-mountain-car-")
    set_default_run(JsonlRun(track_dir))
    print(f"Logging metrics under {track_dir}", file=sys.stderr)
    algo = AlgorithmConfig(horizon=64).build(MountainCar)
    trainer = Trainer(algo)
    trainer.run(
        steps_per_eval=5,
        stop_conditions=[HitsUpperBound("algorithm/steps", 40)],
    )


if __name__ == "__main__":
    main()
