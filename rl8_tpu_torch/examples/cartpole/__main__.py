"""Train CartPole on the card (counterpart of ``examples/cartpole/__main__.py``):
``python -m rl8_tpu_torch.examples.cartpole``."""

import sys
import tempfile

from rl8_tpu_torch import AlgorithmConfig, Trainer
from rl8_tpu_torch.conditions import HitsUpperBound
from rl8_tpu_torch.trainers.tracking import JsonlRun, set_default_run

from .env import CartPole


def main() -> None:
    track_dir = tempfile.mkdtemp(prefix="rl8-tpu-torch-cartpole-")
    set_default_run(JsonlRun(track_dir))
    print(f"Logging metrics under {track_dir}", file=sys.stderr)
    algo = AlgorithmConfig(horizon=64).build(CartPole)
    trainer = Trainer(algo)
    trainer.run(
        steps_per_eval=5,
        stop_conditions=[HitsUpperBound("algorithm/steps", 40)],
    )


if __name__ == "__main__":
    main()
