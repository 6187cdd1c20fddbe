"""Train Pendulum on the card (counterpart of ``examples/pendulum/__main__.py``):
``python -m rl8_tpu_torch.examples.pendulum``."""

import sys
import tempfile

from rl8_tpu_torch import AlgorithmConfig, Trainer
from rl8_tpu_torch.conditions import HitsUpperBound
from rl8_tpu_torch.trainers.tracking import JsonlRun, set_default_run

from .env import Pendulum


def main() -> None:
    track_dir = tempfile.mkdtemp(prefix="rl8-tpu-torch-pendulum-")
    set_default_run(JsonlRun(track_dir))
    print(f"Logging metrics under {track_dir}", file=sys.stderr)
    algo = AlgorithmConfig(
        horizon=128,
        horizons_per_env_reset=4,
    ).build(Pendulum)
    trainer = Trainer(algo)
    trainer.run(
        steps_per_eval=4,
        stop_conditions=[HitsUpperBound("algorithm/steps", 100)],
    )


if __name__ == "__main__":
    main()
