"""Train the algotrading example with a model of one's choice, on the card
(counterpart of ``examples/algotrading/__main__.py``):
``python -m rl8_tpu_torch.examples.algotrading [--model
{lstm,mlp,transformer}] [--fused-forward]``."""

import argparse
import sys
import tempfile

from rl8_tpu_torch import TrainConfig
from rl8_tpu_torch.conditions import Plateaus
from rl8_tpu_torch.trainers.tracking import JsonlRun, set_default_run

from .env import AlgoTrading
from .models import AttentiveAlpaca, LazyLemur, MischievousMule

parser = argparse.ArgumentParser(
    description=(
        "An example algotrading environment where a policy learns to hold,"
        " buy, and sell an asset. A playground for custom sequence-based and"
        " recurrent models."
    )
)
parser.add_argument(
    "--model",
    choices=["lstm", "mlp", "transformer"],
    default="mlp",
    help="Model class type to use.",
)
parser.add_argument(
    "--fused-forward",
    action="store_true",
    help=(
        "Run the model's torso and head chains through the chain kernels"
        " (csrc/chains.cu; every algotrading model declares a fused apply"
        " spec). Off by default: the model's module forward."
    ),
)

#: ``--model`` choices: the model class and whether it is recurrent.
MODELS = {"lstm": (LazyLemur, True), "mlp": (MischievousMule, False), "transformer": (AttentiveAlpaca, False)}


def main(argv: None | list[str] = None) -> None:
    args = parser.parse_args(argv)
    model_cls, recurrent = MODELS[args.model]
    track_dir = tempfile.mkdtemp(prefix="rl8-tpu-torch-algotrading-")
    set_default_run(JsonlRun(track_dir))
    print(f"Logging metrics under {track_dir}", file=sys.stderr)
    train_config = TrainConfig(
        AlgoTrading,
        algorithm_config={"model_cls": model_cls, "fused_forward": args.fused_forward},
        recurrent=recurrent,
    )
    trainer = train_config.build()
    trainer.run(
        steps_per_eval=10,
        stop_conditions=[Plateaus("returns/mean", patience=10, rtol=0.05)],
    )


if __name__ == "__main__":
    main()
