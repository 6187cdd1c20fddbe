"""Command-line interface: ``python -m rl8_tpu_torch train -f config.yaml``
(counterpart of ``rl8_tpu/__main__.py``). Tracking goes to a JSONL run
directory (``--track-dir``) or to MLflow when it is installed and
requested (``--mlflow``). ``--checkpoint-dir`` saves full-state
checkpoints and resumes from them, ``--save DIR`` exports the trained
policy to ``DIR/policy.pkl``. ``doctor`` runs the bring-up checks
(``rl8_tpu_torch/doctor.py``) and exits non-zero if one fails.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

from .conditions import HitsUpperBound
from .trainers import TrainConfig
from .trainers.tracking import JsonlRun, MlflowRun, set_default_run

__all__ = ["main"]


def main(argv: None | list[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="rl8-tpu-torch",
        description="rl8 on PyTorch and CUDA: train PPO policies from a config file.",
    )
    subparsers = parser.add_subparsers(dest="command", required=True)
    train_parser = subparsers.add_parser("train", help="Train a policy from a YAML/JSON train config.")
    train_parser.add_argument("-f", "--file", required=True, help="Path to a YAML or JSON train config file.")
    train_parser.add_argument("--experiment-name", default=None, help="Experiment name used for tracking.")
    train_parser.add_argument(
        "--max-steps", type=int, default=100, help="Maximum number of algorithm steps before training stops."
    )
    train_parser.add_argument(
        "--steps-per-eval", type=int, default=None, help="Trainer steps between policy evaluations."
    )
    train_parser.add_argument(
        "--save", default=None, help="Directory to export the trained policy to (as policy.pkl)."
    )
    train_parser.add_argument(
        "--track-dir", default=None, help="Directory for JSONL metric tracking (a temp dir by default)."
    )
    train_parser.add_argument(
        "--checkpoint-dir",
        default=None,
        help="Directory for full-state checkpoints; an existing checkpoint there is resumed from.",
    )
    train_parser.add_argument(
        "--steps-per-checkpoint",
        type=int,
        default=None,
        help="Trainer steps between checkpoints (default: every step, or every --fused-steps batch).",
    )
    train_parser.add_argument(
        "--no-resume", action="store_true", help="Start fresh even if --checkpoint-dir holds a checkpoint."
    )
    train_parser.add_argument(
        "--fused-steps",
        type=int,
        default=None,
        help="Run the train steps in batches of this many (Trainer.step_fused)."
        " Must divide --steps-per-eval.",
    )
    train_parser.add_argument(
        "--async-checkpoints",
        action="store_true",
        help="Write checkpoints in the background (training overlaps the write).",
    )
    train_parser.add_argument(
        "--no-preemption-checkpoint",
        action="store_true",
        help="Don't catch SIGTERM for a final checkpoint (on by default with --checkpoint-dir).",
    )
    train_parser.add_argument("--mlflow", action="store_true", help="Track with MLflow instead of JSONL files.")
    doctor_parser = subparsers.add_parser("doctor", help="Bring-up checks (devices, mesh, storage, config gates).")
    doctor_parser.add_argument("-f", "--file", default=None, help="Optional train config.")
    doctor_parser.add_argument("--checkpoint-dir", default=None, help="Optional checkpoint path to probe.")
    args = parser.parse_args(argv)

    if args.command == "doctor":
        from .doctor import run_doctor

        return run_doctor(config_file=args.file, checkpoint_dir=args.checkpoint_dir)

    if not args.checkpoint_dir:
        # Checkpoint knobs without a destination would otherwise be
        # silently ignored.
        for flag, value in (
            ("--async-checkpoints", args.async_checkpoints),
            ("--steps-per-checkpoint", args.steps_per_checkpoint),
        ):
            if value:
                parser.error(f"{flag} requires --checkpoint-dir")

    config = TrainConfig.from_file(args.file)
    if args.mlflow:
        import mlflow

        mlflow.set_experiment(args.experiment_name or "rl8-tpu-torch")
        set_default_run(MlflowRun())
    else:
        track_dir = args.track_dir or tempfile.mkdtemp(prefix=f"{args.experiment_name or 'rl8-tpu-torch'}-")
        set_default_run(JsonlRun(track_dir))
        print(f"Tracking metrics to {track_dir}", file=sys.stderr)

    trainer = config.build()
    trainer.run(
        steps_per_eval=args.steps_per_eval,
        stop_conditions=[HitsUpperBound("algorithm/steps", args.max_steps)],
        checkpoint_dir=args.checkpoint_dir,
        steps_per_checkpoint=(
            # Default cadence: every step, or every fused batch.
            (args.steps_per_checkpoint or args.fused_steps or 1)
            if args.checkpoint_dir
            else None
        ),
        resume=not args.no_resume,
        checkpoint_on_preemption=not args.no_preemption_checkpoint,
        async_checkpoints=args.async_checkpoints,
        fused_steps=args.fused_steps,
    )
    if args.save:
        save_dir = pathlib.Path(args.save)
        save_dir.mkdir(parents=True, exist_ok=True)
        trainer.algorithm.policy.save(save_dir / "policy.pkl")
        print(f"Saved policy to {save_dir / 'policy.pkl'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
