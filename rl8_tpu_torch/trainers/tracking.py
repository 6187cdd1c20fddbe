"""Experiment tracking with flat ``"group/name"`` metric names
(counterpart of ``rl8_tpu/trainers/tracking.py``).

Tracking goes through a pluggable ``Run`` interface with three built-in
backends:

- :class:`NoopRun` — discard everything (default);
- :class:`JsonlRun` — append params/metrics to JSONL files;
- :class:`MlflowRun` — forward to MLflow when it's importable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping, Protocol

__all__ = [
    "Run",
    "NoopRun",
    "JsonlRun",
    "MlflowRun",
    "get_default_run",
    "set_default_run",
]


class Run(Protocol):
    """Tracking interface consumed by trainers."""

    def log_params(self, params: Mapping[str, Any], /) -> None:
        ...

    def log_metrics(self, metrics: Mapping[str, float], /, *, step: int) -> None:
        ...


class NoopRun:
    """Tracking backend that discards everything."""

    def log_params(self, params: Mapping[str, Any], /) -> None:
        ...

    def log_metrics(self, metrics: Mapping[str, float], /, *, step: int) -> None:
        ...


class JsonlRun:
    """Append-only JSONL tracking backend.

    Writes ``params.json`` once and appends one JSON object per
    ``log_metrics`` call to ``metrics.jsonl`` under ``directory``.
    """

    def __init__(self, directory: str | os.PathLike[str]) -> None:
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._metrics_path = os.path.join(self.directory, "metrics.jsonl")

    def log_params(self, params: Mapping[str, Any], /) -> None:
        with open(os.path.join(self.directory, "params.json"), "w") as f:
            json.dump({k: str(v) for k, v in params.items()}, f, indent=2)

    def log_metrics(self, metrics: Mapping[str, float], /, *, step: int) -> None:
        # Reserved record fields win over same-named metrics, so a metric
        # literally keyed "step"/"time" can't corrupt the x-axis that
        # downstream tooling reads.
        record = {**metrics, "step": step, "time": time.time()}
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")


class MlflowRun:
    """MLflow tracking backend (requires ``mlflow`` to be installed)."""

    def __init__(self) -> None:
        import mlflow  # noqa: F401 — raise early when unavailable

        self._mlflow = mlflow

    def log_params(self, params: Mapping[str, Any], /) -> None:
        self._mlflow.log_params(dict(params))

    def log_metrics(self, metrics: Mapping[str, float], /, *, step: int) -> None:
        self._mlflow.log_metrics(dict(metrics), step=step)


_default_run: Run = NoopRun()


def get_default_run() -> Run:
    """Return the process-wide default tracking run."""
    return _default_run


def set_default_run(run: Run, /) -> None:
    """Set the process-wide default tracking run used by trainers that
    aren't given one explicitly."""
    global _default_run
    _default_run = run
