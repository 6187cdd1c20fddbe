"""Schedulers for values, learning rates, and entropy coefficients driven
by environment transition counts.

A copy of ``rl8_tpu/schedulers.py`` (host-only numpy, no JAX), kept in
the port so that it imports nothing of the JAX package. As there,
:class:`LRScheduler` only tracks the current value: the algorithm hands
it to its optimizer each step (``utils/optim.py``), the counterpart of
``optax.inject_hyperparams``.
"""

from __future__ import annotations

from typing import Literal, Protocol

import numpy as np

__all__ = [
    "ScheduleKind",
    "Scheduler",
    "ConstantScheduler",
    "InterpScheduler",
    "StepScheduler",
    "EntropyScheduler",
    "LRScheduler",
]

ScheduleKind = Literal["interp", "step"]


class Scheduler(Protocol):
    """Scheduler protocol returning a value for an environment sample
    count (``schedulers.py:11-21``)."""

    def step(self, count: int, /) -> float:
        ...


class ConstantScheduler:
    """Scheduler that outputs a constant value (``schedulers.py:24-42``)."""

    value: float

    def __init__(self, value: float, /) -> None:
        self.value = value

    def step(self, _: int, /) -> float:
        return self.value


class InterpScheduler:
    """Scheduler that interpolates between schedule points by environment
    transition count (``schedulers.py:45-80``).

    Args:
        schedule: ``[(count, value), ...]`` pairs; the first count must be
            ``0`` to declare the initial value.

    Examples:
        >>> from rl8_tpu_torch.schedulers import InterpScheduler
        >>> scheduler = InterpScheduler([(0, 1.0), (100, 0.0)])
        >>> scheduler.step(50)
        0.5

    """

    x: list[int]
    y: list[float]

    def __init__(self, schedule: list[tuple[int, float]], /) -> None:
        if schedule[0][0]:
            raise ValueError(
                f"{self.__class__.__name__} schedules must start at step 0"
                " (`schedule[0][0] == 0`), which defines the initial value."
            )
        self.x = [int(x) for x, _ in schedule]
        self.y = [float(y) for _, y in schedule]

    def step(self, count: int, /) -> float:
        return float(np.interp(count, self.x, self.y))


class StepScheduler:
    """Scheduler that jumps to a new value when the transition count
    exceeds a threshold and holds it (``schedulers.py:83-118``).

    Args:
        schedule: ``[(count, value), ...]`` pairs; the first count must be
            ``0`` to declare the initial value.

    Examples:
        >>> from rl8_tpu_torch.schedulers import StepScheduler
        >>> scheduler = StepScheduler([(0, 0.001), (100, 0.0001)])
        >>> scheduler.step(99), scheduler.step(100)
        (0.001, 0.0001)

    """

    schedule: list[tuple[int, float]]

    def __init__(self, schedule: list[tuple[int, float]], /) -> None:
        if schedule[0][0]:
            raise ValueError(
                f"{self.__class__.__name__} schedules must start at step 0"
                " (`schedule[0][0] == 0`), which defines the initial value."
            )
        self.schedule = schedule

    def step(self, count: int, /) -> float:
        value = 0.0
        for t, v in self.schedule:
            if count >= t:
                value = v
        return value


def _make_scheduler(
    default: float,
    schedule: None | list[tuple[int, float]],
    kind: ScheduleKind,
    what: str,
) -> Scheduler:
    if schedule is None:
        return ConstantScheduler(default)
    match kind:
        case "interp":
            return InterpScheduler(schedule)
        case "step":
            return StepScheduler(schedule)
    raise ValueError(f"{what} scheduler only supports kinds `interp` and `step`.")


class EntropyScheduler:
    """Entropy-coefficient scheduler keyed on environment transition
    counts (``schedulers.py:121-171``).

    Args:
        coeff: Entropy coefficient; ignored when ``schedule`` is given.
        schedule: Optional ``[(count, value), ...]`` schedule.
        kind: ``"step"`` (jump and hold) or ``"interp"`` (interpolate).

    """

    coeff: float
    scheduler: Scheduler

    def __init__(
        self,
        coeff: float,
        /,
        *,
        schedule: None | list[tuple[int, float]] = None,
        kind: ScheduleKind = "step",
    ) -> None:
        self.scheduler = _make_scheduler(coeff, schedule, kind, "Entropy")
        self.coeff = self.step(0)

    def step(self, count: int, /) -> float:
        self.coeff = self.scheduler.step(count)
        return self.coeff


class LRScheduler:
    """Learning-rate scheduler keyed on environment transition counts
    (``schedulers.py:174-232``).

    Args:
        initial_lr: Learning rate used when no ``schedule`` is given.
        schedule: Optional ``[(count, value), ...]`` schedule.
        kind: ``"step"`` (jump and hold) or ``"interp"`` (interpolate).

    """

    coeff: float
    scheduler: Scheduler

    def __init__(
        self,
        initial_lr: float,
        /,
        *,
        schedule: None | list[tuple[int, float]] = None,
        kind: ScheduleKind = "step",
    ) -> None:
        self.scheduler = _make_scheduler(initial_lr, schedule, kind, "Learning rate")
        self.coeff = self.step(0)

    def step(self, count: int, /) -> float:
        self.coeff = self.scheduler.step(count)
        return self.coeff
