"""Conditions over training metrics, most commonly for deciding when to
stop training (counterpart of ``rl8_tpu/conditions.py``). They run on the
host, on the stats a trainer's step returns."""

from __future__ import annotations

from typing import Protocol

from .data import TrainStatKey, TrainStats

__all__ = [
    "Condition",
    "And",
    "HitsLowerBound",
    "HitsUpperBound",
    "Plateaus",
    "StopsDecreasing",
    "StopsIncreasing",
]


class Condition(Protocol):
    """Condition callable returning ``True`` when met."""

    def __call__(self, train_stats: TrainStats, /) -> bool:
        ...


class And:
    """Join multiple conditions with an ``AND``."""

    conditions: list[Condition]

    def __init__(self, conditions: list[Condition], /) -> None:
        self.conditions = conditions

    def __call__(self, train_stats: TrainStats, /) -> bool:
        return all(condition(train_stats) for condition in self.conditions)


class HitsLowerBound:
    """``True`` when the monitored value hits a lower bound."""

    key: TrainStatKey
    lower_bound: float

    def __init__(self, key: TrainStatKey, lower_bound: float, /) -> None:
        self.key = key
        self.lower_bound = lower_bound

    def __call__(self, train_stats: TrainStats, /) -> bool:
        return train_stats[self.key] <= self.lower_bound


class HitsUpperBound:
    """``True`` when the monitored value hits an upper bound.

    Examples:
        >>> from rl8_tpu_torch.conditions import HitsUpperBound
        >>> cond = HitsUpperBound("env/steps", 100)
        >>> cond({"env/steps": 99}), cond({"env/steps": 100})
        (False, True)

    """

    key: TrainStatKey
    upper_bound: float

    def __init__(self, key: TrainStatKey, upper_bound: float, /) -> None:
        self.key = key
        self.upper_bound = upper_bound

    def __call__(self, train_stats: TrainStats, /) -> bool:
        return train_stats[self.key] >= self.upper_bound


class Plateaus:
    """``True`` when the monitored value stays within ``rtol`` of its
    previous value ``patience`` times in a row.

    Args:
        key: Train stat to monitor.
        patience: Consecutive plateaued evaluations required.
        rtol: Relative tolerance between consecutive values.

    Examples:
        >>> from rl8_tpu_torch.conditions import Plateaus
        >>> cond = Plateaus("returns/mean", patience=2, rtol=0.1)
        >>> [cond({"returns/mean": v}) for v in (1.0, 1.01, 1.02)]
        [False, False, True]

    """

    key: TrainStatKey
    losses: int
    old_value: float
    patience: int
    rtol: float

    def __init__(self, key: TrainStatKey, /, *, patience: int = 5, rtol: float = 1e-3) -> None:
        self.key = key
        self.patience = patience
        self.rtol = rtol
        self.losses = 0
        self.old_value = 0.0

    def __call__(self, train_stats: TrainStats, /) -> bool:
        new_value = train_stats[self.key]
        if abs(new_value - self.old_value) <= self.rtol * abs(self.old_value):
            self.losses += 1
        else:
            self.losses = 0
        self.old_value = new_value
        return self.losses >= self.patience


class StopsDecreasing:
    """``True`` when the monitored value fails to set a new minimum
    ``patience`` times in a row."""

    key: TrainStatKey
    losses: int
    min_: float
    patience: int

    def __init__(self, key: TrainStatKey, /, *, patience: int = 5) -> None:
        self.key = key
        self.patience = patience
        self.losses = 0
        self.min_ = float("inf")

    def __call__(self, train_stats: TrainStats, /) -> bool:
        new_value = train_stats[self.key]
        if new_value >= self.min_:
            self.losses += 1
        else:
            self.losses = 0
            self.min_ = new_value
        return self.losses >= self.patience


class StopsIncreasing:
    """``True`` when the monitored value fails to set a new maximum
    ``patience`` times in a row."""

    key: TrainStatKey
    losses: int
    max_: float
    patience: int

    def __init__(self, key: TrainStatKey, /, *, patience: int = 5) -> None:
        self.key = key
        self.patience = patience
        self.losses = 0
        self.max_ = float("-inf")

    def __call__(self, train_stats: TrainStats, /) -> bool:
        new_value = train_stats[self.key]
        if new_value <= self.max_:
            self.losses += 1
        else:
            self.losses = 0
            self.max_ = new_value
        return self.losses >= self.patience
