"""Data contracts: buffer key names, validated hyperparameters, algorithm
state, and stat typings.

PyTorch counterpart of ``rl8_tpu/data.py``. The key strings and the
hyperparameter constraints are identical; the algorithm state is a plain
dataclass holding tensors on the algorithm's device, with the host-side
counters kept as Python values so the rollout loop never reads the
device to decide what to do next.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Literal, TypedDict

import torch

__all__ = [
    "DataKeys",
    "AlgorithmHparams",
    "AlgorithmState",
    "CollectStats",
    "EvalCollectStats",
    "MemoryStats",
    "RecurrentAlgorithmHparams",
    "RecurrentAlgorithmState",
    "StepStats",
    "TrainStatKey",
    "TrainStats",
    "TrainerState",
]


class DataKeys:
    """Common identifiers for elements within batches of data.

    Examples:
        >>> from rl8_tpu_torch.data import DataKeys
        >>> (DataKeys.OBS, DataKeys.REWARDS, DataKeys.ACTIONS)
        ('obs', 'rewards', 'actions')

    """

    OBS = "obs"
    REWARDS = "rewards"
    RETURNS = "returns"
    FEATURES = "features"
    ACTIONS = "actions"
    LOGP = "logp"
    VALUES = "values"
    INPUTS = "inputs"
    PADDING_MASK = "padding_mask"
    VIEWS = "views"
    ADVANTAGES = "advantages"
    STATES = "states"
    HIDDEN_STATES = "hidden_states"
    CELL_STATES = "cell_states"
    REVERSED_DISCOUNTED_RETURNS = "reversed_discounted_returns"


@dataclass(frozen=True, kw_only=True)
class AlgorithmHparams:
    """Feedforward PPO hyperparameters, frozen and validated (the same
    constraint set as ``rl8_tpu.data.AlgorithmHparams``)."""

    accumulate_grads: bool
    clip_param: float
    dual_clip_param: None | float
    enable_amp: bool
    gae_lambda: float
    gamma: float
    horizon: int
    horizons_per_env_reset: int
    max_grad_norm: float
    normalize_advantages: bool
    normalize_rewards: bool
    num_envs: int
    num_sgd_iters: int
    sgd_minibatch_size: int
    shuffle_minibatches: bool
    shuffle_block_rows: int = 8
    target_kl_div: None | float
    vf_clip_param: float
    vf_coeff: float

    def __post_init__(self) -> None:
        if not (0 < self.clip_param < 1):
            raise ValueError("`clip_param` must be in (0, 1).")
        if self.dual_clip_param is not None and not (self.dual_clip_param > 1):
            raise ValueError("`dual_clip_param` must be `None` or > 1.")
        if not (0 < self.gae_lambda <= 1):
            raise ValueError("`gae_lambda` must be in (0, 1].")
        if not (0 < self.gamma <= 1):
            raise ValueError("`gamma` must be in (0, 1].")
        if not (self.horizon > 0):
            raise ValueError("`horizon` must be > 0.")
        if self.horizons_per_env_reset == 0:
            raise ValueError("`horizons_per_env_reset` must be nonzero.")
        if not (self.max_grad_norm > 0):
            raise ValueError("`max_grad_norm` must be > 0.")
        if not (self.num_sgd_iters > 0):
            raise ValueError("`num_sgd_iters` must be > 0.")
        if not (self.sgd_minibatch_size > 0):
            raise ValueError("`sgd_minibatch_size` must be > 0.")
        if not (self.shuffle_block_rows > 0):
            raise ValueError("`shuffle_block_rows` must be > 0.")
        if self.target_kl_div is not None and self.accumulate_grads:
            raise ValueError(
                "KL-based early stopping (`target_kl_div`) can't be combined with"
                " gradient accumulation."
            )
        if self.target_kl_div is not None and not (self.target_kl_div > 0):
            raise ValueError("`target_kl_div` must be > 0.")
        if not (self.vf_clip_param > 0):
            raise ValueError("`vf_clip_param` must be > 0.")
        if not (self.vf_coeff > 0):
            raise ValueError("`vf_coeff` must be > 0.")
        if self.accumulate_grads and (self.num_minibatches == 1):
            raise ValueError(
                "With a whole-buffer minibatch there is nothing to"
                " accumulate over: `accumulate_grads=True` requires more than"
                " one minibatch. Shrink `sgd_minibatch_size` or disable"
                " `accumulate_grads`."
            )

    @property
    def num_minibatches(self) -> int:
        return (self.num_envs * self.horizon) // self.sgd_minibatch_size

    @property
    def effective_shuffle_block(self) -> int:
        """Rows per epoch-shuffle unit: ``gcd(shuffle_block_rows,
        sgd_minibatch_size)``, so blocks never straddle a minibatch."""
        return math.gcd(self.shuffle_block_rows, self.sgd_minibatch_size)

    def validate(self) -> "AlgorithmHparams":
        """Cross-field validation deferred past ``__post_init__``."""
        if (self.num_envs * self.horizon) % self.sgd_minibatch_size:
            raise ValueError(
                "`sgd_minibatch_size` must divide `num_envs * horizon` evenly."
            )
        return self


@dataclass(frozen=True, kw_only=True)
class RecurrentAlgorithmHparams(AlgorithmHparams):
    """Recurrent PPO hyperparameters (the same constraint set as
    ``rl8_tpu.data.RecurrentAlgorithmHparams``). A minibatch counts
    sequences of ``seq_len`` steps.

    Examples:
        >>> from rl8_tpu_torch.data import RecurrentAlgorithmHparams
        >>> kw = dict(accumulate_grads=False, clip_param=0.2, dual_clip_param=None, enable_amp=False,
        ...           gae_lambda=0.95, gamma=0.95, horizon=32, horizons_per_env_reset=1, max_grad_norm=5.0,
        ...           normalize_advantages=True, normalize_rewards=True, num_envs=8, num_sgd_iters=4,
        ...           sgd_minibatch_size=16, shuffle_minibatches=True, target_kl_div=None, vf_clip_param=5.0,
        ...           vf_coeff=1.0, seqs_per_state_reset=8)
        >>> RecurrentAlgorithmHparams(seq_len=4, **kw).num_minibatches
        4
        >>> RecurrentAlgorithmHparams(seq_len=5, **kw)
        Traceback (most recent call last):
        ...
        ValueError: `seq_len` must be a factor of `horizon`.

    """

    seq_len: int
    seqs_per_state_reset: int

    def __post_init__(self) -> None:
        super().__post_init__()
        if not (self.seq_len > 0):
            raise ValueError("`seq_len` must be > 0.")
        if self.horizon % self.seq_len:
            raise ValueError("`seq_len` must be a factor of `horizon`.")
        if self.seqs_per_state_reset == 0:
            raise ValueError("`seqs_per_state_reset` must be nonzero.")
        if (self.horizon * self.horizons_per_env_reset) % (self.seq_len * self.seqs_per_state_reset):
            raise ValueError(
                "`seq_len * seqs_per_state_reset` must be a factor of"
                " `horizon * horizons_per_env_reset`."
            )

    @property
    def num_minibatches(self) -> int:
        return (self.num_envs * (self.horizon // self.seq_len)) // self.sgd_minibatch_size

    def validate(self) -> "RecurrentAlgorithmHparams":
        if (self.num_envs * (self.horizon // self.seq_len)) % self.sgd_minibatch_size:
            raise ValueError(
                "`sgd_minibatch_size` must be a factor of"
                " `num_envs * (horizon // seq_len)`."
            )
        return self


@dataclass
class AlgorithmState:
    """Dynamic feedforward PPO state.

    Counterpart of ``rl8_tpu.data.AlgorithmState``. Parameters live in
    the policy's ``nn.Module`` and the random streams in the algorithm's
    ``torch.Generator``s, so neither is repeated here.
    """

    #: Environment state (a dict of tensors).
    env_state: Any
    #: Time-major rollout buffer (a dict of tensors).
    buffer: dict[str, Any]
    #: Number of horizons collected (drives the env-reset cadence).
    horizons: int = 0
    #: Whether `collect` ran since the last `step` (guards dummy data).
    buffered: bool = False
    #: 0-d f32 tensor on the device: the std of the reversed discounted
    #: returns that scales rewards in the advantage stage.
    reward_scale: torch.Tensor = field(default_factory=lambda: torch.tensor(1.0))
    #: The optimizer's state over the flat parameter vector (Adam's
    #: moments and step count, on the device); ``None`` until built.
    opt_state: Any = None


@dataclass
class RecurrentAlgorithmState(AlgorithmState):
    """Recurrent PPO dynamic state: adds the sequence counter that drives
    the recurrent states' reset cadence (a host int, since the rollout loop
    runs on the host)."""

    #: Number of recurrent sequences transitioned during training.
    seqs: int = 0


TrainerState = TypedDict(
    "TrainerState",
    {
        "algorithm/collects": int,
        "algorithm/steps": int,
        "env/steps": int,
    },
)

CollectStats = TypedDict(
    "CollectStats",
    {
        "env/resets": int,
        "env/steps": int,
        "profiling/collect_ms": float,
        "returns/min": float,
        "returns/max": float,
        "returns/mean": float,
        "returns/std": float,
        "rewards/min": float,
        "rewards/max": float,
        "rewards/mean": float,
        "rewards/std": float,
    },
    total=False,
)

EvalCollectStats = TypedDict(
    "EvalCollectStats",
    {
        "eval/env/resets": int,
        "eval/env/steps": int,
        "eval/profiling/collect_ms": float,
        "eval/returns/min": float,
        "eval/returns/max": float,
        "eval/returns/mean": float,
        "eval/returns/std": float,
        "eval/rewards/min": float,
        "eval/rewards/max": float,
        "eval/rewards/mean": float,
        "eval/rewards/std": float,
    },
    total=False,
)

MemoryStats = TypedDict(
    "MemoryStats",
    {
        "memory/free": int,
        "memory/total": int,
        "memory/percent": float,
    },
    total=False,
)

StepStats = TypedDict(
    "StepStats",
    {
        "coefficients/entropy": float,
        "coefficients/vf": float,
        "losses/entropy": float,
        "losses/policy": float,
        "losses/vf": float,
        "losses/total": float,
        "monitors/kl_div": float,
        "profiling/step_ms": float,
    },
    total=False,
)


class TrainStats(CollectStats, MemoryStats, StepStats, TrainerState):
    """What a trainer's step logs: the collect, memory and step stats and
    the trainer's counters."""


TrainStatKey = Literal[
    "algorithm/collects",
    "algorithm/steps",
    "env/resets",
    "env/steps",
    "profiling/collect_ms",
    "returns/min",
    "returns/max",
    "returns/mean",
    "returns/std",
    "rewards/min",
    "rewards/max",
    "rewards/mean",
    "rewards/std",
    "coefficients/entropy",
    "coefficients/vf",
    "losses/entropy",
    "losses/policy",
    "losses/vf",
    "losses/total",
    "memory/free",
    "memory/total",
    "memory/percent",
    "monitors/kl_div",
    "profiling/step_ms",
]
