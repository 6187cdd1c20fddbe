"""High-level training interfaces (counterpart of
``rl8_tpu/trainers/_base.py``): the same counters, eval reset-boundary
guards, cadence rules and metric names, with tracking through the
pluggable :mod:`rl8_tpu_torch.trainers.tracking` interface.

Checkpoints and preemption (``checkpoint_dir`` and the options that go
with it, :meth:`GenericTrainerBase.save_checkpoint` and
:meth:`GenericTrainerBase.restore_checkpoint`) are not in this port yet
(ROADMAP Queue 1 #7): they raise ``NotImplementedError`` before anything
is collected.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Generic, TypeVar

from ..algorithms import GenericAlgorithmBase
from ..conditions import Condition
from ..data import EvalCollectStats, TrainerState, TrainStats
from ..parallel import is_main_process
from ..utils import reduce_stats
from .tracking import NoopRun, Run, get_default_run

__all__ = ["GenericTrainerBase"]

_Algorithm = TypeVar("_Algorithm", bound=GenericAlgorithmBase[Any, Any, Any])

#: Why the checkpoint options raise.
_NO_CHECKPOINTS = (
    "Checkpoints, resume and preemption handling are not in this port yet;"
    " they come with persistence and serving (ROADMAP Queue 1 #7)."
)


class GenericTrainerBase(Generic[_Algorithm]):
    """The base trainer interface.

    Args:
        algorithm: Underlying PPO algorithm (env, model, action
            distribution, and hyperparameters included).
        run: Tracking backend; defaults to the process-wide default run.
            Only process 0 logs: on other processes of a
            ``torch.distributed`` job a caller-supplied run is replaced
            with a no-op backend (pass ``log_all_processes=True`` to
            override).

    """

    #: Underlying PPO algorithm.
    algorithm: _Algorithm

    #: Tracking backend receiving params (once) and per-step metrics.
    tracking_run: Run

    #: Running totals for logging and eval-boundary checks.
    state: TrainerState

    def __init__(
        self,
        algorithm: _Algorithm,
        /,
        *,
        run: None | Run = None,
        log_all_processes: bool = False,
    ) -> None:
        self.algorithm = algorithm
        if log_all_processes or is_main_process():
            self.tracking_run = run if run is not None else get_default_run()
        else:
            self.tracking_run = NoopRun()
        self.state = {
            "algorithm/collects": 0,
            "algorithm/steps": 0,
            "env/steps": 0,
        }
        self.tracking_run.log_params(self.algorithm.params)

    def eval(
        self, *, env_config: None | dict[str, Any] = None, deterministic: bool = True
    ) -> EvalCollectStats:
        """Evaluate over ``horizons_per_env_reset`` horizons.

        Raises:
            RuntimeError: If called outside the algorithm's
                ``horizons_per_env_reset`` interval (algorithms share one
                buffer between training and evaluation).
            ValueError: If an eval env config is provided but the env
                never resets after startup.

        """
        if (
            env_config
            and self.algorithm.horizons_per_env_reset < 0
            and self.state["algorithm/collects"]
        ):
            raise ValueError(
                "`horizons_per_env_reset` < 0 means the environment resets"
                " exactly once at startup, so an eval env config would never"
                " be applied. Drop the eval env config, or set"
                " `horizons_per_env_reset` > 0."
            )
        if (
            self.algorithm.horizons_per_env_reset > 0
            and self.state["algorithm/collects"] % self.algorithm.horizons_per_env_reset
        ):
            raise RuntimeError(
                f"{self.eval.__qualname__} is only valid on a"
                " `horizons_per_env_reset` boundary: training and evaluation"
                " collect into one shared rollout buffer, so an off-boundary"
                " eval would clobber partially-collected training data."
            )
        stats: dict[str, list[float]] = defaultdict(list)
        horizons_per_env_reset = max(1, self.algorithm.horizons_per_env_reset)
        for _ in range(horizons_per_env_reset):
            for k, v in self.algorithm.collect(env_config=env_config, deterministic=deterministic).items():
                stats[k].append(v)
            self.state["algorithm/collects"] += 1
        eval_stats = {f"eval/{k}": v for k, v in reduce_stats(stats).items()}
        self.tracking_run.log_metrics(eval_stats, step=self.state["env/steps"])
        return eval_stats  # type: ignore[return-value]

    def step_fused(self, num_steps: int, /, *, env_config: None | dict[str, Any] = None) -> list[TrainStats]:
        """Run ``num_steps`` training steps through the algorithm's
        ``train_steps``, logging each step's stats. Equivalent to
        ``num_steps`` :meth:`step` calls, with one memory reading."""
        memory_stats = self.algorithm.memory_stats()
        records = self.algorithm.train_steps(num_steps, env_config=env_config)
        out: list[TrainStats] = []
        for record in records:
            self.state["algorithm/collects"] += 1
            self.state["algorithm/steps"] += 1
            # The counter that keys tracking history stays an int.
            self.state["env/steps"] += int(record["env/steps"])
            train_stats: dict[str, Any] = {**memory_stats, **record}
            train_stats.update(self.state)
            self.tracking_run.log_metrics(train_stats, step=self.state["env/steps"])
            out.append(train_stats)  # type: ignore[arg-type]
        return out

    def run(
        self,
        *,
        env_config: None | dict[str, Any] = None,
        eval_env_config: None | dict[str, Any] = None,
        steps_per_eval: None | int = None,
        stop_conditions: None | list[Condition] = None,
        fused_steps: None | int = None,
        steps_per_checkpoint: None | int = None,
        checkpoint_dir: Any = None,
        resume: bool = True,
        checkpoint_on_preemption: bool = True,
        async_checkpoints: bool = False,
    ) -> TrainStats:
        """Train until any stop condition is satisfied. Runs indefinitely
        without stop conditions.

        Args:
            env_config: Env config override (e.g. domain randomization).
            eval_env_config: Env config during evals; defaults to
                ``env_config``.
            steps_per_eval: Trainer steps between evals.
            stop_conditions: Any one evaluating ``True`` stops training.
            fused_steps: Run the steps in batches of this many through
                :meth:`step_fused`; must divide ``steps_per_eval``.
            steps_per_checkpoint: Validated as ``rl8_tpu`` validates it;
                checkpoints are not in this port yet.
            checkpoint_dir: Any value raises ``NotImplementedError``
                (ROADMAP Queue 1 #7).
            resume: Used only with ``checkpoint_dir``.
            checkpoint_on_preemption: Used only with ``checkpoint_dir``.
            async_checkpoints: Requires ``checkpoint_dir``.

        Returns:
            The most recent train stats when training stops.

        Raises:
            ValueError: If an eval env config is provided for an env that
                never resets, if ``steps_per_eval`` isn't a multiple of
                ``horizons_per_env_reset``, or on the cadence and
                checkpoint-option errors ``rl8_tpu`` raises.
            NotImplementedError: If ``checkpoint_dir`` is given.

        """
        if steps_per_eval and self.algorithm.horizons_per_env_reset < 0 and eval_env_config:
            raise ValueError(
                "`horizons_per_env_reset` < 0 means the environment resets"
                " exactly once at startup, so an eval env config would never"
                " be applied. Drop the eval env config, or set"
                " `horizons_per_env_reset` > 0."
            )
        if (
            steps_per_eval
            and self.algorithm.horizons_per_env_reset > 0
            and steps_per_eval % self.algorithm.horizons_per_env_reset
        ):
            raise ValueError(
                f"{self.eval.__qualname__} is only valid on a"
                " `horizons_per_env_reset` boundary; set `steps_per_eval` to"
                " a multiple of `horizons_per_env_reset`."
            )
        if fused_steps and steps_per_eval and steps_per_eval % fused_steps:
            raise ValueError(
                "`fused_steps` must be a factor of `steps_per_eval` so"
                " evaluations land between fused batches."
            )
        if fused_steps and steps_per_checkpoint and steps_per_checkpoint % fused_steps:
            raise ValueError(
                "`fused_steps` must be a factor of `steps_per_checkpoint`:"
                " the step counter only lands on multiples of"
                " `fused_steps`, so any other cadence silently degrades"
                " to their least common multiple."
            )
        if steps_per_checkpoint and not checkpoint_dir:
            raise ValueError("`steps_per_checkpoint` requires a `checkpoint_dir`.")
        if async_checkpoints and not checkpoint_dir:
            raise ValueError(
                "`async_checkpoints` requires a `checkpoint_dir` (there is"
                " nothing to write in the background without one)."
            )
        if checkpoint_dir:
            raise NotImplementedError(_NO_CHECKPOINTS)
        eval_env_config = eval_env_config or env_config
        stop_conditions = stop_conditions or []

        if fused_steps and fused_steps > 1:
            while True:
                for train_stats in self.step_fused(fused_steps, env_config=env_config):
                    if any(c(train_stats) for c in stop_conditions):
                        return train_stats
                if steps_per_eval and not (self.state["algorithm/steps"] % steps_per_eval):
                    self.eval(env_config=eval_env_config)
        train_stats = self.step(env_config=env_config)
        while not any(condition(train_stats) for condition in stop_conditions):
            if steps_per_eval and not (self.state["algorithm/steps"] % steps_per_eval):
                self.eval(env_config=eval_env_config)
            train_stats = self.step(env_config=env_config)
        return train_stats

    def save_checkpoint(self, directory: Any, /, *, block: bool = True) -> None:
        """Not in this port yet (ROADMAP Queue 1 #7)."""
        raise NotImplementedError(_NO_CHECKPOINTS)

    def restore_checkpoint(self, directory: Any, /) -> None:
        """Not in this port yet (ROADMAP Queue 1 #7)."""
        raise NotImplementedError(_NO_CHECKPOINTS)

    def step(self, *, env_config: None | dict[str, Any] = None) -> TrainStats:
        """One training step: collect + update + log."""
        memory_stats = self.algorithm.memory_stats()
        collect_stats = self.algorithm.collect(env_config=env_config)
        step_stats = self.algorithm.step()
        train_stats: dict[str, Any] = {
            **memory_stats,
            **collect_stats,
            **step_stats,
        }
        self.state["algorithm/collects"] += 1
        self.state["algorithm/steps"] += 1
        # The counter that keys tracking history stays an int.
        self.state["env/steps"] += int(collect_stats["env/steps"])
        train_stats.update(self.state)
        self.tracking_run.log_metrics(train_stats, step=self.state["env/steps"])
        return train_stats  # type: ignore[return-value]
