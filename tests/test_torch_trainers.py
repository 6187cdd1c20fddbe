"""The port's trainers, stop conditions and host utilities
(``rl8_tpu_torch/{conditions,trainers,utils,parallel}``) held against
``rl8_tpu``'s on the CPU: conditions' decisions on the same stat
sequences, ``run()``'s cadence on one counter-only stub algorithm driven
by both packages' ``GenericTrainerBase``, the checkpoint options on real
algorithms of both packages, and ``Trainer``/``RecurrentTrainer`` on real
algorithms against ``rl8_tpu``'s ``TrainStats`` keys at the same config."""

from __future__ import annotations

import math
import sys
from typing import Any

import numpy as np
import pytest
import torch

import rl8_tpu.conditions as jconditions
import rl8_tpu.utils as jutils
from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
from rl8_tpu import RecurrentAlgorithmConfig as JRecurrentAlgorithmConfig
from rl8_tpu import RecurrentTrainer as JRecurrentTrainer
from rl8_tpu import Trainer as JTrainer
from rl8_tpu.env import DiscreteDummyEnv as JDiscreteDummyEnv
from rl8_tpu.trainers._base import GenericTrainerBase as JGenericTrainerBase
from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig, RecurrentTrainer, Trainer
from rl8_tpu_torch import conditions
from rl8_tpu_torch import utils as tutils
from rl8_tpu_torch.data import TrainStatKey, TrainStats
from rl8_tpu_torch.env import DiscreteDummyEnv
from rl8_tpu_torch.parallel import is_main_process
from rl8_tpu_torch.trainers import GenericTrainerBase, JsonlRun, NoopRun
from rl8_tpu_torch.trainers import tracking

# --------------------------------------------------------------------------
# conditions


def _sequence(seed: int, n: int = 40) -> list[float]:
    """Values in runs of 1-7 moves of one kind: repeats, plateaus within
    1e-3, rises and falls."""
    rng = np.random.default_rng(seed)
    values = [0.0]
    while len(values) < n:
        move = rng.choice(["repeat", "plateau", "up", "down"])
        for _ in range(rng.integers(1, 8)):
            step = {"repeat": 0.0, "plateau": 1e-4 * rng.uniform(-1, 1), "up": rng.uniform(0.1, 1.0),
                    "down": -rng.uniform(0.1, 1.0)}[move]
            values.append(values[-1] + step * max(1.0, abs(values[-1])))
    return values


CONDITIONS = {
    "HitsLowerBound": lambda m: m.HitsLowerBound("returns/mean", -1.0),
    "HitsUpperBound": lambda m: m.HitsUpperBound("returns/mean", 1.5),
    "Plateaus": lambda m: m.Plateaus("returns/mean", patience=2, rtol=1e-3),
    "Plateaus-default": lambda m: m.Plateaus("returns/mean"),
    "StopsDecreasing": lambda m: m.StopsDecreasing("returns/mean", patience=2),
    "StopsIncreasing": lambda m: m.StopsIncreasing("returns/mean", patience=3),
    "And": lambda m: m.And([m.HitsUpperBound("algorithm/steps", 10), m.StopsIncreasing("returns/mean", patience=2)]),
}


@pytest.mark.parametrize("name", list(CONDITIONS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conditions_decide_as_jax(name: str, seed: int) -> None:
    jcond, tcond = CONDITIONS[name](jconditions), CONDITIONS[name](conditions)
    decisions = []
    for step, value in enumerate(_sequence(seed), 1):
        stats = {"returns/mean": value, "algorithm/steps": step}
        decisions.append(tcond(stats))
        assert decisions[-1] == jcond(stats), (step, value)
    # Every condition but the bounds both holds and fails somewhere.
    assert len(set(decisions)) == 2 or name.startswith("Hits")


def test_port_conditions_mirror_the_jax_ones() -> None:
    assert conditions.__all__ == jconditions.__all__
    assert conditions.HitsUpperBound("env/steps", 100)({"env/steps": 100})


# --------------------------------------------------------------------------
# host utilities


def test_reduce_stats_and_cumulative_average_match_jax() -> None:
    rng = np.random.default_rng(0)
    stats = {k: rng.normal(size=5).tolist() for k in ("returns/min", "returns/max", "returns/mean", "returns/std")}
    stats["env/steps"] = [64, 64, 64]
    assert tutils.reduce_stats(stats) == jutils.reduce_stats(stats)
    ca, jca = tutils.CumulativeAverage(), jutils.CumulativeAverage()
    for v in rng.normal(size=10):
        assert ca.update(float(v)) == jca.update(float(v))


def test_memory_stats() -> None:
    cpu = tutils.memory_stats("cpu")
    assert set(cpu) == set(jutils.memory_stats())
    assert 0 <= cpu["memory/percent"] <= 100 and isinstance(cpu["memory/total"], int)
    algo = AlgorithmConfig(num_envs=4, horizon=4, model_config={"hiddens": (8,)}, device="cpu").build(
        DiscreteDummyEnv
    )
    assert set(algo.memory_stats()) == set(cpu)


def test_memory_stats_without_psutil_and_on_the_card(monkeypatch) -> None:
    # psutil is optional: without it the CPU falls back to {}, as
    # rl8_tpu's does, and the CUDA branch never touches it.
    monkeypatch.setitem(sys.modules, "psutil", None)
    assert tutils.memory_stats("cpu") == {}
    calls = []

    def mem_get_info(device):
        calls.append(torch.device(device))
        return 1_000, 4_000

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    stats = tutils.memory_stats("cuda:0")
    assert stats == {"memory/free": 1_000, "memory/total": 4_000, "memory/percent": 75.0}
    assert calls == [torch.device("cuda:0")]


def test_is_main_process(monkeypatch) -> None:
    import torch.distributed as dist

    assert is_main_process()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert not is_main_process()
    # Off the main process a caller's run is replaced by a no-op one.
    trainer = GenericTrainerBase(StubAlgorithm(), run=RecordingRun())
    assert isinstance(trainer.tracking_run, NoopRun)
    trainer = GenericTrainerBase(StubAlgorithm(), run=RecordingRun(), log_all_processes=True)
    assert isinstance(trainer.tracking_run, RecordingRun)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    assert is_main_process()


def test_stat_typings_match_jax() -> None:
    import typing

    import rl8_tpu.data as jdata
    import rl8_tpu_torch.data as tdata

    assert typing.get_args(TrainStatKey) == typing.get_args(jdata.TrainStatKey)
    for name in ("TrainerState", "CollectStats", "EvalCollectStats", "MemoryStats", "StepStats", "TrainStats"):
        assert getattr(tdata, name).__annotations__.keys() == getattr(jdata, name).__annotations__.keys(), name
    assert set(TrainStats.__annotations__) >= set(typing.get_args(TrainStatKey))


# --------------------------------------------------------------------------
# run()'s cadence on a stub algorithm

NUM_ENVS, HORIZON = 4, 2
STEP_TRANSITIONS = NUM_ENVS * HORIZON
STOP_AT = 8


class StubAlgorithm:
    """Counter-only algorithm with the surface the trainers use."""

    params: dict[str, Any] = {"stub": True}

    def __init__(self, horizons_per_env_reset: int = 1) -> None:
        self.horizons_per_env_reset = horizons_per_env_reset
        self.collects = 0
        self.steps = 0
        self.eval_collects = 0
        self.env_configs: list[Any] = []

    def memory_stats(self) -> dict[str, float]:
        return {"memory/free": 1.0}

    def collect(self, *, env_config: None | dict[str, Any] = None, deterministic: bool = False) -> dict[str, float]:
        self.collects += 1
        self.env_configs.append((deterministic, env_config))
        if deterministic:
            self.eval_collects += 1
        return {"env/steps": float(STEP_TRANSITIONS), "returns/mean": float(self.collects)}

    def step(self) -> dict[str, float]:
        self.steps += 1
        return {"losses/total": float(self.steps)}

    def train_steps(self, num_steps: int, *, env_config: None | dict[str, Any] = None) -> list[dict[str, float]]:
        return [{**self.collect(env_config=env_config), **self.step()} for _ in range(num_steps)]


class RecordingRun:
    """Tracking backend recording what a trainer logs."""

    def __init__(self) -> None:
        self.params: list[dict] = []
        self.metrics: list[tuple[int, tuple[str, ...], Any]] = []

    def log_params(self, params, /) -> None:
        self.params.append(dict(params))

    def log_metrics(self, metrics, /, *, step: int) -> None:
        self.metrics.append((step, tuple(sorted(metrics)), type(step)))


def _drive(base: type, algo_kwargs: dict, run_kwargs: dict) -> dict:
    algo, run = StubAlgorithm(**algo_kwargs), RecordingRun()
    trainer = base(algo, run=run)
    try:
        stats = trainer.run(**run_kwargs)
    except (ValueError, RuntimeError) as e:
        return {"error": (type(e), str(e)), "collects": algo.collects}
    return {
        "stats": {k: (v, type(v)) for k, v in stats.items()},
        "state": dict(trainer.state),
        "logged": run.metrics,
        "params": run.params,
        "collects": algo.collects,
        "eval_collects": algo.eval_collects,
        "env_configs": algo.env_configs,
        "steps": algo.steps,
    }


@pytest.mark.parametrize("fused_steps", [None, 2, 4])
@pytest.mark.parametrize("steps_per_eval", [None, 2, 4])
def test_cadence_matches_jax(fused_steps, steps_per_eval) -> None:
    run_kwargs = dict(
        fused_steps=fused_steps,
        steps_per_eval=steps_per_eval,
        stop_conditions=None,
        env_config={"bounds": 1.0},
    )
    got = _drive(GenericTrainerBase, {}, {**run_kwargs, "stop_conditions": [conditions.HitsUpperBound(
        "algorithm/steps", STOP_AT)]})
    want = _drive(JGenericTrainerBase, {}, {**run_kwargs, "stop_conditions": [jconditions.HitsUpperBound(
        "algorithm/steps", STOP_AT)]})
    assert got == want
    if "error" in got:
        return
    assert got["state"] == {"algorithm/collects": got["collects"], "algorithm/steps": STOP_AT,
                            "env/steps": STOP_AT * STEP_TRANSITIONS}
    evals = [step for step, keys, _ in got["logged"] if "eval/returns/mean" in keys]
    assert evals == [s * STEP_TRANSITIONS for s in range(1, STOP_AT) if steps_per_eval and s % steps_per_eval == 0]
    assert all(kind is int for _, _, kind in got["logged"])


@pytest.mark.parametrize(
    "horizons_per_env_reset,run_kwargs",
    [
        (2, dict(steps_per_eval=1)),
        (2, dict(steps_per_eval=4, fused_steps=2)),
        (2, dict(steps_per_eval=2, eval_env_config={"bounds": 3.0})),
        (-1, dict(steps_per_eval=2, eval_env_config={"bounds": 3.0})),
        (-1, dict(steps_per_eval=3)),
        (1, dict(fused_steps=3, steps_per_eval=4)),
        (1, dict(fused_steps=2, steps_per_checkpoint=3)),
        (1, dict(steps_per_checkpoint=2)),
        (1, dict(async_checkpoints=True)),
        (1, dict(fused_steps=1, steps_per_eval=3)),
    ],
)
def test_validation_and_resets_match_jax(horizons_per_env_reset, run_kwargs) -> None:
    got = _drive(GenericTrainerBase, {"horizons_per_env_reset": horizons_per_env_reset},
                 {**run_kwargs, "stop_conditions": [conditions.HitsUpperBound("algorithm/steps", 6)]})
    want = _drive(JGenericTrainerBase, {"horizons_per_env_reset": horizons_per_env_reset},
                  {**run_kwargs, "stop_conditions": [jconditions.HitsUpperBound("algorithm/steps", 6)]})
    assert got == want


def test_eval_guards_match_jax() -> None:
    for base in (GenericTrainerBase, JGenericTrainerBase):
        trainer = base(StubAlgorithm(horizons_per_env_reset=2), run=RecordingRun())
        trainer.step()
        with pytest.raises(RuntimeError, match="boundary"):
            trainer.eval()
        trainer.step()
        assert set(trainer.eval()) == {"eval/env/steps", "eval/returns/mean"}
        trainer = base(StubAlgorithm(horizons_per_env_reset=-1), run=RecordingRun())
        trainer.step()
        with pytest.raises(ValueError, match="resets"):
            trainer.eval(env_config={"bounds": 1.0})


#: A tiny discrete config both packages build.
SMALL_KW = dict(num_envs=8, horizon=4, model_config={"hiddens": (8,)}, seed=7)


@pytest.mark.parametrize(
    "run_kwargs",
    [
        dict(checkpoint_dir="ckpt"),
        dict(checkpoint_dir="ckpt", steps_per_checkpoint=2),
        dict(checkpoint_dir="ckpt", async_checkpoints=True, resume=False),
        dict(checkpoint_dir="ckpt", checkpoint_on_preemption=False, fused_steps=2, steps_per_checkpoint=2),
    ],
)
def test_checkpoints_raise_before_any_collect(run_kwargs, tmp_path) -> None:
    """Each set of checkpoint options runs on both packages' trainers
    (4 steps, then a rerun to 6 that resumes when a checkpoint exists):
    the same generations, latest.json and counters; the trainer's own
    save and restore round trip."""
    import json
    import os

    layouts = []
    for name, make in (
        ("jax", lambda: JTrainer(JAlgorithmConfig(**SMALL_KW).build(JDiscreteDummyEnv))),
        ("torch", lambda: Trainer(AlgorithmConfig(**SMALL_KW, device="cpu").build(DiscreteDummyEnv))),
    ):
        ckpt = tmp_path / name
        kwargs = {**run_kwargs, "checkpoint_dir": ckpt}
        first = make()
        first.run(stop_conditions=[conditions.HitsUpperBound("algorithm/steps", 4)], **kwargs)
        rerun = make()
        rerun.run(stop_conditions=[conditions.HitsUpperBound("algorithm/steps", 6)], **kwargs)
        gens = sorted(e for e in os.listdir(ckpt) if e.startswith("ckpt-")) if ckpt.exists() else []
        latest = json.loads((ckpt / "latest.json").read_text()) if gens else None
        layouts.append((gens, latest, dict(first.state), dict(rerun.state)))
    assert layouts[0] == layouts[1]
    trainer = Trainer(AlgorithmConfig(**SMALL_KW, device="cpu").build(DiscreteDummyEnv))
    trainer.step()
    trainer.save_checkpoint(tmp_path / "manual")
    restored = Trainer(AlgorithmConfig(**SMALL_KW, device="cpu").build(DiscreteDummyEnv))
    restored.restore_checkpoint(tmp_path / "manual")
    assert restored.state == trainer.state == {"algorithm/collects": 1, "algorithm/steps": 1, "env/steps": 32}


def test_checkpoint_value_errors_come_first(tmp_path) -> None:
    """rl8_tpu's ValueErrors come before anything is collected or saved."""
    trainer = GenericTrainerBase(StubAlgorithm(), run=RecordingRun())
    with pytest.raises(ValueError, match="steps_per_checkpoint"):
        trainer.run(fused_steps=2, steps_per_checkpoint=3, checkpoint_dir=tmp_path)


def test_default_run_and_jsonl_run(tmp_path) -> None:
    import json

    assert isinstance(tracking.get_default_run(), NoopRun)
    run = JsonlRun(tmp_path / "track")
    tracking.set_default_run(run)
    try:
        trainer = GenericTrainerBase(StubAlgorithm())
        assert trainer.tracking_run is run
        trainer.run(stop_conditions=[conditions.HitsUpperBound("algorithm/steps", 2)])
    finally:
        tracking.set_default_run(NoopRun())
    assert json.loads((tmp_path / "track" / "params.json").read_text()) == {"stub": "True"}
    records = [json.loads(line) for line in (tmp_path / "track" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [8, 16]
    with pytest.raises(ModuleNotFoundError):
        tracking.MlflowRun()


# --------------------------------------------------------------------------
# Trainer and RecurrentTrainer on real algorithms

SMALL = dict(num_envs=16, horizon=8, horizons_per_env_reset=2)
RECURRENT = dict(seq_len=2, seqs_per_state_reset=4)


def _trainers(recurrent: bool) -> tuple[Any, Any]:
    if recurrent:
        jalgo = JRecurrentAlgorithmConfig(**SMALL, **RECURRENT, model_config={"hidden_size": 16})
        talgo = RecurrentAlgorithmConfig(**SMALL, **RECURRENT, model_config={"hidden_size": 16}, device="cpu")
        return (JRecurrentTrainer(jalgo.build(JDiscreteDummyEnv)),
                RecurrentTrainer(talgo.build(DiscreteDummyEnv)))
    jalgo = JAlgorithmConfig(**SMALL, model_config={"hiddens": (16,)})
    talgo = AlgorithmConfig(**SMALL, model_config={"hiddens": (16,)}, device="cpu")
    return JTrainer(jalgo.build(JDiscreteDummyEnv)), Trainer(talgo.build(DiscreteDummyEnv))


def _assert_like(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in ("algorithm/collects", "algorithm/steps", "env/steps"):
        if key in want:
            assert type(got[key]) is int and got[key] == want[key], key
    assert all(math.isfinite(v) for v in got.values())


@pytest.mark.parametrize("recurrent", [False, True], ids=["feedforward", "recurrent"])
def test_trainers_on_real_algorithms_match_jax(recurrent: bool) -> None:
    jtrainer, trainer = _trainers(recurrent)
    for t in (jtrainer, trainer):
        assert t.state == {"algorithm/collects": 0, "algorithm/steps": 0, "env/steps": 0}
    assert isinstance(trainer, RecurrentTrainer if recurrent else Trainer)
    # eval at startup, step, the off-boundary eval, step, eval.
    _assert_like(trainer.eval(), jtrainer.eval())
    _assert_like(trainer.step(), jtrainer.step())
    for t in (jtrainer, trainer):
        with pytest.raises(RuntimeError, match="boundary"):
            t.eval()
    _assert_like(trainer.step(), jtrainer.step())
    _assert_like(trainer.eval(), jtrainer.eval())
    # step_fused and run.
    fused, jfused = trainer.step_fused(2), jtrainer.step_fused(2)
    assert len(fused) == len(jfused) == 2
    for got, want in zip(fused, jfused):
        _assert_like(got, want)
    stats = trainer.run(steps_per_eval=2, stop_conditions=[conditions.HitsUpperBound("algorithm/steps", 8)])
    jstats = jtrainer.run(steps_per_eval=2, stop_conditions=[jconditions.HitsUpperBound("algorithm/steps", 8)])
    _assert_like(stats, jstats)
    assert trainer.state == jtrainer.state
    assert trainer.state["env/steps"] == 8 * SMALL["num_envs"] * SMALL["horizon"]


def test_new_modules_import_nothing_of_jax_examples_or_benchmarks() -> None:
    """The trainer surface and the example envs keep their own copies of
    what they need: no import of JAX, ``rl8_tpu``, ``examples`` or
    ``benchmarks`` (read from the source)."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / "rl8_tpu_torch"
    paths = [root / "conditions.py", root / "__main__.py", *(root / "trainers").glob("*.py")]
    for name in ("cartpole", "pendulum", "mountain_car"):
        paths += (root / "examples" / name).glob("*.py")
    assert len(paths) == 17
    for path in paths:
        roots = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots.update(alias.name.split(".")[0] for alias in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                roots.add(node.module.split(".")[0])
        assert not roots & {"jax", "jaxlib", "flax", "optax", "rl8_tpu", "examples", "benchmarks"}, path


@pytest.mark.parametrize(
    "module_name",
    [
        "rl8_tpu_torch.conditions",
        "rl8_tpu_torch.trainers._feedforward",
        "rl8_tpu_torch.trainers.config",
        "rl8_tpu_torch.examples.cartpole.env",
        "rl8_tpu_torch.examples.pendulum.env",
        "rl8_tpu_torch.examples.mountain_car.env",
    ],
)
def test_new_module_doctests(module_name: str) -> None:
    import doctest
    import importlib

    results = doctest.testmod(
        importlib.import_module(module_name), optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE
    )
    assert results.failed == 0
    assert results.attempted > 0
