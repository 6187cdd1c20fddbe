"""The port's preemption handling (``rl8_tpu_torch/preemption.py`` and
``Trainer.run``'s final checkpoint on SIGTERM), the cases of
``tests/test_preemption.py`` on the CPU, with ``rl8_tpu``'s monitor beside
the port's where both answer the same question."""

import os
import signal
import threading
import time
import warnings

import pytest

from rl8_tpu.preemption import PreemptionMonitor as JPreemptionMonitor
from rl8_tpu_torch import AlgorithmConfig, Trainer
from rl8_tpu_torch.checkpoint import checkpoint_exists
from rl8_tpu_torch.conditions import HitsUpperBound
from rl8_tpu_torch.env import DiscreteDummyEnv
from rl8_tpu_torch.preemption import PreemptionMonitor

MONITORS = {"torch": PreemptionMonitor, "jax": JPreemptionMonitor}


def _wait_flag(monitor, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not monitor.local_flag and time.monotonic() < deadline:
        time.sleep(0.01)
    return monitor.local_flag


@pytest.mark.parametrize("package", list(MONITORS))
def test_monitor_latches_sigterm_chains_and_restores_handler(package):
    prev = signal.getsignal(signal.SIGTERM)
    chained = []

    def outer(signum, frame):
        chained.append(signum)

    signal.signal(signal.SIGTERM, outer)
    try:
        with MONITORS[package]() as monitor:
            assert not monitor.preempted()
            os.kill(os.getpid(), signal.SIGTERM)
            assert _wait_flag(monitor)
            assert monitor.preempted()
            assert chained == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM) is outer
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_monitor_request_without_signal():
    monitor = PreemptionMonitor()
    assert not monitor.preempted()
    monitor.request()
    assert monitor.preempted() and monitor.local_flag


def test_uninstall_warns_when_the_previous_handler_is_not_pythons(monkeypatch):
    prev = signal.getsignal(signal.SIGTERM)
    monitor = PreemptionMonitor()
    monitor.install()
    monitor._prev = None  # as signal.signal reports a handler set from C
    try:
        with pytest.warns(RuntimeWarning, match="SIG_DFL"):
            monitor.uninstall()
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    finally:
        signal.signal(signal.SIGTERM, prev)


class _SigtermAtStep:
    """Never-stopping condition that delivers a real SIGTERM to this
    process when the step counter reaches ``at_step``."""

    def __init__(self, at_step: int) -> None:
        self.at_step = at_step

    def __call__(self, train_stats) -> bool:
        if train_stats["algorithm/steps"] == self.at_step:
            os.kill(os.getpid(), signal.SIGTERM)
        return False


def _build_trainer():
    algorithm = AlgorithmConfig(
        num_envs=64, horizon=8, seed=3, num_sgd_iters=1, model_config={"hiddens": (8, 8)}, device="cpu"
    ).build(DiscreteDummyEnv)
    return Trainer(algorithm)


def test_run_checkpoints_and_returns_on_sigterm(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    ckpt_dir = tmp_path / "ckpt"
    trainer = _build_trainer()
    stats = trainer.run(
        stop_conditions=[_SigtermAtStep(2), HitsUpperBound("algorithm/steps", 10)],
        checkpoint_dir=ckpt_dir,
    )
    # The signal landed while step 2's stop conditions ran; the run acted
    # on it at the next step boundary, saved and returned.
    assert stats["algorithm/steps"] == 3
    assert checkpoint_exists(ckpt_dir)
    assert signal.getsignal(signal.SIGTERM) == prev

    # Rerunning resumes from the preemption checkpoint; the restored
    # counters already meet the bound, so nothing trains past it.
    restarted = _build_trainer()
    resumed = restarted.run(stop_conditions=[HitsUpperBound("algorithm/steps", 3)], checkpoint_dir=ckpt_dir)
    assert resumed["algorithm/steps"] == 3
    assert restarted.state["algorithm/steps"] == 3
    # A longer bound continues from the restored counters.
    restarted.run(stop_conditions=[HitsUpperBound("algorithm/steps", 5)], checkpoint_dir=ckpt_dir)
    assert restarted.state["algorithm/steps"] == 5
    assert restarted.state["env/steps"] == 5 * 64 * 8


def test_run_preemption_with_fused_steps(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    ckpt_dir = tmp_path / "ckpt"
    trainer = _build_trainer()
    stats = trainer.run(
        stop_conditions=[_SigtermAtStep(2), HitsUpperBound("algorithm/steps", 20)],
        checkpoint_dir=ckpt_dir,
        fused_steps=2,
    )
    # The preemption check runs between fused batches.
    assert stats["algorithm/steps"] in (2, 4)
    assert checkpoint_exists(ckpt_dir)
    assert signal.getsignal(signal.SIGTERM) == prev


def test_preemption_skips_pending_eval(tmp_path):
    """A latched SIGTERM is acted on before an eval starts."""
    prev = signal.getsignal(signal.SIGTERM)
    ckpt_dir = tmp_path / "ckpt"
    trainer = _build_trainer()
    trainer.run(
        stop_conditions=[_SigtermAtStep(1), HitsUpperBound("algorithm/steps", 10)],
        checkpoint_dir=ckpt_dir,
        steps_per_eval=1,
    )
    assert trainer.state["algorithm/collects"] == trainer.state["algorithm/steps"]
    assert checkpoint_exists(ckpt_dir)
    assert signal.getsignal(signal.SIGTERM) == prev


def test_no_preemption_checkpoint_leaves_sigterm_alone(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    seen = []

    class Check:
        def __call__(self, stats):
            seen.append(signal.getsignal(signal.SIGTERM))
            return stats["algorithm/steps"] >= 2

    _build_trainer().run(stop_conditions=[Check()], checkpoint_dir=tmp_path / "ckpt", checkpoint_on_preemption=False)
    assert seen == [prev, prev]


@pytest.mark.parametrize("package", list(MONITORS))
def test_install_off_main_thread_warns(package):
    """install() off the main thread can't register a handler; it says so
    and leaves request() usable."""
    monitor = MONITORS[package]()
    caught: list = []

    def target():
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            monitor.install()
            caught.extend(w)
        monitor.request()

    t = threading.Thread(target=target)
    t.start()
    t.join()
    assert any("NOT trigger a final checkpoint" in str(w.message) for w in caught)
    assert not monitor._installed
    assert monitor.preempted()


def test_counters_stay_ints(tmp_path):
    """env/steps stays an int through step, step_fused and restore."""
    trainer = _build_trainer()
    trainer.step()
    trainer.step_fused(2)
    assert type(trainer.state["env/steps"]) is int
    trainer.save_checkpoint(tmp_path / "ckpt")
    restarted = _build_trainer()
    restarted.restore_checkpoint(tmp_path / "ckpt")
    assert type(restarted.state["env/steps"]) is int
    assert restarted.state == trainer.state
