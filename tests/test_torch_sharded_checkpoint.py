"""Multi-process checkpoints and preemption on the CPU (two spawned gloo
processes): a checkpoint of a mesh of two restores bit for bit onto two
processes and onto one, and one process's onto two; the stale
``latest.json`` view of one process follows process 0 (as
``tests/test_multihost.py::test_multihost_stale_latest_view_follows_process_zero``
holds ``rl8_tpu``); a failed write on one process fails the save on
both; ``preempted()`` answers for every process, and ``Trainer.run``
saves on both processes and returns when one is signalled."""

from __future__ import annotations

import json
import os
import signal
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import rl8_tpu_torch.checkpoint as ck
import rl8_tpu_torch.parallel as tp
from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig, Trainer
from rl8_tpu_torch.conditions import HitsUpperBound
from rl8_tpu_torch.env import DiscreteDummyEnv
from rl8_tpu_torch.preemption import PreemptionMonitor
from tests.test_torch_checkpoint import _assert_identical, _snapshot, _train
from tests.test_torch_parallel import join_group, spawn_pair

NUM_ENVS = 16
MAKERS = {
    "discrete": lambda mesh: AlgorithmConfig(
        num_envs=NUM_ENVS, horizon=4, model_config={"hiddens": (8,)}, seed=7, device="cpu", mesh=mesh,
        sgd_minibatch_size=32,
    ).build(DiscreteDummyEnv),
    "recurrent": lambda mesh: RecurrentAlgorithmConfig(
        num_envs=NUM_ENVS, horizon=4, seq_len=2, seqs_per_state_reset=2, model_config={"hidden_size": 8}, seed=7,
        device="cpu", mesh=mesh,
    ).build(DiscreteDummyEnv),
}
#: Device generators (per process in shard_map mode); the host key stream
#: is replicated.
DEVICE_GENERATORS = ("gen._env_gen", "gen._shuffle_gen")
#: Fields that shard, by their snapshot names' prefixes, with the batch
#: axis.
SHARDED = {"state.env_state[position]": 0, "state.buffer[": 1}


def _axis(key: str) -> None | int:
    return next((axis for prefix, axis in SHARDED.items() if key.startswith(prefix)), None)


def _mid_run(kind: str, mesh) -> object:
    """An algorithm one step into training with a fresh rollout buffered,
    so the checkpoint holds a full buffer and a moved env state."""
    algo = MAKERS[kind](mesh)
    _train(algo, 1)
    algo.collect()
    return algo


def _worker(rank: int, rdzv: str, tmp: str) -> None:
    join_group(rank, rdzv)
    try:
        mesh = tp.create_mesh()
        out: dict = {}
        for kind in MAKERS:
            algo = _mid_run(kind, mesh)
            d = f"{tmp}/{kind}-2"
            ck.save_checkpoint(d, algo, trainer_state={"algorithm/steps": 1})
            out[f"saved/{kind}"] = _snapshot(algo)
            restored = MAKERS[kind](mesh)
            assert ck.restore_checkpoint(d, restored) == {"algorithm/steps": 1}
            _assert_identical(_snapshot(restored), out[f"saved/{kind}"])
            algo.step()
            restored.step()
            _assert_identical(_snapshot(restored), _snapshot(algo))
            # The one-process checkpoint the test wrote, onto this mesh.
            restored = MAKERS[kind](mesh)
            ck.restore_checkpoint(f"{tmp}/{kind}-1", restored)
            out[f"from_one/{kind}"] = _snapshot(restored)

        # A stale view of latest.json on rank 1 follows rank 0.
        d = f"{tmp}/stale"
        trainer = Trainer(MAKERS["discrete"](mesh))
        trainer.step()
        trainer.save_checkpoint(d)
        latest = ck._latest
        if rank == 1:
            ck._latest = lambda directory: None
        local, agreed = ck.checkpoint_exists(d), ck.checkpoint_exists(d, agree=True)
        trainer.restore_checkpoint(d)
        restored = dict(trainer.state)
        trainer.step()
        trainer.save_checkpoint(d)
        ck._latest = latest
        out["stale"] = {"local": local, "agreed": agreed, "restored": restored}

        # A failed write on rank 1 fails the save on both.
        save = torch.save

        def failing(obj, path, *args, **kwargs):
            if "shard-00001" in str(path):
                raise OSError("disk full")
            return save(obj, path, *args, **kwargs)

        torch.save = failing
        try:
            trainer.save_checkpoint(d)
        except (OSError, RuntimeError) as e:
            out["failed_write"] = type(e).__name__
        finally:
            torch.save = save

        # preempted() answers for every process.
        monitor = PreemptionMonitor()
        before = monitor.preempted()
        if rank == 1:
            monitor.request()
        out["preempted"] = (before, monitor.preempted(), monitor.local_flag)

        # SIGTERM to rank 1 in step 2: both save at the next boundary and return.
        class SigtermRank1:
            def __call__(self, stats) -> bool:
                if rank == 1 and stats["algorithm/steps"] == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return False

        stats = Trainer(MAKERS["discrete"](mesh)).run(
            stop_conditions=[SigtermRank1(), HitsUpperBound("algorithm/steps", 12)], checkpoint_dir=f"{tmp}/preempt"
        )
        out["preempt_steps"] = int(stats["algorithm/steps"])
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> tuple[Path, list[dict], dict]:
    tmp = tmp_path_factory.mktemp("sharded-ckpt")
    one = {}
    for kind in MAKERS:
        algo = _mid_run(kind, None)
        ck.save_checkpoint(tmp / f"{kind}-1", algo)
        one[kind] = _snapshot(algo)
    spawn_pair(_worker, tmp, str(tmp))
    return tmp, [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)], one


@pytest.mark.parametrize("kind", list(MAKERS))
def test_two_process_checkpoint_layout(ranks, kind: str) -> None:
    """Process 0 writes ``host_state.json`` and ``state.pt``, each process
    its shard; ``latest.json`` points at the generation."""
    tmp = ranks[0]
    assert sorted(os.listdir(tmp / f"{kind}-2" / "ckpt-00000001")) == [
        "host_state.json", "shard-00000-of-00002.pt", "shard-00001-of-00002.pt", "state.pt",
    ]
    assert json.loads((tmp / f"{kind}-2" / "latest.json").read_text()) == {"checkpoint": "ckpt-00000001", "index": 1}


@pytest.mark.parametrize("kind", list(MAKERS))
def test_two_process_checkpoint_restores_onto_one_process(ranks, kind: str) -> None:
    """Onto one process the saved shards join along their batch axes: every
    tensor equals the two processes' states laid side by side (replicated
    ones equal to process 0's), and the device generators continue process
    0's streams."""
    tmp, saved, _ = ranks
    algo = MAKERS[kind](None)
    ck.restore_checkpoint(tmp / f"{kind}-2", algo)
    got = _snapshot(algo)
    a, b = saved[0][f"saved/{kind}"], saved[1][f"saved/{kind}"]
    assert got.keys() == a.keys()
    for key, want in a.items():
        axis = _axis(key)
        if axis is not None:
            want = torch.cat([want, b[key]], dim=axis)
        elif isinstance(want, torch.Tensor) and key not in DEVICE_GENERATORS:
            assert torch.equal(want, b[key]), key
        if isinstance(want, torch.Tensor):
            assert torch.equal(got[key], want), key
        else:
            assert got[key] == want, key


@pytest.mark.parametrize("kind", list(MAKERS))
def test_one_process_checkpoint_restores_onto_two_processes(ranks, kind: str) -> None:
    """Onto a mesh of two each process keeps its rows of the saved state;
    process 0 continues the saved device streams and process 1 gets its
    own, derived from them."""
    _, got, one = ranks
    for rank in range(2):
        state = got[rank][f"from_one/{kind}"]
        for key, want in one[kind].items():
            axis = _axis(key)
            if axis is not None:
                want = want.narrow(axis, rank * NUM_ENVS // 2, NUM_ENVS // 2)
            if key in DEVICE_GENERATORS and rank == 1:
                assert not torch.equal(state[key], want), key
            elif isinstance(want, torch.Tensor):
                assert torch.equal(state[key], want), key
            else:
                assert state[key] == want, key


def test_stale_latest_view_follows_process_zero(ranks) -> None:
    tmp, got, _ = ranks
    assert got[0]["stale"]["local"] is True and got[1]["stale"]["local"] is False
    assert got[0]["stale"]["agreed"] is got[1]["stale"]["agreed"] is True
    assert got[0]["stale"]["restored"] == got[1]["stale"]["restored"]
    assert got[0]["stale"]["restored"]["algorithm/steps"] == 1
    # The next save followed process 0's index: generation 2.
    assert json.loads((tmp / "stale" / "latest.json").read_text())["checkpoint"] == "ckpt-00000002"


def test_a_failed_write_on_one_process_fails_the_save_on_both(ranks) -> None:
    tmp, got, _ = ranks
    assert got[0]["failed_write"] == "RuntimeError"  # a peer's write failed
    assert got[1]["failed_write"] == "OSError"  # its own
    assert json.loads((tmp / "stale" / "latest.json").read_text())["checkpoint"] == "ckpt-00000002"


def test_preempted_answers_for_every_process(ranks) -> None:
    _, got, _ = ranks
    assert got[0]["preempted"] == (False, True, False)
    assert got[1]["preempted"] == (False, True, True)


def test_sigterm_to_one_process_saves_on_both_and_returns(ranks) -> None:
    """The signal lands in step 2's stop check; both processes act on it at
    the next step boundary, after step 3, as ``rl8_tpu``'s do
    (``tests/test_multihost.py::test_multihost_preemption_checkpoints_both_processes``)."""
    tmp, got, _ = ranks
    assert got[0]["preempt_steps"] == got[1]["preempt_steps"] == 3
    latest = json.loads((tmp / "preempt" / "latest.json").read_text())["checkpoint"]
    host = json.loads((tmp / "preempt" / latest / "host_state.json").read_text())
    assert host["trainer_state"]["algorithm/steps"] == 3
    assert sorted(p for p in os.listdir(tmp / "preempt" / latest) if p.startswith("shard")) == [
        "shard-00000-of-00002.pt", "shard-00001-of-00002.pt",
    ]
