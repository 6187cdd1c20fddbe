"""The port's checkpoints (``rl8_tpu_torch/checkpoint.py`` and the trainer's
checkpoint branch) on the CPU: the single-device cases of
``tests/test_checkpoint.py`` at 64 envs and horizon 8, a bit-exact resume
of every piece of state (parameters, Adam, buffer, env state with Python
values, every generator), and one case against ``rl8_tpu``: both
packages' saves lay out the same generations, ``latest.json`` and
``host_state.json`` keys and counters."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from typing import Any

import pytest
import torch

import rl8_tpu_torch.checkpoint as ck
from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig, Trainer
from rl8_tpu_torch.checkpoint import checkpoint_exists, restore_checkpoint, save_checkpoint
from rl8_tpu_torch.conditions import HitsUpperBound
from rl8_tpu_torch.env import ContinuousDummyEnv, DiscreteDummyEnv
from rl8_tpu_torch.examples.algotrading import AlgoTrading, AttentiveAlpaca, LazyLemur, MischievousMule
from rl8_tpu_torch.examples.cartpole import CartPole

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_envs=64, horizon=8, model_config={"hiddens": (8,)}, seed=7, device="cpu")
RCFG = dict(
    num_envs=64, horizon=8, seq_len=2, seqs_per_state_reset=2, model_config={"hidden_size": 8}, seed=7, device="cpu"
)

#: Every route whose state differs: the act kernel's, the module
#: rollout's (its sample generator), a continuous distribution, a custom
#: model with shuffled minibatches, an env state with Python values, the
#: recurrent algorithm, ``torch.optim`` optimizers (their state flat and
#: per leaf, gated by a KL stop), AMP on both algorithms (the module
#: routes, the recurrent one's sample generator), and the attention and
#: custom recurrent models (shared attention parameters; custom states).
MAKERS = {
    "discrete": lambda: AlgorithmConfig(**CFG).build(DiscreteDummyEnv),
    "module_rollout": lambda: AlgorithmConfig(**CFG, fused_act=False).build(DiscreteDummyEnv),
    "normal": lambda: AlgorithmConfig(**CFG).build(ContinuousDummyEnv),
    "mule": lambda: AlgorithmConfig(
        **{**CFG, "model_config": {"hiddens": (16, 16)}}, model_cls=MischievousMule, sgd_minibatch_size=128
    ).build(AlgoTrading),
    "cartpole": lambda: AlgorithmConfig(**{**CFG, "horizons_per_env_reset": 2}).build(CartPole),
    "recurrent": lambda: RecurrentAlgorithmConfig(**RCFG).build(DiscreteDummyEnv),
    "adamw": lambda: AlgorithmConfig(**CFG, optimizer_cls=torch.optim.AdamW).build(DiscreteDummyEnv),
    "sgd_per_leaf_kl": lambda: AlgorithmConfig(
        **CFG, optimizer_cls=torch.optim.SGD, optimizer_config={"lr": 1e-2, "momentum": 0.9},
        flatten_optimizer=False, target_kl_div=1e-4, entropy_coeff=0.01,
    ).build(DiscreteDummyEnv),
    "amp": lambda: AlgorithmConfig(**CFG, enable_amp=True).build(ContinuousDummyEnv),
    "recurrent_amp_adamw": lambda: RecurrentAlgorithmConfig(
        **RCFG, enable_amp=True, optimizer_cls=torch.optim.AdamW, flatten_optimizer=False
    ).build(DiscreteDummyEnv),
    "alpaca": lambda: AlgorithmConfig(
        **{**CFG, "num_envs": 16, "model_config": {"hiddens": (16, 16)}}, model_cls=AttentiveAlpaca,
        fused_forward=True, sgd_minibatch_size=64,
    ).build(AlgoTrading),
    "lemur": lambda: RecurrentAlgorithmConfig(
        **{**RCFG, "num_envs": 16, "model_config": {"hiddens": (16, 16), "hidden_size": 8}}, model_cls=LazyLemur,
        fused_forward=True, sgd_minibatch_size=16,
    ).build(AlgoTrading),
}


def _leaves(obj: Any, path: str = "state") -> dict[str, Any]:
    out: dict[str, Any] = {}
    if isinstance(obj, torch.Tensor):
        out[path] = obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(_leaves(getattr(obj, f.name), f"{path}.{f.name}"))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_leaves(v, f"{path}[{k}]"))
    else:
        out[path] = obj
    return out


def _snapshot(algo: Any) -> dict[str, Any]:
    """Every piece of an algorithm's dynamic state, by name."""
    out = _leaves(algo.state)
    out.update({f"model.{k}": v.clone() for k, v in algo.policy.model.state_dict().items()})
    out.update({f"gen.{k}": v.get_state() for k, v in vars(algo).items() if isinstance(v, torch.Generator)})
    out["coeffs"] = (algo.lr_scheduler.coeff, algo.entropy_scheduler.coeff)
    return out


def _assert_identical(a: dict[str, Any], b: dict[str, Any]) -> None:
    assert a.keys() == b.keys(), set(a) ^ set(b)
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert a[key].dtype == b[key].dtype and a[key].device == b[key].device, key
            assert torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


def _train(algo: Any, n: int) -> None:
    for _ in range(n):
        algo.collect()
        algo.step()


@pytest.mark.parametrize("name", list(MAKERS))
def test_checkpoint_round_trip_bit_exact(tmp_path, name) -> None:
    """Training resumed from a checkpoint matches uninterrupted training
    bit for bit, in every parameter, Adam state, buffer and env tensor,
    Python env value and generator state."""
    make = MAKERS[name]
    algo = make()
    _train(algo, 2)
    save_checkpoint(tmp_path / "ckpt", algo, trainer_state={"algorithm/steps": 2})
    _train(algo, 2)
    algo.collect()
    want = _snapshot(algo)

    resumed = make()
    assert restore_checkpoint(tmp_path / "ckpt", resumed) == {"algorithm/steps": 2}
    _train(resumed, 2)
    resumed.collect()
    _assert_identical(want, _snapshot(resumed))


def test_recurrent_checkpoint_round_trip(tmp_path) -> None:
    algo = RecurrentAlgorithmConfig(**RCFG).build(DiscreteDummyEnv)
    _train(algo, 1)
    save_checkpoint(tmp_path / "ckpt", algo)
    restored = RecurrentAlgorithmConfig(**RCFG).build(DiscreteDummyEnv)
    restore_checkpoint(tmp_path / "ckpt", restored)
    assert restored.state.horizons == 1
    assert restored.state.seqs == algo.state.seqs > 0
    assert type(restored.state.seqs) is int and restored.state.buffered is False


def test_restore_keeps_dtypes_and_the_restoring_device(tmp_path) -> None:
    algo = MAKERS["mule"]()
    algo.collect()
    save_checkpoint(tmp_path / "ckpt", algo)
    restored = MAKERS["mule"]()
    restore_checkpoint(tmp_path / "ckpt", restored)
    got, want = _snapshot(restored), _snapshot(algo)
    assert got["state.env_state[invested]"].dtype == torch.int32
    assert got["state.env_state[action_mask]"].dtype == torch.bool
    assert got["state.opt_state.count"].dtype == torch.int32
    assert restored.state.buffered is True
    _assert_identical(want, got)


def test_generators_of_another_device_kind_are_reseeded(tmp_path) -> None:
    """A CPU generator and a card generator run different algorithms, so a
    checkpoint from the other kind of device re-seeds the device
    generators from the saved state (deterministically) and moves the
    host key stream exactly."""
    algo = MAKERS["discrete"]()
    _train(algo, 1)
    save_checkpoint(tmp_path / "ckpt", algo)
    path = tmp_path / "ckpt" / "ckpt-00000001" / "state.pt"
    tree = torch.load(path, weights_only=True)
    for key in ("_env_gen", "_shuffle_gen"):
        tree["generators"][key]["device"] = "cuda"
    torch.save(tree, path)
    a, b = MAKERS["discrete"](), MAKERS["discrete"]()
    restore_checkpoint(tmp_path / "ckpt", a)
    restore_checkpoint(tmp_path / "ckpt", b)
    assert torch.equal(a._key_gen.get_state(), algo._key_gen.get_state())
    assert torch.equal(a._env_gen.get_state(), b._env_gen.get_state())
    assert not torch.equal(a._env_gen.get_state(), algo._env_gen.get_state())


def test_trainer_periodic_checkpoint_and_resume(tmp_path) -> None:
    """Trainer.run checkpoints every `steps_per_checkpoint`; a fresh
    trainer restores and continues with the same state."""

    def make():
        return Trainer(AlgorithmConfig(**CFG).build(DiscreteDummyEnv))

    trainer = make()
    trainer.run(
        stop_conditions=[HitsUpperBound("algorithm/steps", 4)],
        steps_per_checkpoint=2,
        checkpoint_dir=tmp_path / "ckpt",
    )
    assert trainer.state["algorithm/steps"] == 4
    assert sorted(e for e in os.listdir(tmp_path / "ckpt") if e.startswith("ckpt-")) == [
        "ckpt-00000001",
        "ckpt-00000002",
    ]
    resumed = make()
    resumed.restore_checkpoint(tmp_path / "ckpt")
    assert resumed.state == trainer.state
    _assert_identical(_snapshot(trainer.algorithm), _snapshot(resumed.algorithm))
    stats = resumed.run(stop_conditions=[HitsUpperBound("algorithm/steps", 6)])
    assert resumed.state["algorithm/steps"] == 6
    assert "losses/total" in stats


def test_trainer_run_auto_resumes_from_checkpoint_dir(tmp_path) -> None:
    """Re-running `run(checkpoint_dir=...)` picks up from the last
    checkpoint; a finished job does not train past its bound; and
    `resume=False` starts over."""

    def make():
        return Trainer(AlgorithmConfig(**CFG).build(DiscreteDummyEnv))

    ckpt = tmp_path / "ckpt"
    make().run(stop_conditions=[HitsUpperBound("algorithm/steps", 3)], steps_per_checkpoint=1, checkpoint_dir=ckpt)
    resumed = make()
    resumed.run(stop_conditions=[HitsUpperBound("algorithm/steps", 5)], steps_per_checkpoint=1, checkpoint_dir=ckpt)
    assert resumed.state["algorithm/steps"] == 5
    assert resumed.state["env/steps"] == 5 * 64 * 8

    done = make()
    stats = done.run(stop_conditions=[HitsUpperBound("algorithm/steps", 5)], steps_per_checkpoint=1, checkpoint_dir=ckpt)
    assert done.state["algorithm/steps"] == 5 and done.state["algorithm/collects"] == 5
    assert stats == done.state

    fresh = make()
    fresh.run(
        stop_conditions=[HitsUpperBound("algorithm/steps", 1)],
        steps_per_checkpoint=1,
        checkpoint_dir=ckpt,
        resume=False,
    )
    assert fresh.state["algorithm/steps"] == 1


def test_checkpoint_versioning_prunes_and_survives_partial_saves(tmp_path) -> None:
    """Saves are versioned with an atomically replaced latest.json: an
    interrupted save leaves resume on the last complete generation, and
    only two generations are kept."""
    algo = AlgorithmConfig(**CFG).build(DiscreteDummyEnv)
    _train(algo, 1)
    d = tmp_path / "ckpt"
    for step in (1, 2, 3):
        save_checkpoint(d, algo, trainer_state={"algorithm/steps": step})
    assert sorted(e for e in os.listdir(d) if e.startswith("ckpt-")) == ["ckpt-00000002", "ckpt-00000003"]
    assert not os.path.exists(d / "latest.json.tmp")

    # A preemption mid-save: a partial generation, latest.json unchanged.
    (d / "ckpt-00000004").mkdir()
    (d / "ckpt-00000004" / "state.pt.tmp").write_bytes(b"partial")
    assert checkpoint_exists(d)
    assert restore_checkpoint(d, AlgorithmConfig(**CFG).build(DiscreteDummyEnv)) == {"algorithm/steps": 3}

    # The next save replaces the debris with a fresh generation 4.
    save_checkpoint(d, algo, trainer_state={"algorithm/steps": 4})
    assert json.loads((d / "latest.json").read_text()) == {"checkpoint": "ckpt-00000004", "index": 4}
    assert sorted(os.listdir(d / "ckpt-00000004")) == ["host_state.json", "state.pt"]
    assert restore_checkpoint(d, AlgorithmConfig(**CFG).build(DiscreteDummyEnv)) == {"algorithm/steps": 4}


def test_async_checkpoint_defers_publish_and_round_trips(tmp_path) -> None:
    """``block=False`` snapshots the state and returns; training mutates
    the live state while the write runs; the generation publishes on
    :func:`wait_for_checkpoint`, and restore gives the save-time state."""
    algo = AlgorithmConfig(**CFG).build(DiscreteDummyEnv)
    _train(algo, 1)
    d = tmp_path / "ckpt"
    save_checkpoint(d, algo, trainer_state={"algorithm/steps": 1}, block=False)
    assert ck._PENDING is not None
    assert not (d / "latest.json").exists()
    saved = _snapshot(algo)
    _train(algo, 1)  # overlaps the background write
    ck.wait_for_checkpoint()
    assert ck._PENDING is None
    assert json.loads((d / "latest.json").read_text())["checkpoint"] == "ckpt-00000001"
    restored = AlgorithmConfig(**CFG).build(DiscreteDummyEnv)
    assert restore_checkpoint(d, restored) == {"algorithm/steps": 1}
    _assert_identical(saved, _snapshot(restored))


def test_back_to_back_async_saves_sequence_generations(tmp_path) -> None:
    """A second async save finishes and publishes the pending one first;
    restore sees the newest through its implicit wait."""
    algo = AlgorithmConfig(**CFG).build(DiscreteDummyEnv)
    _train(algo, 1)
    d = tmp_path / "ckpt"
    save_checkpoint(d, algo, trainer_state={"algorithm/steps": 1}, block=False)
    _train(algo, 1)
    save_checkpoint(d, algo, trainer_state={"algorithm/steps": 2}, block=False)
    restored = AlgorithmConfig(**CFG).build(DiscreteDummyEnv)
    assert restore_checkpoint(d, restored) == {"algorithm/steps": 2}
    assert restored.state.horizons == 2
    assert json.loads((d / "latest.json").read_text())["checkpoint"] == "ckpt-00000002"


def test_trainer_async_checkpoints_durable_after_run(tmp_path) -> None:
    """With ``async_checkpoints=True`` every checkpoint is published when
    run returns, and a fresh trainer resumes from the last."""

    def make():
        return Trainer(AlgorithmConfig(**CFG).build(DiscreteDummyEnv))

    trainer = make()
    trainer.run(
        stop_conditions=[HitsUpperBound("algorithm/steps", 4)],
        steps_per_checkpoint=2,
        checkpoint_dir=tmp_path / "ckpt",
        async_checkpoints=True,
    )
    assert ck._PENDING is None
    assert checkpoint_exists(tmp_path / "ckpt")
    resumed = make()
    resumed.restore_checkpoint(tmp_path / "ckpt")
    assert resumed.state == trainer.state


def test_async_save_is_published_at_interpreter_exit(tmp_path) -> None:
    """A process that exits with an async save in flight publishes it on
    the way out."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[2])\n"
        "from rl8_tpu_torch import AlgorithmConfig\n"
        "from rl8_tpu_torch.checkpoint import save_checkpoint\n"
        "from rl8_tpu_torch.env import DiscreteDummyEnv\n"
        "algo = AlgorithmConfig(num_envs=64, horizon=8, model_config={'hiddens': (8,)}, seed=7,"
        " device='cpu').build(DiscreteDummyEnv)\n"
        "algo.collect(); algo.step()\n"
        "save_checkpoint(sys.argv[1], algo, trainer_state={'algorithm/steps': 1}, block=False)\n"
    )
    d = tmp_path / "ckpt"
    subprocess.run([sys.executable, "-c", code, str(d), REPO], check=True, timeout=120)
    assert json.loads((d / "latest.json").read_text())["checkpoint"] == "ckpt-00000001"
    assert restore_checkpoint(d, AlgorithmConfig(**CFG).build(DiscreteDummyEnv)) == {"algorithm/steps": 1}


def test_wait_for_checkpoint_attributes_background_failure(tmp_path) -> None:
    """A failed async write surfaces as a RuntimeError naming the
    generation, the pending slot is cleared so later calls don't raise it
    again, and the unpublished generation does not count."""

    class Boom:
        def wait(self):
            raise OSError("disk full")

    assert ck._PENDING is None
    ck._PENDING = (Boom(), str(tmp_path), "ckpt-00000001", 1)
    with pytest.raises(RuntimeError, match="ckpt-00000001") as info:
        ck.wait_for_checkpoint()
    assert isinstance(info.value.__cause__, OSError)
    assert ck._PENDING is None
    ck.wait_for_checkpoint()
    assert not checkpoint_exists(tmp_path)


def test_background_write_failure_keeps_the_previous_generation(tmp_path, monkeypatch) -> None:
    algo = AlgorithmConfig(**CFG).build(DiscreteDummyEnv)
    _train(algo, 1)
    d = tmp_path / "ckpt"
    save_checkpoint(d, algo, trainer_state={"algorithm/steps": 1})

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", fail)
    save_checkpoint(d, algo, trainer_state={"algorithm/steps": 2}, block=False)
    with pytest.raises(RuntimeError, match="ckpt-00000002"):
        ck.wait_for_checkpoint()
    monkeypatch.undo()
    assert restore_checkpoint(d, AlgorithmConfig(**CFG).build(DiscreteDummyEnv)) == {"algorithm/steps": 1}


def test_checkpoint_exists_agree_single_process(tmp_path) -> None:
    assert not checkpoint_exists(tmp_path / "ckpt", agree=True)
    assert not checkpoint_exists(tmp_path / "ckpt")
    algo = AlgorithmConfig(**CFG).build(DiscreteDummyEnv)
    _train(algo, 1)
    save_checkpoint(tmp_path / "ckpt", algo)
    assert checkpoint_exists(tmp_path / "ckpt", agree=True)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "empty", algo)


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(steps_per_checkpoint=2), "steps_per_checkpoint"),
        (dict(async_checkpoints=True), "async_checkpoints"),
        (dict(fused_steps=2, steps_per_checkpoint=3, checkpoint_dir="ckpt"), "fused_steps"),
    ],
)
def test_options_that_require_a_directory(tmp_path, kwargs, match) -> None:
    algo = AlgorithmConfig(**CFG).build(DiscreteDummyEnv)
    with pytest.raises(ValueError, match=match):
        Trainer(algo).run(**kwargs)
    assert algo.state.horizons == 0


@pytest.mark.parametrize("url", ["gs://bucket/run", "s3://bucket/run", "az://container/run"])
def test_object_store_urls_raise(url) -> None:
    algo = AlgorithmConfig(**CFG).build(DiscreteDummyEnv)
    for call in (
        lambda: save_checkpoint(url, algo),
        lambda: restore_checkpoint(url, algo),
        lambda: checkpoint_exists(url),
    ):
        with pytest.raises(ValueError, match="object-store URL"):
            call()


def test_unsupported_state_values_raise_at_save(tmp_path) -> None:
    algo = AlgorithmConfig(**CFG).build(DiscreteDummyEnv)
    algo.collect()
    algo.state.env_state["handle"] = object()
    with pytest.raises(TypeError, match="handle"):
        save_checkpoint(tmp_path / "ckpt", algo)


def test_generations_and_host_state_match_jax(tmp_path) -> None:
    """Equivalent algorithms of both packages, saved twice each, lay out
    the same generation names, the same latest.json and the same
    host_state.json keys and counters."""
    from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
    from rl8_tpu.checkpoint import save_checkpoint as jsave_checkpoint
    from rl8_tpu.env import DiscreteDummyEnv as JDiscreteDummyEnv

    jcfg = {k: v for k, v in CFG.items() if k != "device"}
    jalgo = JAlgorithmConfig(**jcfg).build(JDiscreteDummyEnv)
    talgo = AlgorithmConfig(**CFG).build(DiscreteDummyEnv)
    for algo, save, d in ((jalgo, jsave_checkpoint, tmp_path / "jax"), (talgo, save_checkpoint, tmp_path / "torch")):
        for step in (1, 2, 3):
            algo.collect()
            algo.step()
            save(d, algo, trainer_state={"algorithm/steps": step, "env/steps": step * 512})
    jgens, tgens = (sorted(e for e in os.listdir(tmp_path / p) if e.startswith("ckpt-")) for p in ("jax", "torch"))
    assert jgens == tgens == ["ckpt-00000002", "ckpt-00000003"]
    assert (tmp_path / "jax" / "latest.json").read_text() == (tmp_path / "torch" / "latest.json").read_text()
    for gen in tgens:
        jhost, thost = (json.loads((tmp_path / p / gen / "host_state.json").read_text()) for p in ("jax", "torch"))
        assert jhost == thost
        assert set(thost) == {"horizons_host", "lr_coeff", "entropy_coeff", "trainer_state"}
