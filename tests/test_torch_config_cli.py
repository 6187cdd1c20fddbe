"""The port's ``TrainConfig`` and ``train`` CLI (``rl8_tpu_torch/trainers/
config.py``, ``rl8_tpu_torch/__main__.py``) on the CPU: loading YAML and
JSON configs (JSON without PyYAML), the dotted imports and their errors,
``_import``'s nested-dependency rule beside ``rl8_tpu``'s, the CLI's
metric lines against ``rl8_tpu``'s CLI at the same config, and the
checkpoint and export options against ``rl8_tpu``'s CLI."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from rl8_tpu.__main__ import main as jmain
from rl8_tpu.trainers.config import _import as _jimport
from rl8_tpu_torch import RecurrentTrainer, TrainConfig, Trainer
from rl8_tpu_torch.__main__ import main
from rl8_tpu_torch.distributions import Categorical
from rl8_tpu_torch.env import DiscreteDummyEnv
from rl8_tpu_torch.examples.cartpole import CartPole
from rl8_tpu_torch.trainers.config import _import
from rl8_tpu_torch.trainers.tracking import NoopRun, set_default_run

REPO = Path(__file__).resolve().parent.parent
SMALL = {"horizon": 4, "num_envs": 8, "model_config": {"hiddens": [8]}}


@pytest.fixture(autouse=True)
def _restore_default_run():
    yield
    set_default_run(NoopRun())


def _write(tmp_path: Path, data: dict, suffix: str = ".json") -> str:
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / f"config{suffix}"
    if suffix == ".json":
        path.write_text(json.dumps(data))
    else:
        import yaml

        path.write_text(yaml.safe_dump(data))
    return str(path)


def _port_config(**algorithm_config) -> dict:
    return {
        "env_cls": "rl8_tpu_torch.env.DiscreteDummyEnv",
        "algorithm_config": {**SMALL, "device": "cpu", **algorithm_config},
    }


@pytest.mark.parametrize("suffix", [".yaml", ".yml", ".json"])
def test_train_config_from_file(tmp_path, suffix) -> None:
    path = _write(tmp_path, _port_config(gamma=1, distribution_cls="rl8_tpu_torch.distributions.Categorical"),
                  suffix)
    config = TrainConfig.from_file(path)
    assert config.env_cls is DiscreteDummyEnv
    assert config.algorithm_config["distribution_cls"] is Categorical
    trainer = config.build()
    assert isinstance(trainer, Trainer)
    assert trainer.algorithm.hparams.gamma == 1 and trainer.algorithm.hparams.horizon == 4
    assert trainer.algorithm.device.type == "cpu"


@pytest.mark.parametrize("recurrent", [False, True], ids=["feedforward", "recurrent"])
def test_cli_trains_with_an_optimizer_class_and_amp(tmp_path, recurrent: bool) -> None:
    """A YAML config naming ``optimizer_cls: torch.optim.AdamW`` (with
    torch's keywords) and ``enable_amp: true`` builds through the dotted
    import and trains a step through the ``train`` CLI; the tracked params
    name the optimizer class and AMP."""
    algorithm_config = {
        "optimizer_cls": "torch.optim.AdamW",
        "optimizer_config": {"lr": 3e-4, "weight_decay": 1e-4},
        "enable_amp": True,
        "flatten_optimizer": False,
    }
    data = _port_config(**algorithm_config)
    if recurrent:
        data["recurrent"] = True
        data["algorithm_config"].update(seq_len=2, seqs_per_state_reset=2, model_config={"hidden_size": 8})
    path = _write(tmp_path, data, ".yaml")
    import torch

    algo = TrainConfig.from_file(path).build().algorithm
    assert algo.policy.model.dtype is torch.bfloat16
    assert isinstance(algo._torch_optimizer.optimizer, torch.optim.AdamW)
    assert main(["train", "-f", path, "--max-steps", "1", "--track-dir", str(tmp_path / "track")]) == 0
    params = json.loads((tmp_path / "track" / "params.json").read_text())
    assert params["optimizer_cls"] == "AdamW" and params["enable_amp"] == "True"
    record = _records(tmp_path / "track")[-1]
    assert record["algorithm/steps"] == 1


def test_train_config_recurrent_and_example_env(tmp_path) -> None:
    data = {
        "env_cls": "rl8_tpu_torch.examples.cartpole.env.CartPole",
        "recurrent": True,
        "algorithm_config": {"horizon": 4, "num_envs": 8, "seq_len": 2, "seqs_per_state_reset": 2,
                             "model_config": {"hidden_size": 8}, "device": "cpu"},
    }
    trainer = TrainConfig.from_file(_write(tmp_path, data, ".yaml")).build()
    assert isinstance(trainer, RecurrentTrainer)
    assert isinstance(trainer.algorithm.env, CartPole)
    assert trainer.step()["algorithm/steps"] == 1


def test_train_config_defaults_to_the_card(tmp_path) -> None:
    config = TrainConfig.from_file(_write(tmp_path, {"env_cls": "rl8_tpu_torch.env.DiscreteDummyEnv"}))
    assert config.algorithm_config == {} and config.recurrent is False
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            config.build()


def test_json_config_loads_without_yaml(tmp_path, monkeypatch) -> None:
    monkeypatch.setitem(sys.modules, "yaml", None)
    trainer = TrainConfig.from_file(_write(tmp_path, _port_config())).build()
    assert isinstance(trainer, Trainer)
    (tmp_path / "config.yaml").write_text("env_cls: rl8_tpu_torch.env.DiscreteDummyEnv\n")
    with pytest.raises(ImportError):
        TrainConfig.from_file(tmp_path / "config.yaml")


def test_cli_runs_without_yaml_psutil_or_mlflow(tmp_path) -> None:
    """The optional packages (and JAX) blocked in a fresh interpreter: the
    CLI trains from a JSON config and logs (no memory stats on the CPU
    without psutil, as rl8_tpu logs none there)."""
    config = _write(tmp_path, _port_config())
    code = (
        "import sys\n"
        "for name in ('yaml', 'psutil', 'mlflow', 'jax', 'rl8_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from rl8_tpu_torch.__main__ import main\n"
        f"sys.exit(main(['train', '-f', {config!r}, '--max-steps', '2', '--track-dir', {str(tmp_path / 't')!r}]))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    records = [json.loads(line) for line in (tmp_path / "t" / "metrics.jsonl").read_text().splitlines()]
    assert [r["algorithm/steps"] for r in records] == [1, 2]
    assert not any(k.startswith("memory/") for k in records[0])


def test_train_config_errors(tmp_path) -> None:
    for text, error, match in (
        ("# just a comment\n", RuntimeError, "mapping"),
        ("algorithm_config: {}\n", RuntimeError, "env_cls"),
        ("env_cls: not.a.real.Env\n", ImportError, "not.a.real.Env"),
        ("env_cls: rl8_tpu_torch.env.NotAnEnv\n", ImportError, "NotAnEnv"),
    ):
        path = tmp_path / "config.yaml"
        path.write_text(text)
        with pytest.raises(error, match=match):
            TrainConfig.from_file(path)
    path = tmp_path / "config.toml"
    path.write_text("")
    with pytest.raises(ValueError, match="JSON or YAML"):
        TrainConfig.from_file(path)


def _package(tmp_path: Path, name: str, files: dict[str, str]) -> None:
    for rel, text in files.items():
        path = tmp_path / name / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    for mod in list(sys.modules):
        if mod.split(".")[0] == name:
            del sys.modules[mod]


@pytest.mark.parametrize("importer", [_import, _jimport], ids=["port", "jax"])
def test_import_rules_match_jax(tmp_path, monkeypatch, importer) -> None:
    monkeypatch.syspath_prepend(str(tmp_path))
    _package(tmp_path, "cfgpkg", {"__init__.py": "", "sub/__init__.py": "", "sub/mod.py": "class Thing:\n    pass\n"})
    assert importer("cfgpkg.sub.mod.Thing").__name__ == "Thing"
    for name in ("cfgpkg.sub.mod.Missing", "cfgpkg.nope.mod.Thing", "definitely_not_a_pkg"):
        with pytest.raises(ImportError, match="Could not dynamically import"):
            importer(name)
    # A missing dependency inside a located module surfaces as-is.
    _package(tmp_path, "badpkg", {"__init__.py": "import definitely_not_a_real_pkg\n"})
    with pytest.raises(ModuleNotFoundError, match="definitely_not_a_real_pkg"):
        importer("badpkg.Thing")
    # ...on component boundaries: "pkg.submodule" failing on a missing
    # "pkg.sub" is a dependency error, not a prefix miss.
    _package(tmp_path, "bndpkg", {"__init__.py": "", "submodule.py": "import bndpkg.sub\n"})
    with pytest.raises(ModuleNotFoundError, match="bndpkg.sub"):
        importer("bndpkg.submodule.Thing")


# --------------------------------------------------------------------------
# the CLI


def _records(track_dir: Path) -> list[dict]:
    return [json.loads(line) for line in (track_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize(
    "flags",
    [
        ["--max-steps", "4", "--steps-per-eval", "2"],
        ["--max-steps", "4", "--fused-steps", "2", "--steps-per-eval", "2"],
    ],
    ids=["steps-per-eval", "fused-steps"],
)
def test_cli_logs_what_the_jax_cli_logs(tmp_path, flags) -> None:
    jconfig = {"env_cls": "rl8_tpu.env.DiscreteDummyEnv", "algorithm_config": SMALL}
    rc = jmain(["train", "-f", _write(tmp_path / "j", jconfig), "--track-dir", str(tmp_path / "jt"), *flags])
    assert rc == 0
    rc = main(["train", "-f", _write(tmp_path / "t", _port_config()), "--track-dir", str(tmp_path / "tt"), *flags])
    assert rc == 0
    got, want = _records(tmp_path / "tt"), _records(tmp_path / "jt")
    assert len(got) == len(want) == 5  # four steps and the eval after the second
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("algorithm/collects", "algorithm/steps", "env/steps"):
            assert g.get(key) == w.get(key)
    params = json.loads((tmp_path / "tt" / "params.json").read_text())
    assert params["env_cls"] == "DiscreteDummyEnv" and params["num_envs"] == "8"


@pytest.mark.parametrize(
    "argv,item",
    [
        (["--save", "out"], "Saved policy to"),
        (["--checkpoint-dir", "ckpt"], "resumes"),
        (["--checkpoint-dir", "ckpt", "--steps-per-checkpoint", "2"], "resumes"),
        (["--checkpoint-dir", "ckpt", "--async-checkpoints"], "resumes"),
        (["--no-resume"], "ignored"),
        (["--no-preemption-checkpoint"], "ignored"),
        (["--async-checkpoints"], "requires --checkpoint-dir"),
        (["--steps-per-checkpoint", "2"], "requires --checkpoint-dir"),
    ],
)
def test_cli_refuses_unported_options(tmp_path, capsys, argv, item) -> None:
    """The checkpoint and export options act as in ``rl8_tpu``'s CLI: both
    refuse the knobs that need a ``--checkpoint-dir`` before anything
    trains, accept and ignore ``--no-resume`` and
    ``--no-preemption-checkpoint`` without one, lay out the same
    checkpoint generations and resume a rerun at step 5, and ``--save``
    writes ``DIR/policy.pkl``."""
    from rl8_tpu_torch.policies import Policy

    jconfig = {"env_cls": "rl8_tpu.env.DiscreteDummyEnv", "algorithm_config": SMALL}
    runs = {"j": (jmain, jconfig), "t": (main, _port_config())}

    def cli(pkg: str, max_steps: int) -> tuple[int, str]:
        entry, config = runs[pkg]
        flags = [str(tmp_path / pkg / a) if a in ("out", "ckpt") else a for a in argv]
        track = tmp_path / pkg / f"track{max_steps}"
        try:
            rc = entry(["train", "-f", _write(tmp_path / pkg, config), "--track-dir", str(track),
                        "--max-steps", str(max_steps), *flags])
        except SystemExit as exc:
            rc = exc.code
        return rc, capsys.readouterr().err

    for pkg in runs:
        rc, err = cli(pkg, 4)
        if item == "requires --checkpoint-dir":
            assert rc != 0 and item in err
            assert not (tmp_path / pkg / "track4").exists(), "nothing may train before the refusal"
            continue
        assert rc == 0
        assert [r["algorithm/steps"] for r in _records(tmp_path / pkg / "track4")] == [1, 2, 3, 4]
        if item == "Saved policy to":
            assert item in err and (tmp_path / pkg / "out" / "policy.pkl").exists()
        if item == "resumes":
            rc, _ = cli(pkg, 6)
            assert rc == 0
            assert [r["algorithm/steps"] for r in _records(tmp_path / pkg / "track6")] == [5, 6]
        if item == "ignored":
            assert sorted(os.listdir(tmp_path / pkg)) == ["config.json", "track4"]
    if item == "resumes":
        gens = [sorted(os.listdir(tmp_path / pkg / "ckpt")) for pkg in runs]
        assert gens[0] == gens[1] and "latest.json" in gens[1]
        latest = [(tmp_path / pkg / "ckpt" / "latest.json").read_text() for pkg in runs]
        assert latest[0] == latest[1]
    if item == "Saved policy to":
        policy = Policy.load(tmp_path / "t" / "out" / "policy.pkl", device="cpu")
        assert next(policy.model.parameters()).device.type == "cpu"


def test_cli_refuses_doctor(tmp_path, capsys) -> None:
    """``doctor`` runs (it refused to before the multi-device slice) and
    refuses, with exit code 1, what ``rl8_tpu``'s refuses: a config that
    does not build and a checkpoint directory that fails the write probe,
    with the same ``fail:`` lines."""
    bad = tmp_path / "bad.yaml"
    bad.write_text("env_cls: not.a.real.Env\n")
    blocker = tmp_path / "blocker"
    blocker.write_text("")  # a file where a directory is needed
    for argv, line in (
        (["doctor", "-f", str(bad)], "fail: config build failed: "),
        (["doctor", "--checkpoint-dir", str(blocker / "sub")], f"fail: checkpoint dir {blocker / 'sub'} failed the write probe: "),
    ):
        outs = []
        for run in (main, jmain):
            assert run(argv) == 1
            outs.append(capsys.readouterr().out)
        for out in outs:
            assert any(ln.startswith(line) for ln in out.splitlines()), out
            assert "1 FAILED" in out


def test_cli_mlflow_needs_mlflow(tmp_path, monkeypatch) -> None:
    monkeypatch.setitem(sys.modules, "mlflow", None)
    with pytest.raises(ImportError):
        main(["train", "-f", _write(tmp_path, _port_config()), "--mlflow", "--max-steps", "1"])


def test_cli_trains_an_example_config_on_the_cpu(tmp_path) -> None:
    """The committed example configs load; CartPole's, cut to the CPU,
    trains through the CLI (``python -m rl8_tpu_torch``)."""
    import yaml

    for name in ("cartpole", "pendulum", "mountain_car"):
        data = yaml.safe_load((REPO / "rl8_tpu_torch" / "examples" / name / "config.yaml").read_text())
        assert data["env_cls"].startswith(f"rl8_tpu_torch.examples.{name}.env.")
        assert data["algorithm_config"]["num_envs"] == 1024
        assert "device" not in data["algorithm_config"]  # the card
    dummy = yaml.safe_load((REPO / "rl8_tpu_torch" / "examples" / "dummy.yaml").read_text())
    assert dummy == {**yaml.safe_load((REPO / "examples" / "dummy.yaml").read_text()),
                     "env_cls": "rl8_tpu_torch.env.DiscreteDummyEnv"}
    data = yaml.safe_load((REPO / "rl8_tpu_torch" / "examples" / "cartpole" / "config.yaml").read_text())
    data["algorithm_config"].update(num_envs=8, horizon=8, device="cpu", model_config={"hiddens": [8]})
    config = _write(tmp_path, data, ".yaml")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-m", "rl8_tpu_torch", "train", "-f", config, "--max-steps", "2", "--track-dir",
         str(tmp_path / "t")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert [r["env/steps"] for r in _records(tmp_path / "t")] == [64, 128]


def test_chip_smoke_drives_the_committed_configs() -> None:
    """chip_smoke.py holds the example configs as JSON (it must run without
    PyYAML): they must be the committed YAML files, and its quick
    start the README's."""
    import importlib.util

    import yaml

    spec = importlib.util.spec_from_file_location("chip_smoke_configs", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, config in smoke.EXAMPLE_CONFIGS.items():
        assert config == yaml.safe_load((REPO / "rl8_tpu_torch" / "examples" / name / "config.yaml").read_text())
    readme = (REPO / "README.md").read_text()
    quick = yaml.safe_load(readme.split("```yaml\n# config.yaml\n", 1)[1].split("```", 1)[0])
    assert smoke.QUICK_START == {**quick, "env_cls": "rl8_tpu_torch.env.DiscreteDummyEnv"}


@pytest.mark.parametrize("name", ["cartpole", "pendulum", "mountain_car"])
def test_chip_smoke_update_checks_hold_the_examples_shapes(tmp_path: Path, name: str) -> None:
    """The update checks' example cases in chip_smoke.py (EXAMPLE_UPDATES,
    example_rows) are the shapes each committed config gives the update:
    obs dim, actions and categories, distribution kind, the default twin
    256-wide relu torsos, and the whole buffer as one minibatch."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    config = smoke.EXAMPLE_CONFIGS[name]
    small = {**config["algorithm_config"], "num_envs": 8, "device": "cpu"}
    path = _write(tmp_path, {**config, "algorithm_config": small})
    algo = TrainConfig.from_file(path).build().algorithm
    params = algo._pack_params()
    got = dict(obs_dim=params.d_in, A=params.action_dim, n=params.n, kind=params.kind)
    assert got == smoke.EXAMPLE_UPDATES[name]
    assert (params.hiddens, params.activation) == ((256, 256), "relu")
    h = algo.hparams
    assert h.sgd_minibatch_size == h.num_envs * h.horizon and not h.accumulate_grads
    assert smoke.example_rows(name) == 1024 * config["algorithm_config"]["horizon"]
