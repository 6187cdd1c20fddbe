"""The port's ``doctor`` (``rl8_tpu_torch/doctor.py``) against
``rl8_tpu``'s ``run_doctor`` on the CPU: the exit codes and lines that
``tests/test_config_cli.py::test_cli_doctor`` exercises, the config and
execution-mode lines word for word for the same YAML, the resume line,
the kernels it names, and its device and mesh lines inside a
two-process group."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch.distributed as dist

from rl8_tpu_torch.__main__ import main
from rl8_tpu_torch.doctor import run_doctor
from tests.test_torch_parallel import join_group, spawn_pair

YAML = (
    "env_cls: {package}.env.DiscreteDummyEnv\n"
    "algorithm_config:\n"
    "  horizon: 4\n"
    "  num_envs: 8\n"
    "  model_config:\n"
    "    hiddens: [8]\n"
)
RECURRENT_YAML = (
    "env_cls: {package}.env.DiscreteDummyEnv\n"
    "recurrent: true\n"
    "algorithm_config:\n"
    "  horizon: 4\n"
    "  num_envs: 8\n"
    "  seq_len: 2\n"
    "  seqs_per_state_reset: 2\n"
    "  model_config:\n"
    "    hidden_size: 8\n"
)


def _configs(tmp_path: Path, template: str = YAML) -> tuple[str, str]:
    """The same YAML for both packages; the port's runs on the CPU."""
    port, jax = tmp_path / "port.yaml", tmp_path / "jax.yaml"
    port.write_text(template.format(package="rl8_tpu_torch") + "  device: cpu\n")
    jax.write_text(template.format(package="rl8_tpu"))
    return str(port), str(jax)


def _lines(fn, **kwargs) -> tuple[int, list[str]]:
    lines: list[str] = []
    return fn(print_fn=lines.append, **kwargs), lines


def _jax_doctor(**kwargs) -> tuple[int, list[str]]:
    from rl8_tpu.doctor import run_doctor as jrun_doctor

    return _lines(jrun_doctor, **kwargs)


def test_doctor_passes_and_matches_jax(tmp_path) -> None:
    """With a config that builds and a writable checkpoint directory both
    exit 0 with no failed check; the config and execution-mode lines are
    ``rl8_tpu``'s, and the fast-path line names the kernels on."""
    port, jax = _configs(tmp_path)
    rc, lines = _lines(run_doctor, config_file=port, checkpoint_dir=str(tmp_path / "ckpt"))
    jrc, jlines = _jax_doctor(config_file=jax, checkpoint_dir=str(tmp_path / "jckpt"))
    assert rc == jrc == 0
    assert not any(ln.startswith("fail:") for ln in lines)
    assert lines[-1] == "7/7 checks passed" and jlines[-1].endswith("checks passed")
    for prefix in ("ok: built ", "ok: execution mode: "):
        (mine,), (theirs,) = ([ln for ln in ls if ln.startswith(prefix)] for ls in (lines, jlines))
        assert mine == theirs
    assert "ok: execution mode: single-device" in lines
    assert f"ok: checkpoint dir {tmp_path / 'ckpt'} is writable" in lines
    assert "ok: no checkpoint yet; training starts fresh" in lines
    (paths,) = [ln for ln in lines if ln.startswith("ok: fast paths on: ")]
    assert "act kernel (csrc/act.cu), update kernel (csrc/ppo.cu), GAE kernel (csrc/gae.cu)" in paths
    assert "off (PyTorch route): chain kernels (csrc/chains.cu)" in paths


def test_doctor_names_the_recurrent_kernels(tmp_path) -> None:
    port, jax = _configs(tmp_path, RECURRENT_YAML)
    rc, lines = _lines(run_doctor, config_file=port)
    jrc, jlines = _jax_doctor(config_file=jax)
    assert rc == jrc == 0
    (built,) = [ln for ln in lines if ln.startswith("ok: built ")]
    assert built == next(ln for ln in jlines if ln.startswith("ok: built "))
    assert any("act kernel (csrc/rnn_act.cu), update kernel (csrc/rnn_ppo.cu)" in ln for ln in lines)


def test_doctor_reports_the_resume_generation_like_jax(tmp_path) -> None:
    from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
    from rl8_tpu.checkpoint import save_checkpoint as jsave
    from rl8_tpu.env import DiscreteDummyEnv as JDiscreteDummyEnv

    from rl8_tpu_torch import AlgorithmConfig
    from rl8_tpu_torch.checkpoint import save_checkpoint
    from rl8_tpu_torch.env import DiscreteDummyEnv

    cfg = dict(num_envs=8, horizon=4, model_config={"hiddens": (8,)})
    algo = AlgorithmConfig(**cfg, device="cpu").build(DiscreteDummyEnv)
    jalgo = JAlgorithmConfig(**cfg).build(JDiscreteDummyEnv)
    for _ in range(2):
        save_checkpoint(tmp_path / "port", algo)
        jsave(tmp_path / "jax", jalgo)
    _, lines = _lines(run_doctor, checkpoint_dir=str(tmp_path / "port"))
    _, jlines = _jax_doctor(checkpoint_dir=str(tmp_path / "jax"))
    assert "ok: resume would restore generation 2 (ckpt-00000002)" in lines
    assert "ok: resume would restore generation 2 (ckpt-00000002)" in jlines


@pytest.mark.parametrize("case", ["bad-config", "unwritable"])
def test_doctor_fails_like_jax(tmp_path, case: str) -> None:
    """A config that does not build, and a file where the checkpoint
    directory should be, flip the exit code to 1 in both packages."""
    if case == "bad-config":
        bad = tmp_path / "bad.yaml"
        bad.write_text("env_cls: not.a.real.Env\n")
        kwargs, line = {"config_file": str(bad)}, "fail: config build failed"
    else:
        blocker = tmp_path / "blocker"
        blocker.write_text("")
        kwargs, line = {"checkpoint_dir": str(blocker / "sub")}, "write probe"
    for rc, lines in (_lines(run_doctor, **kwargs), _jax_doctor(**kwargs)):
        assert rc == 1
        assert any(ln.startswith("fail:") and line in ln for ln in lines)
        assert lines[-1].endswith("1 FAILED")


def test_cli_doctor_runs(tmp_path, capsys) -> None:
    port, _ = _configs(tmp_path)
    assert main(["doctor", "-f", port]) == 0
    out = capsys.readouterr().out
    assert "ok: execution mode: single-device" in out and "fail:" not in out


def test_doctor_without_a_process_group_is_a_single_process_run() -> None:
    _, lines = _lines(run_doctor)
    assert lines[0] == "ok: 1 device(s) [cpu] on platform 'cpu'; process 0/1, 1 local"
    assert lines[1].startswith("ok: no process group: a single-process run")


def _doctor_worker(rank: int, rdzv: str, out: str) -> None:
    join_group(rank, rdzv)
    try:
        rc, lines = _lines(run_doctor)
        Path(f"{out}/rank{rank}.txt").write_text("\n".join([str(rc), *lines]))
    finally:
        dist.destroy_process_group()


def test_doctor_in_a_two_process_group(tmp_path) -> None:
    """Inside a group each process reports its rank and the world, and the
    mesh over both processes with ``rl8_tpu``'s axis names."""
    spawn_pair(_doctor_worker, tmp_path, str(tmp_path))
    for rank in range(2):
        rc, *lines = (tmp_path / f"rank{rank}.txt").read_text().splitlines()
        assert rc == "0"
        assert lines[0] == f"ok: 2 device(s) [cpu] on platform 'cpu'; process {rank}/2, 1 local"
        assert lines[1] == "ok: mesh over 2 device(s), axes ('env',)"
