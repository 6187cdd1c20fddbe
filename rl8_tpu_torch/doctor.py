"""Bring-up checks: ``python -m rl8_tpu_torch doctor`` (counterpart of
``rl8_tpu/doctor.py``).

A deployment of the port has the parts a pod of ``rl8_tpu`` has: this
process's place in the ``torch.distributed`` group, the mesh over it,
checkpoint storage, and the kernel gates of the configured model.
``doctor`` checks each in one command, suitable for a startup probe::

    python -m rl8_tpu_torch doctor                          # devices + mesh
    python -m rl8_tpu_torch doctor --checkpoint-dir DIR     # + storage round trip
    python -m rl8_tpu_torch doctor -f train.yaml            # + config, mode, kernels

Every check prints one ``ok:``/``fail:`` line; the process exits
non-zero if any check fails, so ``doctor && python -m rl8_tpu_torch train
...`` gates a startup script.
"""

from __future__ import annotations

import os
import uuid
from typing import Any

__all__ = ["run_doctor"]


def _check_devices(report: list[tuple[bool, str]]) -> None:
    import torch
    import torch.distributed as dist

    try:
        if torch.cuda.is_available():
            local = torch.cuda.device_count()
            kinds = sorted({torch.cuda.get_device_name(i) for i in range(local)})
            platform = "cuda"
        else:
            local, kinds, platform = 1, ["cpu"], "cpu"
    except RuntimeError as e:
        report.append((False, f"backend initialization failed: {e}"))
        return
    grouped = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if grouped else (0, 1)
    report.append(
        (
            True,
            f"{world if grouped else local} device(s) [{', '.join(kinds)}] on platform"
            f" {platform!r}; process {rank}/{world}, {local} local",
        )
    )


def _check_mesh(report: list[tuple[bool, str]]) -> None:
    import torch.distributed as dist

    from .parallel import create_mesh

    if not (dist.is_available() and dist.is_initialized()):
        report.append(
            (True, "no process group: a single-process run (initialize_multihost or torchrun gives a mesh)")
        )
        return
    try:
        mesh = create_mesh()
        report.append((True, f"mesh over {mesh.size()} device(s), axes {mesh.mesh_dim_names}"))
    except Exception as e:
        report.append((False, f"create_mesh failed: {type(e).__name__}: {e}"))


def _check_checkpoint_dir(directory: str, report: list[tuple[bool, str]]) -> None:
    """Round-trip a probe file under ``directory`` and report the resume
    state."""
    from .checkpoint import _as_path, _latest, checkpoint_exists

    try:
        path = _as_path(directory)
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, f".doctor-probe-{uuid.uuid4().hex}")
        with open(probe, "w") as f:
            f.write("ok")
        with open(probe) as f:
            if f.read() != "ok":
                raise OSError(f"{probe} did not read back what was written")
        os.unlink(probe)
        report.append((True, f"checkpoint dir {directory} is writable"))
    except Exception as e:
        report.append((False, f"checkpoint dir {directory} failed the write probe: {type(e).__name__}: {e}"))
        return
    try:
        latest = _latest(path) if checkpoint_exists(directory) else None
        if latest is not None:
            report.append((True, f"resume would restore generation {latest[0]} ({os.path.basename(latest[1])})"))
        else:
            report.append((True, "no checkpoint yet; training starts fresh"))
    except Exception as e:
        report.append((False, f"checkpoint probe failed: {type(e).__name__}: {e}"))


def _check_config(config_file: str, report: list[tuple[bool, str]]) -> None:
    """Build the config's algorithm and report what the hot path will do:
    the execution mode and which kernels it launches."""
    from .algorithms import RecurrentAlgorithm
    from .trainers import TrainConfig

    try:
        trainer = TrainConfig.from_file(config_file).build()
    except Exception as e:
        report.append((False, f"config build failed: {type(e).__name__}: {e}"))
        return
    algo = trainer.algorithm
    hp = algo.hparams
    report.append(
        (
            True,
            f"built {type(algo).__name__} on {type(algo.env).__name__}:"
            f" model {type(algo.policy.model).__name__},"
            f" num_envs={hp.num_envs}, horizon={hp.horizon}",
        )
    )
    mode = "single-device" if algo.mesh is None else ("shard_map" if algo._axis is not None else "GSPMD exact")
    report.append((True, f"execution mode: {mode}"))
    act, update = ("rnn_act.cu", "rnn_ppo.cu") if isinstance(algo, RecurrentAlgorithm) else ("act.cu", "ppo.cu")
    gates = {
        f"act kernel (csrc/{act})": algo._fused_act,
        f"update kernel (csrc/{update})": algo._fused_update,
        "chain kernels (csrc/chains.cu)": algo._fused_forward,
        "GAE kernel (csrc/gae.cu)": algo._gae_kernel,
    }
    on = [k for k, v in gates.items() if v]
    off = [k for k, v in gates.items() if not v]
    report.append(
        (
            True,
            "fast paths on: " + (", ".join(on) if on else "none")
            + ("; off (PyTorch route): " + ", ".join(off) if off else "")
            + ("; on the CPU each kernel's plain version runs" if algo.device.type == "cpu" else ""),
        )
    )


def run_doctor(
    *,
    config_file: None | str = None,
    checkpoint_dir: None | str = None,
    print_fn: Any = print,
) -> int:
    """Run the bring-up checks; returns a process exit code (0 = all
    checks passed)."""
    report: list[tuple[bool, str]] = []
    _check_devices(report)
    _check_mesh(report)
    if checkpoint_dir:
        _check_checkpoint_dir(checkpoint_dir, report)
    if config_file:
        _check_config(config_file, report)
    for ok, line in report:
        print_fn(("ok: " if ok else "fail: ") + line)
    failed = sum(not ok for ok, _ in report)
    print_fn(f"{len(report) - failed}/{len(report)} checks passed" + (f", {failed} FAILED" if failed else ""))
    return 1 if failed else 0
