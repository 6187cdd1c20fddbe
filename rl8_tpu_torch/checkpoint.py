"""Mid-training checkpoint and resume (counterpart of ``rl8_tpu/checkpoint.py``).

A checkpoint holds everything a resumed run needs to continue bit for bit:
the model's ``state_dict``, the algorithm state (env state, rollout
buffer, reward scale, the optimizer's state: Adam's moments and count,
or a ``torch.optim`` optimizer's per-parameter ``state_dict()`` entries,
tensors and Python scalars, loaded back into it at the next update; the
host counters ``horizons``, ``buffered`` and, for recurrent algorithms,
``seqs``), the state of every ``torch.Generator`` the algorithm holds
(the host key stream, the env-reset, shuffle and module-rollout streams),
the schedulers' coefficients and the trainer's counters.

The on-disk protocol is ``rl8_tpu``'s: each save writes a fresh
``ckpt-<8 digits>/`` holding ``host_state.json`` (``horizons_host``,
``lr_coeff``, ``entropy_coeff``, ``trainer_state``) and the tensors
(``state.pt``, written with ``torch.save`` and read with
``torch.load(..., weights_only=True)``), and only then points
``latest.json`` at it through a tmp file and ``os.replace``. An
interrupted save leaves ``latest.json`` on the previous complete
generation; two generations are kept, and debris of an interrupted save
of the same index is cleared.

``block=False`` copies the state to host memory (pinned, for tensors on
the card) before it returns and writes on a background thread; the
generation is published by :func:`wait_for_checkpoint`, which the next
save, restore or exists call and interpreter exit also run.

Restore puts every tensor on the restoring algorithm's device, so a
checkpoint written on the card restores on the CPU and the other way
round. Generator states move exactly between algorithms on the same kind
of device. A CPU generator and a card generator run different
algorithms, so across kinds the device generators are re-seeded from the
saved state: the run continues, with other env-reset, shuffle and sample
draws (as a run on the card never reproduces a CPU run).

Not here, by design or until later (ROADMAP Queue 3 and Queue 1 #8):
object-store URLs (``gs://`` and the like) raise ``ValueError``; the
multi-process barrier and broadcast of ``rl8_tpu`` are single-process
no-ops; ``rl8_tpu``'s legacy flat layout is not read.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any

import torch

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "checkpoint_exists",
    "wait_for_checkpoint",
]

_CKPT_RE = re.compile(r"^ckpt-(\d{8})$")
#: Checkpoint generations kept on disk (latest + one fallback).
_KEEP = 2
#: The tensors' file in a generation.
_STATE_FILE = "state.pt"
#: Marks an encoded dataclass in the saved tree.
_DATACLASS = "__dataclass__"

#: In-flight async save: ``(writer, directory, name, index)``; the writer
#: has a ``wait()`` that returns when the write is done or raises its error.
_PENDING: None | tuple[Any, str, str, int] = None
_ATEXIT_REGISTERED = False


def _as_path(directory: str | os.PathLike[str]) -> str:
    """The absolute local path of ``directory``; object-store URLs raise."""
    raw = os.fspath(directory)
    if "://" in raw:
        raise ValueError(
            f"Checkpoint directory {raw!r} is an object-store URL. This port writes"
            " checkpoints to local or mounted filesystems only; rl8_tpu reaches object"
            " stores through etils and tensorstore, which it does not use."
        )
    return os.path.abspath(raw)


def _latest(directory: str) -> tuple[int, str] | None:
    """``(index, subdir)`` of the newest complete checkpoint, or ``None``."""
    path = os.path.join(directory, "latest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        data = json.load(f)
    return int(data["index"]), os.path.join(directory, data["checkpoint"])


def checkpoint_exists(directory: str | os.PathLike[str], /, *, agree: bool = False) -> bool:
    """Whether ``directory`` holds a complete checkpoint written by
    :func:`save_checkpoint` (``latest.json`` only ever points at complete
    state). A pending async save is finished and published first.
    ``agree`` is accepted for ``rl8_tpu``'s signature; with one process
    there is nothing to agree on."""
    wait_for_checkpoint()
    directory = _as_path(directory)
    if not os.path.isdir(directory):
        return False
    latest = _latest(directory)
    if latest is None:
        return False
    sub = latest[1]
    return os.path.exists(os.path.join(sub, "host_state.json")) and os.path.exists(os.path.join(sub, _STATE_FILE))


def _publish_latest(directory: str, name: str, index: int) -> None:
    """Atomically point ``latest.json`` at checkpoint ``name``."""
    tmp = os.path.join(directory, "latest.json.tmp")
    with open(tmp, "w") as f:
        f.write(json.dumps({"checkpoint": name, "index": index}))
    os.replace(tmp, os.path.join(directory, "latest.json"))


def _finalize_publish(directory: str, name: str, index: int) -> None:
    """Publish generation ``name`` and prune those older than the kept window."""
    _publish_latest(directory, name, index)
    for entry in os.listdir(directory):
        m = _CKPT_RE.match(entry)
        if m and int(m.group(1)) <= index - _KEEP:
            shutil.rmtree(os.path.join(directory, entry), ignore_errors=True)


class _Writer:
    """Runs one checkpoint write on a background thread; :meth:`wait`
    joins it and raises what it raised, or that it did not finish."""

    def __init__(self, fn: Any) -> None:
        self._error: None | Exception = None
        self._done = False

        def target() -> None:
            try:
                fn()
            except Exception as e:  # handed to wait()
                self._error = e
            else:
                self._done = True

        self._thread = threading.Thread(target=target, name="rl8-checkpoint-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        self._thread.join()
        if self._error is not None:
            raise self._error
        if not self._done:
            raise RuntimeError("The checkpoint writer thread ended without finishing the write.")


def wait_for_checkpoint() -> None:
    """Block until the in-flight async checkpoint (if any) is written and
    published. A no-op when no async save is pending.

    Raises:
        RuntimeError: If the background write failed; it names the
            generation, and ``latest.json`` still points at the previous
            complete one.

    """
    global _PENDING
    if _PENDING is None:
        return
    writer, directory, name, index = _PENDING
    _PENDING = None
    try:
        writer.wait()
    except Exception as e:
        raise RuntimeError(
            f"Background write of checkpoint {name!r} under {directory}"
            " failed; latest.json still points at the previous complete"
            " generation."
        ) from e
    _finalize_publish(directory, name, index)


# ----------------------------------------------------------------------
# The saved tree
# ----------------------------------------------------------------------


def _snapshot(obj: Any, copies: list[torch.Tensor], where: str) -> Any:
    """Host copy of a state tree: tensors to (pinned) CPU tensors,
    dataclasses to marked dicts, containers and Python scalars as they
    are. Anything else raises, so a tree that ``weights_only`` loading
    would refuse fails at save time."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type == "cpu":
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        copies.append(host)
        return host
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {f.name: _snapshot(getattr(obj, f.name), copies, f"{where}.{f.name}") for f in dataclasses.fields(obj)}
        out[_DATACLASS] = type(obj).__qualname__
        return out
    if isinstance(obj, dict):
        for key in obj:
            if not isinstance(key, str):
                raise TypeError(f"Checkpoints take string keys only; {where} has key {key!r}.")
        return {k: _snapshot(v, copies, f"{where}[{k!r}]") for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v, copies, f"{where}[{i}]") for i, v in enumerate(obj))
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(
        f"Checkpoints take tensors, dataclasses, dicts, lists, tuples and Python"
        f" scalars; {where} is a {type(obj).__name__}."
    )


def _restore_tree(saved: Any, template: Any, device: torch.device) -> Any:
    """Invert :func:`_snapshot` onto ``device``: a marked dict becomes the
    template's dataclass with the saved fields."""
    if isinstance(saved, torch.Tensor):
        return saved.to(device)
    if isinstance(saved, dict) and _DATACLASS in saved:
        if not dataclasses.is_dataclass(template) or type(template).__qualname__ != saved[_DATACLASS]:
            raise ValueError(
                f"The checkpoint holds a {saved[_DATACLASS]} where the restoring algorithm"
                f" has a {type(template).__name__}; restore into an algorithm built from the"
                " same config."
            )
        fields = {
            k: _restore_tree(v, getattr(template, k, None), device) for k, v in saved.items() if k != _DATACLASS
        }
        return dataclasses.replace(template, **fields)
    if isinstance(saved, dict):
        sub = template if isinstance(template, dict) else {}
        return {k: _restore_tree(v, sub.get(k), device) for k, v in saved.items()}
    if isinstance(saved, (list, tuple)):
        return type(saved)(_restore_tree(v, None, device) for v in saved)
    return saved


def _generators(algorithm: Any) -> dict[str, torch.Generator]:
    """Every ``torch.Generator`` the algorithm holds, by attribute name."""
    return {k: v for k, v in sorted(vars(algorithm).items()) if isinstance(v, torch.Generator)}


def _host_state(algorithm: Any, trainer_state: None | dict[str, int]) -> dict[str, Any]:
    """``host_state.json``'s content, with ``rl8_tpu``'s keys."""
    return {
        "horizons_host": int(algorithm.state.horizons),
        "lr_coeff": algorithm.lr_scheduler.coeff,
        "entropy_coeff": algorithm.entropy_scheduler.coeff,
        "trainer_state": trainer_state or {},
    }


def _write_generation(ckpt_dir: str, host: dict[str, Any], tree: dict[str, Any]) -> None:
    """Write one generation's files (``state.pt`` through a tmp file)."""
    with open(os.path.join(ckpt_dir, "host_state.json"), "w") as f:
        f.write(json.dumps(host))
    tmp = os.path.join(ckpt_dir, _STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(ckpt_dir, _STATE_FILE))


def save_checkpoint(
    directory: str | os.PathLike[str],
    algorithm: Any,
    /,
    *,
    trainer_state: None | dict[str, int] = None,
    block: bool = True,
) -> None:
    """Save an algorithm's full dynamic state (and optional trainer
    counters) as a new checkpoint generation under ``directory``.

    Args:
        directory: Checkpoint directory (created if missing); it holds the
            last two generations plus ``latest.json``.
        algorithm: An ``Algorithm`` or ``RecurrentAlgorithm``.
        trainer_state: Optional trainer counters to persist alongside.
        block: ``False`` returns once the state is copied to host memory
            and writes in the background; ``latest.json`` moves only when
            the write is done (:func:`wait_for_checkpoint`, called by the
            next save, restore or exists call and at interpreter exit).

    """
    global _PENDING, _ATEXIT_REGISTERED
    # One generation in flight at a time.
    wait_for_checkpoint()
    directory = _as_path(directory)
    os.makedirs(directory, exist_ok=True)
    latest = _latest(directory)
    index = (latest[0] if latest else 0) + 1
    name = f"ckpt-{index:08d}"
    ckpt_dir = os.path.join(directory, name)
    # Clear debris from a previously interrupted save of this index.
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.makedirs(ckpt_dir)

    copies: list[torch.Tensor] = []
    tree = {
        "model": _snapshot(dict(algorithm.policy.model.state_dict()), copies, "model"),
        "state": _snapshot(algorithm.state, copies, "state"),
        "generators": {
            k: {"device": g.device.type, "state": g.get_state()} for k, g in _generators(algorithm).items()
        },
    }
    if copies:
        # The copies to pinned memory are queued on the current stream;
        # the snapshot is complete once they are.
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
    host = _host_state(algorithm, trainer_state)
    if block:
        _write_generation(ckpt_dir, host, tree)
        _finalize_publish(directory, name, index)
        return
    _PENDING = (_Writer(lambda: _write_generation(ckpt_dir, host, tree)), directory, name, index)
    if not _ATEXIT_REGISTERED:
        import atexit

        # A process exiting with an unpublished generation would lose it.
        atexit.register(wait_for_checkpoint)
        _ATEXIT_REGISTERED = True


def _reseed(saved_state: torch.Tensor) -> int:
    """A seed derived from a generator state of another kind of device."""
    digest = hashlib.sha256(saved_state.numpy().tobytes()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


def restore_checkpoint(directory: str | os.PathLike[str], algorithm: Any, /) -> dict[str, int]:
    """Restore an algorithm's state from ``directory``'s newest complete
    checkpoint, in place. The algorithm must be built from the same
    config; its device may differ from the saving one.

    Returns:
        The persisted trainer counters (empty dict if none were saved).

    """
    wait_for_checkpoint()
    directory = _as_path(directory)
    latest = _latest(directory) if os.path.isdir(directory) else None
    if latest is None:
        raise FileNotFoundError(f"No checkpoint found under {directory}.")
    ckpt_dir = latest[1]
    tree = torch.load(os.path.join(ckpt_dir, _STATE_FILE), map_location="cpu", weights_only=True)
    device = algorithm.device
    with torch.no_grad():
        algorithm.policy.model.load_state_dict(tree["model"])
    algorithm.state = _restore_tree(tree["state"], algorithm.state, device)
    generators = _generators(algorithm)
    if set(generators) != set(tree["generators"]):
        raise ValueError(
            f"The checkpoint holds generators {sorted(tree['generators'])}, the restoring"
            f" algorithm {sorted(generators)}; restore into an algorithm built from the same config."
        )
    for key, saved in tree["generators"].items():
        gen = generators[key]
        if saved["device"] == gen.device.type:
            gen.set_state(saved["state"])
        else:
            gen.manual_seed(_reseed(saved["state"]))
    with open(os.path.join(ckpt_dir, "host_state.json")) as f:
        host = json.load(f)
    algorithm.lr_scheduler.coeff = host["lr_coeff"]
    algorithm.entropy_scheduler.coeff = host["entropy_coeff"]
    return host.get("trainer_state", {})
