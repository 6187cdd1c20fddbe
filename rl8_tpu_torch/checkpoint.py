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

Multi-process runs (``rl8_tpu_torch.parallel``): saves and restores are
collective. Process 0's generation index is the one every process uses
(a stale shared-mount view elsewhere cannot split the job), process 0
alone writes ``host_state.json``, ``latest.json`` and ``state.pt`` (the
replicated state), and each process of an algorithm's mesh writes its
shard of the env state and the buffer, with its device generators, to
``shard-<rank>-of-<world>.pt``; ``latest.json`` moves once every process
has written. Restore reshards onto the restoring mesh: the saved shards
are joined along their batch axes and each process keeps its rows, so a
checkpoint of 2 processes restores onto 1 or 4 bit for bit. A process
whose rank the saving mesh did not have takes rank 0's generator states,
re-seeded for its own stream in ``shard_map`` mode.

Not here, by design: object-store URLs (``gs://`` and the like) raise
``ValueError``; ``rl8_tpu``'s legacy flat layout is not read.
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

from .parallel import _BATCHED_STATE_FIELDS, _barrier, _batch_axis, _broadcast_int, _map, _max_int, _rank_seed, _rows
from .parallel import _world, is_main_process

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
#: The generators every process of a mesh holds alike (the host key
#: stream); the others are per process, in its shard file.
_REPLICATED_GENERATORS = ("_key_gen",)

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
    state). In a single-process run a pending async save is finished and
    published first; in a multi-process run this is a local read, which
    any subset of processes may make. ``agree=True`` (collective: every
    process calls it) returns process 0's answer everywhere, so that
    resume decisions cannot diverge across hosts."""
    if _world() == 1:
        wait_for_checkpoint()
    directory = _as_path(directory)
    exists = False
    latest = _latest(directory) if os.path.isdir(directory) else None
    if latest is not None:
        sub = latest[1]
        exists = os.path.exists(os.path.join(sub, "host_state.json")) and os.path.exists(os.path.join(sub, _STATE_FILE))
    if agree:
        exists = bool(_broadcast_int(int(exists)))
    return exists


def _publish_latest(directory: str, name: str, index: int) -> None:
    """Atomically point ``latest.json`` at checkpoint ``name``."""
    tmp = os.path.join(directory, "latest.json.tmp")
    with open(tmp, "w") as f:
        f.write(json.dumps({"checkpoint": name, "index": index}))
    os.replace(tmp, os.path.join(directory, "latest.json"))


def _finalize_publish(directory: str, name: str, index: int) -> None:
    """Once every process has written its files, publish generation
    ``name`` and prune those older than the kept window (process 0), then
    hold every process until the publish is done."""
    _barrier()
    if is_main_process():
        _publish_latest(directory, name, index)
        for entry in os.listdir(directory):
            m = _CKPT_RE.match(entry)
            if m and int(m.group(1)) <= index - _KEEP:
                shutil.rmtree(os.path.join(directory, entry), ignore_errors=True)
    _barrier()


def _agree_written(error: None | Exception) -> None:
    """Collective: raise on this process if another process's write
    failed, so that no process publishes a generation missing a part (a
    process whose own write failed raises its error after this)."""
    if _max_int(int(error is not None)) and error is None:
        raise RuntimeError(
            "Another process failed to write its part of the checkpoint; latest.json still points at"
            " the previous complete generation."
        )


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
    error = None
    try:
        writer.wait()
    except Exception as e:  # agreed on by every process, then raised
        error = e
    _agree_written(error)
    if error is not None:
        raise RuntimeError(
            f"Background write of checkpoint {name!r} under {directory}"
            " failed; latest.json still points at the previous complete"
            " generation."
        ) from error
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


def _write_generation(ckpt_dir: str, host: None | dict[str, Any], files: dict[str, Any]) -> None:
    """Write this process's files of one generation (``host_state.json``
    where ``host`` is given; each tensor file through a tmp file)."""
    if host is not None:
        with open(os.path.join(ckpt_dir, "host_state.json"), "w") as f:
            f.write(json.dumps(host))
    for name, tree in files.items():
        tmp = os.path.join(ckpt_dir, name + ".tmp")
        torch.save(tree, tmp)
        os.replace(tmp, os.path.join(ckpt_dir, name))


def _shard_file(rank: int, world: int) -> str:
    return f"shard-{rank:05d}-of-{world:05d}.pt"


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
    Collective in a multi-process run: every process calls it.

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
    main = is_main_process()
    directory = _as_path(directory)
    if main:
        os.makedirs(directory, exist_ok=True)
    latest = _latest(directory) if os.path.isdir(directory) else None
    index = _broadcast_int((latest[0] if latest else 0) + 1)
    name = f"ckpt-{index:08d}"
    ckpt_dir = os.path.join(directory, name)
    if main:
        # Clear debris from a previously interrupted save of this index.
        if os.path.isdir(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        os.makedirs(ckpt_dir)
    _barrier()

    copies: list[torch.Tensor] = []
    state = _snapshot(algorithm.state, copies, "state")
    generators = {k: {"device": g.device.type, "state": g.get_state()} for k, g in _generators(algorithm).items()}
    files: dict[str, Any] = {}
    world = algorithm._world
    if world > 1:
        files[_shard_file(algorithm._rank, world)] = {
            "state": {f: state.pop(f) for f in _BATCHED_STATE_FIELDS},
            "generators": {k: generators.pop(k) for k in list(generators) if k not in _REPLICATED_GENERATORS},
        }
    if main:
        files[_STATE_FILE] = {
            "model": _snapshot(dict(algorithm.policy.model.state_dict()), copies, "model"),
            "state": state,
            "generators": generators,
            "world": world,
        }
    if copies:
        # The copies to pinned memory are queued on the current stream;
        # the snapshot is complete once they are.
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
    host = _host_state(algorithm, trainer_state) if main else None
    if block:
        error = None
        try:
            _write_generation(ckpt_dir, host, files)
        except Exception as e:  # agreed on by every process, then raised
            error = e
        _agree_written(error)
        if error is not None:
            raise error
        _finalize_publish(directory, name, index)
        return
    _PENDING = (_Writer(lambda: _write_generation(ckpt_dir, host, files)), directory, name, index)
    if not _ATEXIT_REGISTERED:
        import atexit

        # A process exiting with an unpublished generation would lose it.
        atexit.register(wait_for_checkpoint)
        _ATEXIT_REGISTERED = True


def _reseed(saved_state: torch.Tensor) -> int:
    """A seed derived from a generator state of another kind of device."""
    digest = hashlib.sha256(saved_state.numpy().tobytes()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def _restore_shards(
    algorithm: Any, ckpt_dir: str, saved: dict[str, Any]
) -> tuple[dict[str, Any], dict[str, Any], int]:
    """This process's env state and buffer (snapshot form) and device
    generator states from generation ``ckpt_dir``, whose ``state.pt`` is
    ``saved``: its own shard file where the saving mesh had this size,
    else the saved shards joined along their batch axes and cut to this
    process's rows. The last item is the rank to fold into the generator
    states (a rank the saving mesh did not have takes rank 0's states,
    re-seeded for its own stream where streams are per process), or 0."""
    W, r = algorithm._world, algorithm._rank
    saved_world = saved.get("world", 1)
    if saved_world == W and W > 1:
        shard = _load(os.path.join(ckpt_dir, _shard_file(r, W)))
        return shard["state"], shard["generators"], 0
    if saved_world == 1:
        fields = {f: saved["state"][f] for f in _BATCHED_STATE_FIELDS}
        parts = [{k: g for k, g in saved["generators"].items() if k not in _REPLICATED_GENERATORS}]
    else:
        shards = [_load(os.path.join(ckpt_dir, _shard_file(i, saved_world))) for i in range(saved_world)]
        # The env state's batch axes, by rl8_tpu's rule on a global
        # reset's shapes (a replicated leaf may match a shard's size).
        template = algorithm.env.reset(torch.Generator(device=algorithm.device).manual_seed(0))[0]
        n = algorithm.hparams.num_envs
        axes = {
            "env_state": _map(lambda leaf: _batch_axis(leaf, n), template),
            "buffer": _map(lambda _: 1, shards[0]["state"]["buffer"]),
        }
        fields = {
            f: _map(
                lambda first, axis, *rest: first if axis is None else torch.cat([first, *rest], dim=axis),
                shards[0]["state"][f], axes[f], *(s["state"][f] for s in shards[1:]),
            )
            for f in _BATCHED_STATE_FIELDS
        }
        parts = [s["generators"] for s in shards]
    if W > 1:
        n = algorithm.hparams.num_envs
        fields = {
            f: _map(lambda leaf, tm=f == "buffer": _rows(leaf, _batch_axis(leaf, n, time_major=tm), r, W), tree)
            for f, tree in fields.items()
        }
    if r < len(parts):
        return fields, parts[r], 0
    return fields, parts[0], algorithm._stream_rank


def restore_checkpoint(directory: str | os.PathLike[str], algorithm: Any, /) -> dict[str, int]:
    """Restore an algorithm's state from ``directory``'s newest complete
    checkpoint, in place. The algorithm must be built from the same
    config; its device and its mesh may differ from the saving one.
    Collective in a multi-process run: every process calls it.

    Returns:
        The persisted trainer counters (empty dict if none were saved).

    """
    wait_for_checkpoint()
    directory = _as_path(directory)
    latest = _latest(directory) if os.path.isdir(directory) else None
    # Agree on process 0's view of the newest generation before acting on
    # the local read (another host's view of a shared mount can lag).
    agreed = _broadcast_int(latest[0] if latest is not None else -1)
    if agreed < 0:
        raise FileNotFoundError(f"No checkpoint found under {directory}.")
    ckpt_dir = latest[1] if latest is not None and agreed == latest[0] else os.path.join(directory, f"ckpt-{agreed:08d}")
    tree = _load(os.path.join(ckpt_dir, _STATE_FILE))
    fields, device_generators, fold = _restore_shards(algorithm, ckpt_dir, tree)
    tree["state"].update(fields)
    saved_generators = {k: g for k, g in tree["generators"].items() if k in _REPLICATED_GENERATORS}
    saved_generators.update(device_generators)
    device = algorithm.device
    with torch.no_grad():
        algorithm.policy.model.load_state_dict(tree["model"])
    algorithm.state = _restore_tree(tree["state"], algorithm.state, device)
    generators = _generators(algorithm)
    if set(generators) != set(saved_generators):
        raise ValueError(
            f"The checkpoint holds generators {sorted(saved_generators)}, the restoring"
            f" algorithm {sorted(generators)}; restore into an algorithm built from the same config."
        )
    for key, saved in saved_generators.items():
        gen = generators[key]
        if saved["device"] == gen.device.type:
            gen.set_state(saved["state"])
        else:
            gen.manual_seed(_reseed(saved["state"]))
        if fold and key in device_generators:
            gen.manual_seed(_rank_seed(_reseed(saved["state"]), fold))
    with open(os.path.join(ckpt_dir, "host_state.json")) as f:
        host = json.load(f)
    algorithm.lr_scheduler.coeff = host["lr_coeff"]
    algorithm.entropy_scheduler.coeff = host["entropy_coeff"]
    return host.get("trainer_state", {})
