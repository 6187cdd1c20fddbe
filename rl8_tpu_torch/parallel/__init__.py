"""Multi-device training over ``torch.distributed`` (counterpart of
``rl8_tpu/parallel/__init__.py``).

``rl8_tpu`` drives every device from one process, with ``shard_map`` over
a ``jax.sharding.Mesh`` whose ``"env"`` axis shards the environment
batch. PyTorch's idiom is one process per card: a 1-D
:class:`~torch.distributed.device_mesh.DeviceMesh` named ``"env"`` spans
the processes of a ``torch.distributed`` group (NCCL on the card, gloo on
the CPU), each process runs the algorithm on its own ``num_envs / world``
envs, and an explicit collective stands wherever ``rl8_tpu`` has a
``pmean``, ``psum``, ``pmin`` or ``pmax``. The env state and the rollout
buffer shard along the env batch; parameters, optimizer state, counters
and the reward scale are replicated (every process holds the same
values).

Placement goes by field, as in ``rl8_tpu``: ``env_state`` leaves shard on
axis 0 and ``buffer`` leaves on axis 1, everything else is replicated.
"Placing" a global tree on a mesh keeps this process's rows.

With ``group=None`` the reductions are plain local ones, so unsharded and
sharded code share one implementation.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

__all__ = [
    "create_mesh",
    "initialize_multihost",
    "is_main_process",
    "shard_state",
    "shard_batch",
    "state_pspecs",
    "gmean",
    "gstd",
    "gmin",
    "gmax",
    "pmean_tree",
    "ENV_AXIS",
]

#: Name of the mesh axis the environment batch shards over.
ENV_AXIS = "env"

#: Algorithm-state fields holding env-batched data; every other field
#: (optimizer state, counters, reward scale) is replicated.
_BATCHED_STATE_FIELDS = ("env_state", "buffer")


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    cpu_collectives: str | None = None,
) -> None:
    """Join this process to the ``torch.distributed`` group of a
    multi-process run: one process per card.

    Call once per process before building algorithms. With no arguments
    the rendezvous, world size and rank come from the environment
    variables that ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``); else pass all three. After it,
    :func:`create_mesh` spans every process, and trainers log metrics and
    write the checkpoint's host state from process 0 only.

    Args:
        coordinator_address: ``host:port`` of process 0's rendezvous (or
            an ``init_method`` URL such as ``file:///path``).
        num_processes: Total process count.
        process_id: This process's rank.
        cpu_collectives: ``None`` runs NCCL, on the card; a backend name
            (``"gloo"``) runs that one instead: the CPU's, or several
            processes sharing one card, which NCCL refuses. The choice is
            the caller's; a failed initialization raises.

    """
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit) and any(v is None for v in explicit):
        raise ValueError("Pass coordinator_address, num_processes and process_id together, or none of them.")
    backend = cpu_collectives or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "NCCL needs a CUDA card and none is available; pass cpu_collectives='gloo' to run on the CPU."
            )
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0) if process_id is None else process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if coordinator_address is None:
        dist.init_process_group(backend)
        return
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)


def is_main_process() -> bool:
    """Whether this is process 0, the one that logs metrics: every process
    of a single-process run, and rank 0 where ``torch.distributed`` is
    initialized."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def create_mesh(devices: Any = None, *, axis_name: str = ENV_AXIS) -> Any:
    """A 1-D ``DeviceMesh`` named ``axis_name`` over ``devices``, the ranks
    of the initialized group (default: all of them, in rank order).

    Every process calls it. NCCL picks its own rings, so there is no
    counterpart of ``rl8_tpu``'s slice-aware device ordering.

    Raises:
        RuntimeError: If no process group is initialized
            (:func:`initialize_multihost`, or a ``torchrun`` launch).

    """
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "create_mesh needs an initialized process group: call initialize_multihost() first"
            " (or launch with torchrun)."
        )
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=(axis_name,))


# ----------------------------------------------------------------------
# Placement
# ----------------------------------------------------------------------


def _map(fn: Any, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of equally nested dicts, lists, tuples and
    dataclasses; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: _map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
                     for f in dataclasses.fields(tree)}
        )
    return fn(tree, *rest)


def _batch_axis(leaf: Any, num_envs: int, axis_name: str = ENV_AXIS, time_major: bool = False) -> None | int:
    """The axis of an env-batched leaf that shards (``None``: replicated).

    The batch axis position is fixed per subtree: axis 0 for env state
    ``[B, ...]``, axis 1 for time-major buffers ``[T, B, ...]``; it is
    never inferred by searching the shape for ``num_envs``. A leaf whose
    expected batch axis is not ``num_envs``-sized but that carries
    ``num_envs`` elsewhere is ambiguous and raises."""
    shape = tuple(getattr(leaf, "shape", ()))
    axis = 1 if time_major else 0
    if len(shape) > axis and shape[axis] == num_envs:
        return axis
    if num_envs in shape and num_envs > 1:
        where = "axis 1 of time-major [T, B, ...]" if time_major else "axis 0"
        raise ValueError(
            f"Ambiguous env-batched leaf with shape {shape}: the batch"
            f" axis must be {where} to shard over the mesh's"
            f" '{axis_name}' axis, but num_envs={num_envs} appears at a"
            " different position. Move the env-batch axis to the"
            " expected position, or keep genuinely unbatched data whose"
            f" dimensions coincide with num_envs out of the"
            " env-state/buffer pytrees (e.g. close over it in the env)."
        )
    return None


def _batch_leaf_spec(leaf: Any, num_envs: int, axis_name: str = ENV_AXIS, time_major: bool = False) -> Any:
    """The placement of a leaf of an env-batched subtree: ``Shard(0)`` for
    env state ``[B, ...]``, ``Shard(1)`` for time-major buffers, else
    ``Replicate()`` (see :func:`_batch_axis` for the ambiguous case)."""
    from torch.distributed.tensor import Replicate, Shard

    axis = _batch_axis(leaf, num_envs, axis_name, time_major)
    return Replicate() if axis is None else Shard(axis)


def _rows(leaf: Any, axis: None | int, rank: int, world: int) -> Any:
    """Rank ``rank``'s contiguous copy of ``leaf``'s rows along ``axis``
    (``None``: the leaf as it is)."""
    if axis is None or world == 1:
        return leaf
    n = leaf.shape[axis]
    if n % world:
        raise ValueError(f"The env batch ({n}) must divide evenly over the mesh's {world} devices.")
    part = n // world
    return leaf.narrow(axis, rank * part, part).clone(memory_format=torch.contiguous_format)


def shard_batch(
    batch: Any, mesh: Any, num_envs: int, *, axis_name: str = ENV_AXIS, time_major: bool = False
) -> Any:
    """This process's rows of a tree of env-batched tensors, held whole by
    every process.

    ``time_major=False`` (env state): leaves are batch-leading
    ``[num_envs, ...]`` or unbatched per-config data, which stays whole.
    ``time_major=True`` (rollout buffers): leaves are ``[T, num_envs, ...]``.
    """
    rank, world = mesh.get_local_rank(axis_name), mesh.size()
    return _map(lambda x: _rows(x, _batch_axis(x, num_envs, axis_name, time_major), rank, world), batch)


def shard_state(state: Any, mesh: Any, num_envs: int, *, axis_name: str = ENV_AXIS) -> Any:
    """Place an algorithm state held whole by every process: its
    env-batched fields (``env_state`` along axis 0, ``buffer`` along axis
    1) keep this process's rows, every other field is replicated as it is.

    Field-driven (``dataclasses.fields``), so subclasses' extra fields
    (``RecurrentAlgorithmState.seqs``, a counter) are replicated too."""
    return dataclasses.replace(
        state,
        **{
            name: shard_batch(getattr(state, name), mesh, num_envs, axis_name=axis_name, time_major=name == "buffer")
            for name in _BATCHED_STATE_FIELDS
        },
    )


def state_pspecs(state: Any, num_envs: int, *, axis_name: str = ENV_AXIS) -> Any:
    """The ``torch.distributed.tensor`` placement of every leaf of an
    algorithm state held whole, as :func:`shard_state` places it: a state
    of the same structure with ``Shard(0)``/``Shard(1)``/``Replicate()``
    leaves.

    Classification is by field (only ``env_state``/``buffer`` subtrees are
    env-batched), not by shape, so parameter or optimizer leaves whose
    dimensions coincide with ``num_envs`` stay replicated."""
    from torch.distributed.tensor import Replicate

    specs = _map(lambda _: Replicate(), state)
    return dataclasses.replace(
        specs,
        **{
            name: _map(lambda x, tm=name == "buffer": _batch_leaf_spec(x, num_envs, axis_name, tm), getattr(state, name))
            for name in _BATCHED_STATE_FIELDS
        },
    )


def _rank_seed(seed: int, rank: int, bits: int = 62) -> int:
    """The seed of process ``rank``'s random stream derived from ``seed``
    (``bits`` wide); rank 0 keeps ``seed``, so a one-process mesh draws
    what an unsharded run draws."""
    return (seed + rank * 0x9E3779B97F4A7C15) % 2**bits


# ----------------------------------------------------------------------
# Global reductions
# ----------------------------------------------------------------------
#
# Each process sees only its env shard, so batch statistics that the
# reference computes over the whole batch (advantage normalization, the
# reward scale, the return and reward metrics) reduce over the group.
# Shards are equal-sized, so the mean of local means is exact. Gloo has
# no average: every mean is a sum divided by the world size.


def _all_reduce(x: torch.Tensor, op: Any, group: Any) -> torch.Tensor:
    """All-reduce a copy of ``x`` over ``group``; counts its calls in
    ``_all_reduce.calls``."""
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    _all_reduce.calls += 1
    return out


_all_reduce.calls = 0  # type: ignore[attr-defined]


def gmean(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Mean over all elements, over every process of ``group`` (``None``:
    this process's)."""
    m = x.mean()
    return m if group is None else _all_reduce(m, dist.ReduceOp.SUM, group) / dist.get_world_size(group)


def gstd(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """SAMPLE standard deviation (``ddof=1``) over all elements, as the
    reward scale, advantage normalization and return metrics use. Over a
    group it is two-pass (centered on the global mean; the one-pass
    ``E[x^2] - E[x]^2`` cancels in f32 when ``|mean| >> std``), with ``n``
    the global element count."""
    if group is None:
        return x.std(correction=1)
    m = gmean(x, group)
    var = gmean(torch.square(x - m), group)
    n = x.numel() * dist.get_world_size(group)
    return torch.sqrt(var * n / (n - 1.0))


def gmin(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    m = x.min()
    return m if group is None else _all_reduce(m, dist.ReduceOp.MIN, group)


def gmax(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    m = x.max()
    return m if group is None else _all_reduce(m, dist.ReduceOp.MAX, group)


def pmean_tree(tree: Any, group: Any = None) -> Any:
    """The mean of every leaf over the processes of ``group`` (the tree
    itself when ``None``), by one all-reduce of one flat tensor: leaves
    are tensors in nested dicts, lists and tuples."""
    if group is None:
        return tree
    leaves: list[torch.Tensor] = []
    _map(leaves.append, tree)
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    flat = _all_reduce(flat, dist.ReduceOp.SUM, group) / dist.get_world_size(group)
    pieces = iter(flat.split([leaf.numel() for leaf in leaves]))
    return _map(lambda leaf: next(pieces).view_as(leaf).to(leaf.dtype), tree)


def _gather_rows(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Every process's ``x`` (equal shapes) concatenated along dim 0 in rank
    order. Gloo gathers only host tensors, so a card tensor goes through
    host memory there."""
    host = dist.get_backend(group) != "nccl" and x.device.type != "cpu"
    src = x.cpu() if host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


# ----------------------------------------------------------------------
# Host values agreed on by every process (checkpoints, preemption)
# ----------------------------------------------------------------------


def _world() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _host_tensor(value: int) -> torch.Tensor:
    """An int64 tensor on the device the default group's backend reduces."""
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    return torch.tensor([value], dtype=torch.int64, device=device)


def _broadcast_int(value: int) -> int:
    """Process 0's ``value``, on every process (``value`` itself alone)."""
    if _world() == 1:
        return value
    t = _host_tensor(value)
    dist.broadcast(t, src=0)
    return int(t.item())


def _max_int(value: int) -> int:
    """The largest ``value`` over the processes (``value`` itself alone)."""
    if _world() == 1:
        return value
    t = _host_tensor(value)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def _barrier() -> None:
    """Hold every process of a multi-process run here until all arrive."""
    if _world() > 1:
        dist.barrier()
