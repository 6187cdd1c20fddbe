"""The port's parallel layer (``rl8_tpu_torch/parallel``) on the CPU: two
gloo processes, spawned, rendezvous through a file, held against
``rl8_tpu.parallel`` under ``shard_map`` on two of the conftest's eight
CPU devices: the global reductions (``gstd``'s cancellation case
included), ``pmean_tree`` as one all-reduce, the mesh, and placement by
field (coincidental and ambiguous dimensions, rl8_tpu's error text).

JAX is imported inside the tests only: the spawned processes import this
module and run the port alone. ``spawn_pair`` is shared with the other
multi-process test files."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import rl8_tpu_torch.parallel as tp
from rl8_tpu_torch import AlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.env import DiscreteDummyEnv

#: Seconds a spawned pair may take (a pair starts in ~3 s on the CPU).
PAIR_TIMEOUT = 120
#: f32 reductions in other orders (shard means of means, two-pass std).
RTOL, ATOL = 1e-5, 1e-6


def spawn_pair(fn, tmp_path: Path, *args, timeout: float = PAIR_TIMEOUT) -> None:
    """Run ``fn(rank, rdzv, *args)`` in two spawned processes that join one
    gloo group through a file under ``tmp_path``; raise what a worker
    raised, and kill both if they outlast ``timeout`` seconds."""
    rdzv = tmp_path / f"rdzv-{time.monotonic_ns()}"
    ctx = torch.multiprocessing.spawn(fn, args=(str(rdzv), *args), nprocs=2, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the spawned pair did not finish within {timeout} s")


def join_group(rank: int, rdzv: str) -> None:
    """A worker's first call: join the two-process gloo group."""
    tp.initialize_multihost(f"file://{rdzv}", 2, rank, cpu_collectives="gloo")


class StubMesh:
    """The two calls the placement functions make of a mesh."""

    def __init__(self, rank: int, world: int) -> None:
        self.rank, self.world = rank, world

    def get_local_rank(self, axis_name: str = tp.ENV_AXIS) -> int:
        return self.rank

    def size(self) -> int:
        return self.world


def _data() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    return {
        "normal": (3.0 * rng.normal(size=(16, 5)) + 1.0).astype(np.float32),
        # |mean| >> std: one-pass E[x^2] - E[x]^2 cancels in f32.
        "cancellation": (1e5 + np.linspace(0.0, 1.0, 64)).reshape(8, 8).astype(np.float32),
    }


def _collectives_worker(rank: int, rdzv: str, out: str) -> None:
    join_group(rank, rdzv)
    try:
        mesh = tp.create_mesh()
        group = mesh.get_group(tp.ENV_AXIS)
        got: dict = {"mesh": (mesh.size(), mesh.mesh_dim_names, mesh.get_local_rank(tp.ENV_AXIS))}
        for key, x in _data().items():
            shard = torch.from_numpy(x).chunk(2)[rank]
            for name in ("gmean", "gstd", "gmin", "gmax"):
                got[f"{name}/{key}"] = float(getattr(tp, name)(shard, group))
        shard = torch.from_numpy(_data()["normal"]).chunk(2)[rank]
        calls = tp._all_reduce.calls
        got["pmean_tree"] = tp.pmean_tree({"a": shard, "b": (shard.sum(), shard[0])}, group)
        got["pmean_tree_calls"] = tp._all_reduce.calls - calls
        algo = AlgorithmConfig(num_envs=16, horizon=4, model_config={"hiddens": (16,)}, device="cpu").build(
            DiscreteDummyEnv
        )
        algo.collect()
        placed = tp.shard_state(algo.state, mesh, 16)
        got["placed"] = (placed.env_state["position"], placed.buffer[DataKeys.REWARDS], algo.state)
        torch.save(got, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pair(tmp_path_factory) -> list[dict]:
    tmp = tmp_path_factory.mktemp("collectives")
    spawn_pair(_collectives_worker, tmp, str(tmp))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _jax_shard_map(name: str, x: np.ndarray) -> float:
    """``rl8_tpu.parallel``'s reduction ``name`` under ``shard_map`` over two
    devices, each holding half of ``x``'s rows."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from rl8_tpu import parallel as jp

    mesh = jp.create_mesh(jax.devices()[:2])
    fn = jax.shard_map(
        partial(getattr(jp, name), axis_name=jp.ENV_AXIS), mesh=mesh, in_specs=P(jp.ENV_AXIS), out_specs=P(),
        check_vma=False,
    )
    return float(jax.jit(fn)(jnp.asarray(x)))


def test_port_exports_every_name_of_rl8_tpu_parallel() -> None:
    from rl8_tpu import parallel as jp

    assert set(jp.__all__) <= set(tp.__all__)
    assert tp.ENV_AXIS == jp.ENV_AXIS == "env"


def test_reductions_without_a_group_are_local() -> None:
    x = torch.from_numpy(_data()["normal"])
    assert torch.equal(tp.gmean(x), x.mean())
    assert torch.equal(tp.gstd(x), x.std(correction=1))
    assert torch.equal(tp.gmin(x), x.min())
    assert torch.equal(tp.gmax(x), x.max())
    tree = {"a": x, "b": (x.sum(),)}
    assert tp.pmean_tree(tree) is tree


@pytest.mark.parametrize("key", ["normal", "cancellation"])
@pytest.mark.parametrize("name", ["gmean", "gstd", "gmin", "gmax"])
def test_global_reductions_match_shard_map(pair, name: str, key: str) -> None:
    """Each rank's answer over the group equals ``rl8_tpu``'s under
    ``shard_map`` on the same rows, and the two ranks agree bit for bit."""
    want = _jax_shard_map(name, _data()[key])
    assert pair[0][f"{name}/{key}"] == pair[1][f"{name}/{key}"]
    np.testing.assert_allclose(pair[0][f"{name}/{key}"], want, rtol=RTOL, atol=ATOL)
    if name == "gstd":
        np.testing.assert_allclose(want, np.std(_data()[key].astype(np.float64), ddof=1), rtol=1e-3)


def test_pmean_tree_is_one_all_reduce_and_matches_jax(pair) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from rl8_tpu import parallel as jp

    x = _data()["normal"]
    mesh = jp.create_mesh(jax.devices()[:2])

    def body(shard):
        return jp.pmean_tree({"a": shard, "b": (shard.sum(), shard[0])}, jp.ENV_AXIS)

    fn = jax.shard_map(body, mesh=mesh, in_specs=P(jp.ENV_AXIS), out_specs=P(), check_vma=False)
    want = jax.device_get(jax.jit(fn)(jnp.asarray(x)))
    for got in pair:
        assert got["pmean_tree_calls"] == 1
        np.testing.assert_allclose(got["pmean_tree"]["a"].numpy(), want["a"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(got["pmean_tree"]["b"][0]), float(want["b"][0]), rtol=RTOL)
        np.testing.assert_allclose(got["pmean_tree"]["b"][1].numpy(), want["b"][1], rtol=RTOL, atol=ATOL)
    assert torch.equal(pair[0]["pmean_tree"]["a"], pair[1]["pmean_tree"]["a"])


def test_create_mesh_spans_the_group(pair) -> None:
    assert [got["mesh"] for got in pair] == [(2, ("env",), 0), (2, ("env",), 1)]


def test_shard_state_keeps_each_rank_rows_on_a_mesh(pair) -> None:
    """On a real two-process mesh, each process keeps its half of the env
    state's rows and of the buffer's env columns."""
    for rank, got in enumerate(pair):
        position, rewards, whole = got["placed"]
        assert torch.equal(position, whole.env_state["position"][rank * 8 : (rank + 1) * 8])
        assert torch.equal(rewards, whole.buffer[DataKeys.REWARDS][:, rank * 8 : (rank + 1) * 8])


def test_create_mesh_needs_a_process_group() -> None:
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        tp.create_mesh()


def test_initialize_multihost_takes_all_three_arguments_or_none() -> None:
    with pytest.raises(ValueError, match="together"):
        tp.initialize_multihost("localhost:1234", 2)


def test_initialize_multihost_raises_for_nccl_without_a_card(tmp_path) -> None:
    """NCCL is the default; without a card it raises, naming gloo, and
    never falls back to it."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="cpu_collectives='gloo'"):
        tp.initialize_multihost(f"file://{tmp_path / 'rdzv'}", 1, 0)
    assert not dist.is_initialized()


def _port_algo(hiddens=(16, 16)):
    algo = AlgorithmConfig(num_envs=16, horizon=4, model_config={"hiddens": hiddens}, device="cpu").build(
        DiscreteDummyEnv
    )
    algo.collect()
    return algo


def test_state_pspecs_are_field_driven_like_jax() -> None:
    """Placement by field, as ``rl8_tpu``'s: with a hidden width equal to
    ``num_envs`` the optimizer state stays replicated, the buffer shards on
    axis 1 and the env state on axis 0; every leaf's placement matches
    ``rl8_tpu``'s ``PartitionSpec`` for the same field."""
    import jax
    from jax.sharding import PartitionSpec as P
    from torch.distributed.tensor import Replicate, Shard

    from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
    from rl8_tpu.env import DiscreteDummyEnv as JDiscreteDummyEnv
    from rl8_tpu.parallel import state_pspecs as jstate_pspecs

    specs = tp.state_pspecs(_port_algo().state, 16)
    jalgo = JAlgorithmConfig(num_envs=16, horizon=4, model_config={"hiddens": (16, 16)}).build(JDiscreteDummyEnv)
    jspecs = jstate_pspecs(jalgo.state, 16)
    as_jax = {Shard(0): P(tp.ENV_AXIS), Shard(1): P(None, tp.ENV_AXIS), Replicate(): P()}
    for field in ("env_state", "buffer"):
        for key, spec in getattr(specs, field).items():
            assert as_jax[spec] == getattr(jspecs, field)[key], (field, key)
    assert specs.env_state == {"position": Shard(0), "bounds": Replicate()}
    assert set(specs.buffer.values()) == {Shard(1)}
    for leaf in (specs.opt_state.m, specs.opt_state.v, specs.opt_state.count, specs.reward_scale, specs.horizons):
        assert leaf == Replicate()
    for leaf in jax.tree_util.tree_leaves((jspecs.params, jspecs.opt_state), is_leaf=lambda x: isinstance(x, P)):
        assert leaf == P()


@pytest.mark.parametrize(
    "shape,time_major", [((3, 16), False), ((16, 3, 1), True)], ids=["env-state", "time-major"]
)
def test_ambiguous_leaf_raises_jax_error(shape: tuple, time_major: bool) -> None:
    """A leaf carrying ``num_envs`` off its batch axis raises ``rl8_tpu``'s
    ``ValueError``, word for word."""
    import jax.numpy as jnp

    from rl8_tpu.parallel import _batch_leaf_spec as jspec

    with pytest.raises(ValueError, match="Ambiguous") as want:
        jspec(jnp.zeros(shape), 16, tp.ENV_AXIS, time_major)
    with pytest.raises(ValueError, match="Ambiguous") as got:
        tp._batch_leaf_spec(torch.zeros(shape), 16, tp.ENV_AXIS, time_major)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_state_keeps_rows_and_replicates_the_rest(rank: int) -> None:
    """Each rank keeps its rows of the env state (axis 0) and its columns
    of the buffer (axis 1), contiguous copies; the scalar env config,
    the optimizer state (a 16-wide layer at ``num_envs=16``) and the
    counters stay whole."""
    algo = _port_algo(hiddens=(16,))
    state = tp.shard_state(algo.state, StubMesh(rank, 2), 16)
    rows = slice(rank * 8, (rank + 1) * 8)
    assert torch.equal(state.env_state["position"], algo.state.env_state["position"][rows])
    assert state.env_state["bounds"] is algo.state.env_state["bounds"]
    for key, leaf in algo.state.buffer.items():
        assert state.buffer[key].is_contiguous()
        assert torch.equal(state.buffer[key], leaf[:, rows]), key
    assert state.opt_state is algo.state.opt_state
    assert (state.horizons, state.buffered) == (algo.state.horizons, algo.state.buffered)


def test_shard_state_rejects_an_ambiguous_env_state() -> None:
    algo = _port_algo()
    algo.state.env_state["table"] = torch.zeros((3, 16))
    with pytest.raises(ValueError, match="Ambiguous"):
        tp.shard_state(algo.state, StubMesh(0, 2), 16)


def test_shard_batch_needs_an_even_split() -> None:
    with pytest.raises(ValueError, match="divide evenly"):
        tp.shard_batch({"x": torch.zeros((15, 2))}, StubMesh(0, 2), 15)
