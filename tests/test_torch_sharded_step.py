"""Multi-device training on the CPU: the port's algorithms on a mesh of two
spawned gloo processes (and of one, in this process), held against
``rl8_tpu``.

- ``shard_map`` mode: one ``step()`` from the same parameters and buffer
  at world 2 against ``rl8_tpu``'s ``shard_map`` step on two of the
  conftest's CPU devices, for the discrete and the recurrent cell, with a
  whole-buffer minibatch (so the per-shard shuffle drops out);
  parameters bit-identical across the ranks after every step of three
  iterations; the divisibility errors' text.
- exact mode: the single-device run of the same routes (the kernels off)
  from the same seed, as ``tests/test_parallel.py`` holds ``rl8_tpu``'s
  GSPMD mode, on its config and with its tolerances, plus shuffled
  minibatches (the all-gather path) and the recurrent cell.
- a one-process mesh: the unsharded run, since rank 0 draws the
  unsharded streams (only the global std's two passes round otherwise).
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

import rl8_tpu_torch.parallel as tp
from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.env import DiscreteDummyEnv
from rl8_tpu_torch.models import load_jax_params, to_jax_params
from tests.test_torch_parallel import join_group, spawn_pair

STAT_KEYS = ("losses/entropy", "losses/policy", "losses/vf", "losses/total", "monitors/kl_div")
#: shard_map step against rl8_tpu's, as tests/test_torch_step.py holds the
#: unsharded step: losses to ~1e-6 relative, parameters by a norm-relative
#: error of their change (Adam divides each gradient by its magnitude).
STAT_RTOL, STAT_ATOL, DELTA_REL = 1e-4, 1e-6, 1e-3
#: Exact mode against the single-device run: tests/test_parallel.py's
#: limits for rl8_tpu's GSPMD mode.
EXACT_STAT_ATOL, EXACT_RTOL, EXACT_ATOL = 1e-4, 1e-4, 1e-6

#: The two cells of the shard_map comparison (tests/test_torch_step.py's
#: and tests/test_torch_recurrent_step.py's sizes).
CELLS = {
    "discrete": dict(num_envs=64, horizon=8, model_config={"hiddens": (32, 32)}, seed=3),
    "recurrent": dict(
        num_envs=32, horizon=8, seq_len=2, seqs_per_state_reset=2, model_config={"hidden_size": 16, "num_layers": 2},
        seed=3,
    ),
}
#: Exact-mode cases: tests/test_parallel.py's config, shuffled minibatches
#: (a minibatch mixes both processes' rows) and the recurrent cell.
EXACT = {
    "jax-config": (AlgorithmConfig, dict(num_envs=16, horizon=4, model_config={"hiddens": (8,)}, seed=3,
                                         entropy_coeff=0.01)),
    "shuffled": (AlgorithmConfig, dict(num_envs=16, horizon=8, model_config={"hiddens": (16, 16)}, seed=5,
                                       sgd_minibatch_size=32)),
    "recurrent": (RecurrentAlgorithmConfig, dict(num_envs=16, horizon=8, seq_len=2, seqs_per_state_reset=2,
                                                 model_config={"hidden_size": 8}, seed=5, sgd_minibatch_size=16)),
}
#: Configurations that a mesh of 2 does not divide, for the error text.
INDIVISIBLE = {
    "num_envs": dict(num_envs=15, horizon=4, model_config={"hiddens": (8,)}),
    "sgd_minibatch_size": dict(num_envs=16, horizon=3, sgd_minibatch_size=3, model_config={"hiddens": (8,)}),
}


def _config_cls(kind: str):
    return RecurrentAlgorithmConfig if kind == "recurrent" else AlgorithmConfig


def _params(algo) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in algo.policy.model.parameters()])


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _iterations(algo, n: int) -> list[dict]:
    records = []
    for _ in range(n):
        record = dict(algo.collect())
        record.update(algo.step())
        record["params"] = _params(algo)
        records.append(record)
    return records


def _worker(rank: int, rdzv: str, tmp: str) -> None:
    join_group(rank, rdzv)
    try:
        mesh = tp.create_mesh()
        out: dict = {}
        with open(f"{tmp}/inputs.pkl", "rb") as f:
            inputs = pickle.load(f)
        for kind, given in inputs.items():
            algo = _config_cls(kind)(**CELLS[kind], device="cpu", mesh=mesh).build(DiscreteDummyEnv)
            load_jax_params(algo.policy.model, given["params"])
            algo.state.buffer = tp.shard_batch(_to_torch(given["buffer"]), mesh, CELLS[kind]["num_envs"], time_major=True)
            algo.state.reward_scale = torch.tensor(given["reward_scale"])
            algo.state.horizons, algo.state.buffered = given["horizons"], True
            stats = algo.step()
            out[f"step/{kind}"] = (stats, to_jax_params(algo.policy.model), int(algo.state.opt_state.count))
            algo = _config_cls(kind)(**CELLS[kind], device="cpu", mesh=mesh).build(DiscreteDummyEnv)
            out[f"shard_map/{kind}"] = _iterations(algo, 3)
            out[f"shard_map_buffer/{kind}"] = {k: tuple(v.shape) for k, v in algo.state.buffer.items()
                                              if isinstance(v, torch.Tensor)}
        for name, (cls, cfg) in EXACT.items():
            algo = cls(**cfg, device="cpu", mesh=mesh, exact_sharding=True).build(DiscreteDummyEnv)
            out[f"exact_flags/{name}"] = (algo._fused_act, algo._fused_update, algo._gae_kernel, algo._axis)
            out[f"exact/{name}"] = _iterations(algo, 2)
        for name, cfg in INDIVISIBLE.items():
            with pytest.raises(ValueError) as info:
                AlgorithmConfig(**cfg, device="cpu", mesh=mesh).build(DiscreteDummyEnv)
            out[f"indivisible/{name}"] = str(info.value)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_shard_map_step(kind: str) -> tuple[dict, dict]:
    """``rl8_tpu``'s ``shard_map`` step on two devices: the inputs the
    port gets (parameters with the logits head re-drawn, the collected
    buffer, the reward scale) and what the step returned."""
    import jax
    import jax.numpy as jnp

    from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
    from rl8_tpu import RecurrentAlgorithmConfig as JRecurrentAlgorithmConfig
    from rl8_tpu.env import DiscreteDummyEnv as JDiscreteDummyEnv
    from rl8_tpu.parallel import create_mesh as jcreate_mesh

    cls = JRecurrentAlgorithmConfig if kind == "recurrent" else JAlgorithmConfig
    jalgo = cls(**CELLS[kind], mesh=jcreate_mesh(jax.devices()[:2])).build(JDiscreteDummyEnv)
    params = jax.device_get(jalgo.state.params)
    head = params["feature_head"]["kernel"]
    params["feature_head"]["kernel"] = (0.5 * np.random.default_rng(1).normal(size=head.shape)).astype(np.float32)
    jalgo.state = jalgo.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    jalgo.collect()
    inputs = {
        "params": params,
        "buffer": jax.device_get(jalgo.state.buffer),
        "reward_scale": float(jalgo.state.reward_scale),
        "horizons": int(jalgo.state.horizons),
    }
    stats = jalgo.step()
    count = int(jax.tree_util.tree_leaves(jalgo.state.opt_state.inner_state)[0])
    return inputs, (stats, jax.device_get(jalgo.state.params), count)


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> tuple[dict, list[dict]]:
    """``rl8_tpu``'s inputs and steps by cell, and both ranks' results of
    one spawned pair."""
    tmp = tmp_path_factory.mktemp("sharded")
    jax_runs = {kind: _jax_shard_map_step(kind) for kind in CELLS}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({kind: inputs for kind, (inputs, _) in jax_runs.items()}, f)
    spawn_pair(_worker, tmp, str(tmp))
    return jax_runs, [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _flat(tree) -> np.ndarray:
    import jax

    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("kind", list(CELLS))
def test_step_matches_jax_shard_map(runs, kind: str) -> None:
    """One ``step()`` of each package on a mesh of two from the same
    parameters and buffer: the stats, the parameters afterwards (flax
    layout) and Adam's count; both ranks end with the same bits."""
    jax_runs, ranks = runs
    inputs, (jstats, jparams, jcount) = jax_runs[kind]
    tstats, tparams, tcount = ranks[0][f"step/{kind}"]
    for key in STAT_KEYS:
        assert math.isclose(tstats[key], jstats[key], rel_tol=STAT_RTOL, abs_tol=STAT_ATOL), (key, tstats[key], jstats[key])
    assert all(ranks[1][f"step/{kind}"][0][key] == tstats[key] for key in STAT_KEYS)
    start = _flat(inputs["params"])
    jdelta, tdelta = _flat(jparams) - start, _flat(tparams) - start
    assert np.linalg.norm(jdelta) > 0
    assert np.linalg.norm(tdelta - jdelta) <= DELTA_REL * np.linalg.norm(jdelta)
    assert np.array_equal(_flat(ranks[1][f"step/{kind}"][1]), _flat(tparams))
    assert tcount == jcount


@pytest.mark.parametrize("kind", list(CELLS))
def test_shard_map_ranks_stay_identical(runs, kind: str) -> None:
    """Three collect+step iterations on a mesh of two: after every step the
    parameters are bit-identical on both ranks, and so is every global
    statistic (the reductions hand both ranks the same bytes); each rank
    holds its half of the envs, and the run learns something."""
    _, ranks = runs
    a, b = ranks[0][f"shard_map/{kind}"], ranks[1][f"shard_map/{kind}"]
    for ra, rb in zip(a, b):
        assert torch.equal(ra["params"], rb["params"])
        for key in ra:
            if key.startswith(("returns/", "rewards/", "losses/", "monitors/", "env/")):
                assert ra[key] == rb[key], key
    assert not torch.equal(a[0]["params"], a[-1]["params"])
    assert a[0]["env/steps"] == CELLS[kind]["num_envs"] * CELLS[kind]["horizon"]
    n = CELLS[kind]["num_envs"] // 2
    shapes = ranks[0][f"shard_map_buffer/{kind}"]
    assert shapes[DataKeys.REWARDS] == (CELLS[kind]["horizon"], n, 1)


def _single_device(name: str) -> list[dict]:
    cls, cfg = EXACT[name]
    algo = cls(**cfg, device="cpu", fused_act=False, fused_update=False).build(DiscreteDummyEnv)
    return _iterations(algo, 2)


@pytest.mark.parametrize("name", list(EXACT))
def test_exact_mode_matches_the_single_device_run(runs, name: str) -> None:
    """``exact_sharding=True`` on a mesh of two computes the single-device
    run of the same routes (the kernels off, as ``rl8_tpu``'s gates take
    them off in this mode) from the same seed: two iterations, stats
    within 1e-4 and parameters within rtol 1e-4, atol 1e-6
    (``tests/test_parallel.py``'s limits), the same on both ranks."""
    _, ranks = runs
    assert ranks[0][f"exact_flags/{name}"] == (False, False, False, None)
    want = _single_device(name)
    for rank in ranks:
        for got, ref in zip(rank[f"exact/{name}"], want):
            for key in (*STAT_KEYS, "returns/mean", "returns/std", "rewards/min", "rewards/max"):
                assert abs(got[key] - ref[key]) < EXACT_STAT_ATOL * max(1.0, abs(ref[key])), (key, got[key], ref[key])
            torch.testing.assert_close(got["params"], ref["params"], rtol=EXACT_RTOL, atol=EXACT_ATOL)
    assert torch.equal(ranks[0][f"exact/{name}"][-1]["params"], ranks[1][f"exact/{name}"][-1]["params"])


@pytest.mark.parametrize("name", list(INDIVISIBLE))
def test_indivisible_configurations_raise_jax_error(runs, name: str) -> None:
    """A mesh that does not divide ``num_envs`` or the minibatch raises
    ``ValueError`` in both packages, with ``rl8_tpu``'s text
    (``rl8_tpu/algorithms/_base.py:94-103``; for ``num_envs`` its state
    placement raises first, with XLA's words)."""
    import jax

    from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
    from rl8_tpu.env import DiscreteDummyEnv as JDiscreteDummyEnv
    from rl8_tpu.parallel import create_mesh as jcreate_mesh

    with pytest.raises(ValueError) as want:
        JAlgorithmConfig(**INDIVISIBLE[name], mesh=jcreate_mesh(jax.devices()[:2])).build(JDiscreteDummyEnv)
    got = runs[1][0][f"indivisible/{name}"]
    if name == "num_envs":
        assert got == "`num_envs` (15) must divide evenly over the mesh's 2 devices."
    else:
        assert got == str(want.value)


@pytest.fixture
def one_process_group(tmp_path):
    """A gloo group of this process alone, destroyed after the test."""
    tp.initialize_multihost(f"file://{tmp_path / 'rdzv'}", 1, 0, cpu_collectives="gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize(
    "kind,exact", [("discrete", False), ("recurrent", False), ("discrete", True)],
    ids=["discrete", "recurrent", "exact"],
)
def test_one_process_mesh_reproduces_the_unsharded_run(one_process_group, kind: str, exact: bool) -> None:
    """``mesh=create_mesh()`` over one process builds and trains; rank 0
    draws the unsharded streams and a one-process all-reduce returns its
    input, so the run is the unsharded one (the same actions) but for the
    two-pass global std's rounding of the reward scale and the advantage
    normalization."""
    cfg = dict(CELLS[kind], num_envs=16, sgd_minibatch_size=32)
    if exact:
        cfg.update(fused_act=False, fused_update=False)
    runs = []
    for mesh in (None, tp.create_mesh()):
        algo = _config_cls(kind)(**cfg, device="cpu", mesh=mesh, exact_sharding=exact).build(DiscreteDummyEnv)
        records = []
        for _ in range(2):
            records.append(dict(algo.collect()))
            records[-1]["actions"] = algo.state.buffer[DataKeys.ACTIONS].clone()
            records[-1].update(algo.step())
        runs.append((records, _params(algo)))
    (want, want_params), (got, got_params) = runs
    for g, w in zip(got, want):
        assert torch.equal(g["actions"], w["actions"])
        for key in (*STAT_KEYS, "returns/mean", "returns/std"):
            assert math.isclose(g[key], w[key], rel_tol=1e-5, abs_tol=1e-6), key
    torch.testing.assert_close(got_params, want_params, rtol=1e-5, atol=1e-6)


def test_exact_sharding_without_a_mesh_is_the_unsharded_run() -> None:
    """As in ``rl8_tpu`` (``_init_sharding`` returns before reading it),
    ``exact_sharding=True`` without a mesh changes nothing: the kernels'
    routes stay on and the run is bit for bit the default one."""
    cfg = dict(CELLS["discrete"], num_envs=16, device="cpu")
    default = AlgorithmConfig(**cfg).build(DiscreteDummyEnv)
    exact = AlgorithmConfig(**cfg, exact_sharding=True).build(DiscreteDummyEnv)
    assert (exact._fused_act, exact._fused_update, exact._gae_kernel, exact.mesh) == (True, True, True, None)
    want, got = _iterations(default, 1)[0], _iterations(exact, 1)[0]
    assert torch.equal(got.pop("params"), want.pop("params"))
    for key in STAT_KEYS:
        assert got[key] == want[key]
