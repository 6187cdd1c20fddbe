"""The PyTorch port's core contracts held against ``rl8_tpu`` on the CPU:
data keys, hyperparameter validation, specs, views, the dummy env, the
package's import boundary, and the device default."""

from __future__ import annotations

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl8_tpu.data as jdata
import rl8_tpu.env as jenv
import rl8_tpu.specs as jspecs
import rl8_tpu.views as jviews
import rl8_tpu_torch.data as tdata
import rl8_tpu_torch.env as tenv
import rl8_tpu_torch.specs as tspecs
import rl8_tpu_torch.views as tviews

REPO = Path(__file__).resolve().parent.parent


def test_data_keys_match() -> None:
    def keys(cls):
        return {k: v for k, v in vars(cls).items() if k.isupper()}

    assert keys(tdata.DataKeys) == keys(jdata.DataKeys)


_GOOD = dict(
    accumulate_grads=False, clip_param=0.2, dual_clip_param=None, enable_amp=False,
    gae_lambda=0.95, gamma=0.95, horizon=32, horizons_per_env_reset=1,
    max_grad_norm=5.0, normalize_advantages=True, normalize_rewards=True,
    num_envs=64, num_sgd_iters=4, sgd_minibatch_size=64 * 32,
    shuffle_minibatches=True, shuffle_block_rows=8, target_kl_div=None,
    vf_clip_param=5.0, vf_coeff=1.0,
)


@pytest.mark.parametrize(
    "bad",
    [
        {},
        {"clip_param": 0.0}, {"clip_param": 1.0},
        {"dual_clip_param": 1.0},
        {"gae_lambda": 0.0}, {"gae_lambda": 1.5},
        {"gamma": 0.0}, {"gamma": 1.01},
        {"horizon": 0},
        {"horizons_per_env_reset": 0},
        {"max_grad_norm": 0.0},
        {"num_sgd_iters": 0},
        {"sgd_minibatch_size": 0},
        {"shuffle_block_rows": 0},
        {"target_kl_div": 0.0},
        {"target_kl_div": 0.01, "accumulate_grads": True, "sgd_minibatch_size": 64},
        {"vf_clip_param": 0.0},
        {"vf_coeff": 0.0},
        {"accumulate_grads": True},
        {"sgd_minibatch_size": 1000},
    ],
)
def test_hparams_reject_the_same_values(bad: dict) -> None:
    """Both packages accept or reject each configuration, with the same
    message (the empty override is the accepted baseline)."""
    kwargs = {**_GOOD, **bad}

    def outcome(cls):
        try:
            cls(**kwargs).validate()
        except ValueError as e:
            return str(e)
        return None

    expected = outcome(jdata.AlgorithmHparams)
    assert outcome(tdata.AlgorithmHparams) == expected
    assert (expected is None) == (bad == {})


@pytest.mark.parametrize(
    "name,args,kwargs,value",
    [
        ("Unbounded", (3,), {}, [[0.5, -2.0, 1e9]]),
        ("Bounded", (2,), {"low": -1.0, "high": 2.0}, [[0.0, 2.0]]),
        ("Bounded", (2,), {"low": -1.0, "high": 2.0}, [[0.0, 2.5]]),
        ("Discrete", (3,), {"shape": (2,)}, [[0, 2]]),
        ("Discrete", (3,), {"shape": (2,)}, [[0, 3]]),
        ("Discrete", (3,), {"shape": (2,)}, [[0.0, 1.0]]),
        ("Discrete", (3,), {"shape": (2,)}, [[0, 1, 2]]),
    ],
)
def test_specs_match(name: str, args: tuple, kwargs: dict, value: list) -> None:
    jspec = getattr(jspecs, name)(*args, **kwargs)
    tspec = getattr(tspecs, name)(*args, **kwargs)
    assert tspec.shape == jspec.shape
    assert tspec.contains(np.asarray(value)) == jspec.contains(np.asarray(value))
    np.testing.assert_array_equal(
        tspec.zero((4,)).numpy(), np.asarray(jspec.zero((4,)))
    )
    comp = tspecs.Composite(a=tspec)
    assert comp.contains({"a": torch.as_tensor(np.asarray(value))}) == jspecs.Composite(
        a=jspec
    ).contains({"a": np.asarray(value)})


def test_assert_nd_spec_matches() -> None:
    for mod in (jspecs, tspecs):
        mod.assert_nd_spec(mod.Composite(a=mod.Unbounded(2)))
        with pytest.raises(AssertionError):
            mod.assert_nd_spec(mod.Composite(a=mod.Unbounded(())))


@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("method", ["rolling_window", "padded_rolling_window"])
@pytest.mark.parametrize("kind", ["last", "all"])
def test_views_match(shift: int, method: str, kind: str) -> None:
    x = np.random.default_rng(shift).normal(size=(2, 5, 3)).astype(np.float32)
    jreq = jviews.ViewRequirement(shift=shift, method=method)
    treq = tviews.ViewRequirement(shift=shift, method=method)
    jout = getattr(jreq, f"apply_{kind}")("obs", {"obs": jnp.asarray(x)})
    tout = getattr(treq, f"apply_{kind}")("obs", {"obs": torch.from_numpy(x)})
    assert treq.drop_size == jreq.drop_size
    if isinstance(jout, dict):
        assert set(tout) == set(jout)
        for k in jout:
            np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    else:
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_discrete_dummy_env_step_matches() -> None:
    rng = np.random.default_rng(0)
    pos = rng.uniform(-10, 10, size=(16, 1)).astype(np.float32)
    jstate = {"position": jnp.asarray(pos), "bounds": jnp.asarray(10.0)}
    tstate = {"position": torch.from_numpy(pos), "bounds": torch.tensor(10.0)}
    jdummy, tdummy = jenv.DiscreteDummyEnv(16), tenv.DiscreteDummyEnv(16, device="cpu")
    assert tdummy.action_spec.n == jdummy.action_spec.n
    for _ in range(3):
        actions = rng.integers(0, 2, size=(16, 1)).astype(np.int32)
        jstate, jobs, jrew = jdummy.step(jstate, jnp.asarray(actions))
        tstate, tobs, trew = tdummy.step(tstate, torch.from_numpy(actions))
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))


def test_dummy_env_reset_bounds() -> None:
    env = tenv.DiscreteDummyEnv(1000, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen, config={"bounds": 3.0})
    assert obs.shape == (1000, 1) and float(obs.abs().max()) <= 3.0
    state, obs = env.reset(gen, state=state)  # bounds persist
    assert float(obs.abs().max()) <= 3.0 and float(state["bounds"]) == 3.0
    cont = tenv.ContinuousDummyEnv(2, device="cpu")
    _, obs, rew = cont.step({"position": torch.zeros(2, 1), "bounds": torch.tensor(1.0)}, torch.ones(2, 1))
    assert obs.tolist() == [[1.0], [1.0]] and rew.tolist() == [[-1.0], [-1.0]]


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rl8_tpu")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(REPO).as_posix() for p in (REPO / "rl8_tpu_torch").rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_port_imports_no_jax(path: str) -> None:
    """No module of the port, and not chip_smoke.py, imports JAX, flax,
    optax or the JAX package (read from the source: the interpreter may
    have imported JAX at startup, so sys.modules proves nothing)."""
    assert not (_imported_roots(REPO / path) & set(_FORBIDDEN))


@pytest.mark.parametrize(
    "module_name",
    [
        "rl8_tpu_torch.specs",
        "rl8_tpu_torch.data",
        "rl8_tpu_torch.env",
        "rl8_tpu_torch.views",
        "rl8_tpu_torch.distributions",
        "rl8_tpu_torch.nn.functional",
        "rl8_tpu_torch.models._feedforward",
        "rl8_tpu_torch.models._recurrent",
        "rl8_tpu_torch.policies._recurrent",
        "rl8_tpu_torch.utils",
        "rl8_tpu_torch.algorithms._feedforward",
        "rl8_tpu_torch.algorithms._recurrent",
    ],
)
def test_port_doctests(module_name: str) -> None:
    import doctest
    import importlib

    results = doctest.testmod(
        importlib.import_module(module_name),
        optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE,
    )
    assert results.failed == 0
    assert results.attempted > 0


def test_build_defaults_to_cuda() -> None:
    from rl8_tpu_torch import AlgorithmConfig

    assert AlgorithmConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build would succeed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AlgorithmConfig(num_envs=4, horizon=2).build(tenv.DiscreteDummyEnv)
