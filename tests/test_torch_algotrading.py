"""The algotrading example of the port (``rl8_tpu_torch/examples/algotrading``)
held against ``examples/algotrading`` on the CPU: the env's transition,
``OneHotEmbed``, ``MischievousMule``'s module forward and its fused apply
(forward and gradients) against flax, the flax-tree conversion, and the
port's import boundary."""

from __future__ import annotations

import ast
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.algotrading.env import AlgoTrading as JAlgoTrading
from examples.algotrading.models import MischievousMule as JMischievousMule
from rl8_tpu.nn import OneHotEmbed as JOneHotEmbed
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule
from rl8_tpu_torch.models import load_jax_params, to_jax_params
from rl8_tpu_torch.nn import OneHotEmbed
from rl8_tpu_torch.ops import fused_custom_apply, supports_fused_apply
from rl8_tpu_torch.views import tree_map

REPO = Path(__file__).resolve().parent.parent
#: The env's log changes are differences of logs of prices up to 1e4
#: (~9.2), so an ulp of difference between XLA's and ATen's log or sin
#: (~1e-6 there) is an absolute error on a value near 0.
ENV_RTOL, ENV_ATOL = 1e-6, 4e-6
#: f32 on both sides from the same parameters, other summation orders.
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
HIDDENS = (32, 32)


def _env_state(B: int, seed: int) -> dict:
    """A mid-episode AlgoTrading state as numpy arrays: half the envs
    invested, positions near the price."""
    rng = np.random.default_rng(seed)
    invested = rng.integers(0, 2, size=(B, 1)).astype(np.int32)
    price = rng.uniform(100.0, 10_000.0, size=(B, 1))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "bounds": {"f_bounds": f32(math.pi), "k_cyclic_bounds": f32(0.05), "k_market_bounds": f32(0.05)},
        "action_mask": np.concatenate([np.ones_like(invested, bool), invested == 0, invested == 1], axis=1),
        "invested": invested,
        "position": f32(price * rng.uniform(0.8, 1.2, size=(B, 1))),
        "f": f32(rng.uniform(0.0, math.pi, size=(B, 1))),
        "k_cyclic": f32(rng.uniform(-0.05, 0.05, size=(B, 1))),
        "k_market": f32(rng.uniform(-0.05, 0.05, size=(B, 1))),
        "t": f32(rng.integers(0, 40, size=(B, 1))),
        "price": f32(price),
        "log_change_price": f32(rng.normal(scale=0.05, size=(B, 1))),
        "log_change_price_position": f32(rng.normal(scale=0.1, size=(B, 1))),
    }


def _valid_actions(mask: np.ndarray, seed: int) -> np.ndarray:
    """One valid action per env: a uniform choice among the unmasked."""
    rng = np.random.default_rng(seed)
    scores = np.where(mask, rng.uniform(size=mask.shape), -1.0)
    return scores.argmax(axis=1).astype(np.int32)[:, None]


def _assert_tree_close(got, want, path: str = "") -> None:
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_tree_close(got[key], want[key], f"{path}/{key}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, rtol=ENV_RTOL, atol=ENV_ATOL, err_msg=path)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_env_step_matches_jax(seed: int) -> None:
    """One transition of each package's env from the same state and
    valid actions: the new state, observations and rewards."""
    B = 256
    state = _env_state(B, seed)
    actions = _valid_actions(state["action_mask"], seed + 100)
    jenv, tenv = JAlgoTrading(B), AlgoTrading(B, device="cpu")
    j_state, j_obs, j_rew = jenv.step(jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(actions))
    t_state, t_obs, t_rew = tenv.step(tree_map(torch.from_numpy, state), torch.from_numpy(actions))
    to_np = lambda tree: tree_map(lambda t: t.numpy(), tree)  # noqa: E731
    _assert_tree_close(to_np(t_state), jax.device_get(j_state))
    _assert_tree_close(to_np(t_obs), jax.device_get(j_obs))
    _assert_tree_close(t_rew.numpy(), np.asarray(j_rew))
    assert set(np.unique(actions)) == {0, 1, 2}


def test_env_reset_and_specs() -> None:
    """Specs as the JAX env's (the bool action mask), resets within their
    bounds from the env's generator, and reset config that persists."""
    env = AlgoTrading(500, device="cpu")
    jspec = JAlgoTrading(500).observation_spec
    assert set(env.observation_spec) == set(jspec)
    for key in jspec:
        assert env.observation_spec[key].shape == jspec[key].shape, key
    assert env.observation_spec["action_mask"].dtype == torch.bool
    assert env.action_spec.n == 3 and env.action_spec.shape == (1,)
    assert AlgoTrading.max_horizon == JAlgoTrading.max_horizon == 128
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen, config={"f_bounds": 0.5})
    env.observation_spec.assert_is_in(obs)
    assert obs["action_mask"].tolist()[0] == [True, True, False] and int(obs["invested"].sum()) == 0
    assert float(state["f"].max()) <= 0.5 and 100.0 <= float(state["price"].min()) <= float(state["price"].max()) <= 1e4
    assert float(state["k_cyclic"].abs().max()) <= 0.05 and set(state["t"].unique().tolist()) <= set(range(10))
    state2, _ = env.reset(gen, state=state)
    assert float(state2["bounds"]["f_bounds"]) == 0.5 and not torch.equal(state2["price"], state["price"])


def test_one_hot_embed_matches_flax_and_its_init() -> None:
    """Lookups equal flax's for one table; the table's gradient is the
    one-hot sum; the init is a plain normal with std sqrt(1 / features),
    as flax's ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)``."""
    table = np.random.default_rng(0).normal(size=(2, 5)).astype(np.float32)
    idx = np.array([1, 0, 1, 1], np.int32)
    want = JOneHotEmbed(2, 5).apply({"params": {"embedding": jnp.asarray(table)}}, jnp.asarray(idx))
    embed = OneHotEmbed(2, 5)
    with torch.no_grad():
        embed.embedding.copy_(torch.from_numpy(table))
    got = embed(torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.sum().backward()
    np.testing.assert_array_equal(embed.embedding.grad.numpy(), np.array([[1.0] * 5, [3.0] * 5]))

    F = 4096
    big = OneHotEmbed(2, F)
    big.reset_parameters(torch.Generator().manual_seed(1))
    jtable = JOneHotEmbed(2, F).init(jax.random.key(1), jnp.zeros((1,), jnp.int32))["params"]["embedding"]
    for values in (big.embedding.detach().numpy(), np.asarray(jtable)):
        assert abs(values.std() / math.sqrt(1.0 / F) - 1.0) < 0.05
        assert abs(values.mean()) < 4 * math.sqrt(1.0 / F) / math.sqrt(2 * F)


def _mule_batch(B: int = 48, L: int = 4, seed: int = 0) -> dict:
    """A views batch of MischievousMule as numpy: half the rows invested
    (SELL valid, BUY masked), windows with leading padding."""
    rng = np.random.default_rng(seed)
    invested = rng.integers(0, 2, size=(B, 1)).astype(np.int32)
    pad = np.arange(L + 1)[None, :] < rng.integers(0, L + 1, size=(B, 1))
    prices = np.where(pad[..., None], 0.0, rng.normal(scale=0.05, size=(B, L + 1, 1))).astype(np.float32)
    return {DataKeys.OBS: {
        "action_mask": np.concatenate([np.ones_like(invested, bool), invested == 0, invested == 1], axis=1),
        "invested": invested,
        "LOG_CHANGE(price)": {DataKeys.INPUTS: prices, DataKeys.PADDING_MASK: pad},
        "LOG_CHANGE(price, position)": rng.normal(scale=0.1, size=(B, 1)).astype(np.float32),
    }}


def _models(seed: int = 0):
    """Both packages' MischievousMule with the same flax parameters
    (perturbed, so LayerNorm scales and biases and the heads matter)."""
    jenv = JAlgoTrading(1)
    jmodel = JMischievousMule(jenv.observation_spec, jenv.action_spec, hiddens=HIDDENS)
    batch = _mule_batch()
    params = jmodel.init(jax.random.key(seed), jax.tree_util.tree_map(jnp.asarray, batch))["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(seed + 1), len(leaves))
    params = jax.tree_util.tree_unflatten(
        treedef, [p + 0.2 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)]
    )
    tenv = AlgoTrading(1, device="cpu")
    tmodel = MischievousMule(tenv.observation_spec, tenv.action_spec, hiddens=HIDDENS)
    load_jax_params(tmodel, jax.device_get(params))
    return jmodel, params, tmodel, batch


def _check_features(t_feat, t_val, j_feat, j_val, B: int) -> None:
    j_logits, t_logits = np.asarray(j_feat["logits"]), t_feat["logits"].detach().numpy()
    masked = j_logits < -1e37
    np.testing.assert_array_equal(t_logits < -1e37, masked)
    assert masked.sum() == B  # exactly one masked action per row
    np.testing.assert_allclose(np.where(masked, 0.0, t_logits), np.where(masked, 0.0, j_logits),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(t_val.detach().numpy(), np.asarray(j_val), rtol=FWD_RTOL, atol=FWD_ATOL)


def test_mule_forward_matches_flax() -> None:
    """The module forward through ``load_jax_params``, masked logits at
    FMIN (<= -1e37) in both."""
    jmodel, params, tmodel, batch = _models()
    j_feat, j_val = jmodel.apply({"params": params}, jax.tree_util.tree_map(jnp.asarray, batch))
    with torch.no_grad():
        t_feat, t_val = tmodel(tree_map(torch.from_numpy, batch))
    _check_features(t_feat, t_val, j_feat, j_val, 48)


def _grad_tree(model) -> dict:
    """``model``'s parameter gradients in the flax layout."""
    for p in model.parameters():
        p.data = p.grad.clone()
    return to_jax_params(model)


def test_fused_custom_apply_matches_flax() -> None:
    """``fused_custom_apply`` (the plain chain versions on the CPU, through
    the autograd op) against flax's apply: forward, and the gradients of
    a loss of logits and values, the embedding table's through the
    chains' dx included."""
    jmodel, params, tmodel, batch = _models(seed=3)
    assert supports_fused_apply(tmodel)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def j_loss(p):
        f, v = jmodel.apply({"params": p}, jbatch)
        logits = jnp.where(f["logits"] > -1e37, f["logits"], 0.0)
        return jnp.mean(jnp.sin(logits)) + jnp.mean(v * v)

    j_feat, j_val = jmodel.apply({"params": params}, jbatch)
    t_feat, t_val = fused_custom_apply(tmodel, tree_map(torch.from_numpy, batch))
    _check_features(t_feat, t_val, j_feat, j_val, 48)
    logits = torch.where(t_feat["logits"] > -1e37, t_feat["logits"], 0.0)
    (torch.sin(logits).mean() + (t_val * t_val).mean()).backward()
    t_grads = _grad_tree(tmodel)
    j_grads = jax.device_get(jax.grad(j_loss)(params))
    assert np.abs(j_grads["invested_embedding"]["embedding"]).max() > 0
    flat_t, tree_t = jax.tree_util.tree_flatten(t_grads)
    flat_j, tree_j = jax.tree_util.tree_flatten(j_grads)
    assert tree_t == tree_j
    for got, want in zip(flat_t, flat_j):
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_convert_round_trip() -> None:
    """``to_jax_params`` inverts ``load_jax_params`` on MischievousMule's
    flax tree (embedding, LayerNorm torsos, heads) exactly, and a tree
    without the torsos' LayerNorm is refused."""
    _, params, tmodel, _ = _models(seed=4)
    params = jax.device_get(params)
    tree = to_jax_params(tmodel)
    flat_t, tree_t = jax.tree_util.tree_flatten(tree)
    flat_j, tree_j = jax.tree_util.tree_flatten(params)
    assert tree_t == tree_j
    for got, want in zip(flat_t, flat_j):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert sorted(tree["feature_model"]) == ["Dense_0", "Dense_1", "LayerNorm_0"]
    broken = {**params, "vf_model": {k: v for k, v in params["vf_model"].items() if k != "LayerNorm_0"}}
    with pytest.raises(ValueError, match="LayerNorm"):
        load_jax_params(tmodel, broken)


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
    sorted(p.relative_to(REPO).as_posix() for p in (REPO / "rl8_tpu_torch").rglob("*.py")) + ["chip_smoke.py"],
)
def test_port_imports_no_examples_package(path: str) -> None:
    """The port keeps its own copy of the examples it runs: no module of it
    (nor chip_smoke.py) imports the repo's ``examples`` package."""
    assert "examples" not in _imported_roots(REPO / path)


@pytest.mark.parametrize(
    "module_name",
    [
        "rl8_tpu_torch.examples.algotrading",
        "rl8_tpu_torch.examples.algotrading.env",
        "rl8_tpu_torch.nn.modules.embeddings",
        "rl8_tpu_torch.nn.modules.normalization",
    ],
)
def test_new_module_doctests(module_name: str) -> None:
    import doctest
    import importlib

    results = doctest.testmod(
        importlib.import_module(module_name), optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE
    )
    assert results.failed == 0
    assert results.attempted > 0
