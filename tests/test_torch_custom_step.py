"""The custom-model slice as a whole: ``AlgorithmConfig(model_cls=
MischievousMule, fused_forward=...)`` on ``AlgoTrading``, its ``collect()``
and ``step()`` held against ``rl8_tpu``'s on the CPU from the same
parameters, start states and buffer, plus the fused and module routes
against each other, and the configurations the port refuses."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.algotrading.env import AlgoTrading as JAlgoTrading
from examples.algotrading.models import MischievousMule as JMischievousMule
from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule
from rl8_tpu_torch.models import load_jax_params, to_jax_params
from rl8_tpu_torch.views import ViewRequirement

NUM_ENVS, HORIZON, HIDDENS = 32, 8, (16, 16)
STAT_KEYS = ("losses/entropy", "losses/policy", "losses/vf", "losses/total", "monitors/kl_div")
#: f32 on both sides with other summation orders; the env's log changes
#: are differences of logs near 9, an ulp of which is ~1e-6.
RTOL, ATOL = 1e-5, 1e-4
OBS_RTOL, OBS_ATOL = 1e-5, 4e-6
#: A step from the same buffer (as tests/test_torch_step.py): losses to
#: ~1e-6 relative, parameters by a norm-relative error of their change.
STAT_RTOL, STAT_ATOL, DELTA_REL = 1e-4, 1e-6, 1e-3


def _start() -> dict:
    rng = np.random.default_rng(0)
    B = NUM_ENVS
    return {
        "f": rng.uniform(0.0, math.pi, size=(B, 1)).astype(np.float32),
        "k_cyclic": rng.uniform(-0.05, 0.05, size=(B, 1)).astype(np.float32),
        "k_market": rng.uniform(-0.05, 0.05, size=(B, 1)).astype(np.float32),
        "t": rng.integers(0, 10, size=(B, 1)).astype(np.float32),
        "price": rng.uniform(100.0, 10_000.0, size=(B, 1)).astype(np.float32),
    }


def _reset_state(asarray, B: int) -> dict:
    start = {k: asarray(v[:B]) for k, v in _start().items()}
    bounds = {k: asarray(np.float32(v)) for k, v in
              (("f_bounds", math.pi), ("k_cyclic_bounds", 0.05), ("k_market_bounds", 0.05))}
    zeros = asarray(np.zeros((B, 1), np.float32))
    return {
        "bounds": bounds,
        "action_mask": asarray(np.tile(np.array([True, True, False]), (B, 1))),
        "invested": asarray(np.zeros((B, 1), np.int32)),
        "position": zeros,
        **start,
        "log_change_price": zeros,
        "log_change_price_position": zeros,
    }


class JaxStartTrading(JAlgoTrading):
    def reset(self, key, *, state=None, config=None):
        s = _reset_state(jnp.asarray, self.num_envs)
        return s, self._obs(s)


class TorchStartTrading(AlgoTrading):
    def reset(self, generator, *, state=None, config=None):
        s = _reset_state(lambda a: torch.as_tensor(a, device=self.device), self.num_envs)
        return s, self._obs(s)


def _config(**kw):
    return dict(num_envs=NUM_ENVS, horizon=HORIZON, horizons_per_env_reset=2,
                model_config={"hiddens": HIDDENS}, seed=3, **kw)


def _pair(fused_forward: bool = True, **kw):
    """Both packages' algorithms with the JAX one's parameters, its logits
    head redrawn at lecun scale so that greedy actions are not near-ties."""
    jalgo = JAlgorithmConfig(model_cls=JMischievousMule, **_config(**kw)).build(JaxStartTrading)
    params = jax.device_get(jalgo.state.params)
    head = params["feature_head"]["kernel"]
    params["feature_head"]["kernel"] = head + 0.5 * np.random.default_rng(2).normal(size=head.shape).astype(np.float32)
    jalgo.state = jalgo.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    talgo = AlgorithmConfig(model_cls=MischievousMule, fused_forward=fused_forward, device="cpu",
                            **_config(**kw)).build(TorchStartTrading)
    load_jax_params(talgo.policy.model, params)
    return jalgo, talgo, params


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def _obs_close(tobs, jobs) -> None:
    for key in jobs:
        got, want = tobs[key].numpy(), np.asarray(jobs[key])
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=OBS_RTOL, atol=OBS_ATOL, err_msg=key)


def test_collect_matches_jax() -> None:
    """Two deterministic collects (the second carrying the first's last
    observation over, with its view window restarting), through the
    chain kernels' plain versions: observations, actions, log-probs,
    values, rewards and returns, and the reward scale."""
    jalgo, talgo, _ = _pair()
    assert talgo._fused_forward and not (talgo._fused_act or talgo._fused_update)
    for i in range(2):
        jstats = jalgo.collect(deterministic=True)
        tstats = talgo.collect(deterministic=True)
        jbuf, tbuf = jalgo.state.buffer, talgo.state.buffer
        assert set(tbuf) == set(jbuf)
        _obs_close(tbuf[DataKeys.OBS], jbuf[DataKeys.OBS])
        np.testing.assert_array_equal(tbuf[DataKeys.ACTIONS].numpy(), np.asarray(jbuf[DataKeys.ACTIONS]))
        for key in (DataKeys.LOGP, DataKeys.VALUES, DataKeys.REWARDS, DataKeys.REVERSED_DISCOUNTED_RETURNS):
            np.testing.assert_allclose(tbuf[key].numpy(), np.asarray(jbuf[key]), rtol=RTOL, atol=ATOL, err_msg=key)
        np.testing.assert_allclose(float(talgo.state.reward_scale), float(jalgo.state.reward_scale), rtol=RTOL)
        for key in jstats:
            if key.startswith(("returns/", "rewards/")):
                np.testing.assert_allclose(tstats[key], jstats[key], rtol=RTOL, atol=ATOL, err_msg=key)
        assert tstats["env/resets"] == jstats["env/resets"] == (NUM_ENVS if i == 0 else 0)
    # All three actions occur: the trajectories exercise the mask.
    assert len(np.unique(np.asarray(jalgo.state.buffer[DataKeys.ACTIONS]))) == 3


def _copy_rollout(jalgo, talgo) -> None:
    """Hand the JAX algorithm's buffer (and reward scale) to the port, so
    both steps start from bit-identical inputs."""
    talgo.state.buffer = {
        k: jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), v) for k, v in jalgo.state.buffer.items()
    }
    talgo.state.reward_scale = torch.tensor(float(jalgo.state.reward_scale))
    talgo.state.horizons = int(jalgo.state.horizons)
    talgo.state.buffered = True


@pytest.mark.parametrize("fused_forward", [True, False], ids=["fused", "module"])
def test_step_matches_jax(fused_forward: bool) -> None:
    """One whole-buffer ``step()`` in each package from the same
    parameters and buffer (no shuffle): the stats, the parameters
    afterwards in the flax layout, and Adam's count; through the chain
    kernels' plain versions and through the module with autograd."""
    jalgo, talgo, params0 = _pair(fused_forward, entropy_coeff=0.01, num_sgd_iters=2)
    jalgo.collect()
    _copy_rollout(jalgo, talgo)
    jstats, tstats = jalgo.step(), talgo.step()
    for key in STAT_KEYS:
        assert math.isclose(tstats[key], jstats[key], rel_tol=STAT_RTOL, abs_tol=STAT_ATOL), (key, tstats[key], jstats[key])
    start = _flat(params0)
    jdelta = _flat(jax.device_get(jalgo.state.params)) - start
    tdelta = _flat(to_jax_params(talgo.policy.model)) - start
    assert np.linalg.norm(jdelta) > 0
    # The embedding table trains too, through the chains' dx.
    table0 = params0["invested_embedding"]["embedding"]
    assert np.abs(to_jax_params(talgo.policy.model)["invested_embedding"]["embedding"] - table0).max() > 0
    assert np.linalg.norm(tdelta - jdelta) <= DELTA_REL * np.linalg.norm(jdelta)
    assert int(talgo.state.opt_state.count) == 2
    assert not talgo.state.buffered
    # The buffer is spent but keeps its final observation.
    final = jalgo.state.buffer[DataKeys.OBS]["LOG_CHANGE(price)"][-1]
    np.testing.assert_array_equal(talgo.state.buffer[DataKeys.OBS]["LOG_CHANGE(price)"][-1].numpy(), np.asarray(final))


def test_fused_and_module_routes_take_the_same_step() -> None:
    """The same seed with ``fused_forward`` on and off on the CPU: the same
    rollout and the same update (the chains' plain versions against the
    module forward with autograd)."""
    runs = []
    for fused in (True, False):
        algo = AlgorithmConfig(model_cls=MischievousMule, fused_forward=fused, device="cpu",
                               sgd_minibatch_size=NUM_ENVS * HORIZON // 2, **_config()).build(AlgoTrading)
        assert algo._fused_forward == fused
        collect = algo.collect()
        runs.append((collect, algo.step(), to_jax_params(algo.policy.model), algo.state.buffer))
    (c1, s1, p1, b1), (c2, s2, p2, b2) = runs
    for key in c1:
        if key.startswith(("returns/", "rewards/")):
            assert math.isclose(c1[key], c2[key], rel_tol=1e-6, abs_tol=1e-7), key
    for key in STAT_KEYS:
        assert math.isclose(s1[key], s2[key], rel_tol=1e-5, abs_tol=1e-7), (key, s1[key], s2[key])
    np.testing.assert_allclose(_flat(p1), _flat(p2), rtol=1e-5, atol=1e-6)


def test_view_window_restarts_each_horizon() -> None:
    """The rollout's windows equal the training views of its own buffer
    (each horizon's window starts with only its first observation
    unmasked), also in a collect that carries over: the stored log-probs
    and values are the module's on the ``kind="all"`` views."""
    from rl8_tpu_torch.algorithms._feedforward import _t2b
    from rl8_tpu_torch.distributions import Categorical

    algo = AlgorithmConfig(model_cls=MischievousMule, device="cpu", **_config()).build(AlgoTrading)
    for _ in range(2):
        algo.collect()
        buf = algo.state.buffer
        views = algo._training_views(buf[DataKeys.OBS])
        with torch.no_grad():
            features, values = algo.policy.model(views)
        mask = views[DataKeys.OBS]["LOG_CHANGE(price)"][DataKeys.PADDING_MASK].view(NUM_ENVS, HORIZON, -1)
        assert mask[:, 0, :-1].all() and not mask[:, -1].any()
        torch.testing.assert_close(_t2b(buf[DataKeys.VALUES][:-1]), values)
        torch.testing.assert_close(_t2b(buf[DataKeys.LOGP]), Categorical(features).logp(_t2b(buf[DataKeys.ACTIONS])))


class _DroppingMule(MischievousMule):
    @property
    def view_requirements(self):
        return {DataKeys.OBS: ViewRequirement(shift=2, method="rolling_window")}


class _ActionWindowMule(MischievousMule):
    @property
    def view_requirements(self):
        return {**super().view_requirements, DataKeys.ACTIONS: ViewRequirement(shift=2)}


def test_drop_size_rejection_matches_jax() -> None:
    """Sample-dropping view requirements are refused at build, with
    ``rl8_tpu``'s error."""
    class _JaxDroppingMule(JMischievousMule):
        @property
        def view_requirements(self):
            from rl8_tpu.views import ViewRequirement as JViewRequirement

            return {DataKeys.OBS: JViewRequirement(shift=2, method="rolling_window")}

    with pytest.raises(RuntimeError, match="sample-dropping") as jerr:
        JAlgorithmConfig(model_cls=_JaxDroppingMule, **_config()).build(JAlgoTrading)
    with pytest.raises(RuntimeError, match="sample-dropping") as terr:
        AlgorithmConfig(model_cls=_DroppingMule, device="cpu", **_config()).build(AlgoTrading)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize(
    "build",
    [
        lambda: AlgorithmConfig(model_cls=_ActionWindowMule, device="cpu", **_config()).build(AlgoTrading),
        lambda: RecurrentAlgorithmConfig(model_cls=MischievousMule, fused_forward=True, device="cpu").build(AlgoTrading),
        lambda: RecurrentAlgorithmConfig(model_cls=MischievousMule, device="cpu").build(AlgoTrading),
        lambda: AlgorithmConfig(model_cls=MischievousMule, enable_amp=True, device="cpu", **_config()).build(AlgoTrading),
        lambda: AlgorithmConfig(model_cls=MischievousMule, device="cpu",
                                **{**_config(), "model_config": {"dtype": torch.bfloat16}}).build(AlgoTrading),
    ],
    ids=["nonobs-view-keys", "recurrent-fused-forward", "custom-recurrent-model", "enable-amp", "bf16-model"],
)
def test_unported_configurations_raise(build) -> None:
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        build()


def test_custom_model_build_defaults_to_cuda() -> None:
    config = AlgorithmConfig(model_cls=MischievousMule, num_envs=4, horizon=8)
    assert config.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build would succeed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config.build(AlgoTrading)


def test_model_instance_and_mutual_exclusion() -> None:
    """``model=`` takes an instance (its parameters initialized from the
    seed, as ``rl8_tpu`` does), and ``model`` with ``model_cls`` is refused."""
    env = AlgoTrading(1, device="cpu")
    model = MischievousMule(env.observation_spec, env.action_spec, hiddens=HIDDENS)
    a = AlgorithmConfig(model=model, device="cpu", **{k: v for k, v in _config().items() if k != "model_config"})
    algo = a.build(AlgoTrading)
    b = AlgorithmConfig(model_cls=MischievousMule, device="cpu", **_config()).build(AlgoTrading)
    assert algo.policy.model is model
    for p, q in zip(model.parameters(), b.policy.model.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="mutually exclusive"):
        AlgorithmConfig(model=model, model_cls=MischievousMule, device="cpu", **_config()).build(AlgoTrading)
