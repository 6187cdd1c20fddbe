"""The custom-model slice as a whole: ``AlgorithmConfig(model_cls=
MischievousMule or AttentiveAlpaca, fused_forward=...)`` and
``RecurrentAlgorithmConfig(model_cls=LazyLemur, ...)`` on ``AlgoTrading``,
their ``collect()`` and ``step()`` held against ``rl8_tpu``'s on the CPU
from the same parameters, start states and buffer; models whose views
window past actions and rewards, held against ``rl8_tpu`` and against the
reference's per-step views; the fused and module routes against each
other; and configurations held to ``rl8_tpu``'s outcome."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl8_tpu.env as jenv
import rl8_tpu_torch.env as tenv
from examples.algotrading.env import AlgoTrading as JAlgoTrading
from examples.algotrading.models import AttentiveAlpaca as JAttentiveAlpaca
from examples.algotrading.models import LazyLemur as JLazyLemur
from examples.algotrading.models import MischievousMule as JMischievousMule
from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
from rl8_tpu import RecurrentAlgorithmConfig as JRecurrentAlgorithmConfig
from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.examples.algotrading import AlgoTrading, AttentiveAlpaca, LazyLemur, MischievousMule
from rl8_tpu_torch.models import GenericModel, load_jax_params, small_uniform_, to_jax_params
from rl8_tpu_torch.nn import MLP
from rl8_tpu_torch.nn.modules.mlp import dense_leaves, flax_init_, prefixed
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


def _config(hiddens: tuple = HIDDENS, **kw):
    return dict(num_envs=NUM_ENVS, horizon=HORIZON, horizons_per_env_reset=2,
                model_config={"hiddens": hiddens}, seed=3, **kw)


#: The feedforward custom models, by name: ``rl8_tpu``'s, the port's, and
#: the seed of a logits head whose greedy collects take all three actions.
MODELS = {"mule": (JMischievousMule, MischievousMule, 2), "alpaca": (JAttentiveAlpaca, AttentiveAlpaca, 3)}


def _redraw_head(jalgo, seed: int = 2) -> dict:
    """The JAX algorithm's parameters with the logits head redrawn at
    lecun scale from ``seed``, so that greedy actions are not near-ties;
    set back into it and returned as numpy."""
    params = jax.device_get(jalgo.state.params)
    head = params["feature_head"]["kernel"]
    params["feature_head"]["kernel"] = head + 0.5 * np.random.default_rng(seed).normal(size=head.shape).astype(np.float32)
    jalgo.state = jalgo.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    return params


def _pair(fused_forward: bool = True, model: str = "mule", **kw):
    """Both packages' algorithms with the JAX one's parameters, its logits
    head redrawn (:func:`_redraw_head`)."""
    jcls, tcls, seed = MODELS[model]
    jalgo = JAlgorithmConfig(model_cls=jcls, **_config(**kw)).build(JaxStartTrading)
    params = _redraw_head(jalgo, seed)
    talgo = AlgorithmConfig(model_cls=tcls, fused_forward=fused_forward, device="cpu",
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


@pytest.mark.parametrize("model", list(MODELS))
def test_collect_matches_jax(model: str) -> None:
    """Two deterministic collects (the second carrying the first's last
    observation over, with its view window restarting), through the
    chain kernels' plain versions: observations, actions, log-probs,
    values, rewards and returns, and the reward scale."""
    jalgo, talgo, _ = _pair(model=model)
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


@pytest.mark.parametrize(
    "model,fused_forward,hiddens",
    [
        pytest.param("mule", True, HIDDENS, id="fused"),
        pytest.param("mule", False, HIDDENS, id="module"),
        pytest.param("alpaca", True, HIDDENS, id="alpaca-fused"),
        pytest.param("alpaca", False, HIDDENS, id="alpaca-module"),
        pytest.param("mule", True, (1024, 1024), id="wide-fused"),
    ],
)
def test_step_matches_jax(model: str, fused_forward: bool, hiddens: tuple) -> None:
    """One whole-buffer ``step()`` in each package from the same
    parameters and buffer (no shuffle): the stats, the parameters
    afterwards in the flax layout, and Adam's count; through the chain
    kernels' plain versions and through the module with autograd (for
    AttentiveAlpaca, into the shared attention stack); and MischievousMule
    at ``hiddens=(1024, 1024)``, a width whose chains the card's kernels
    take on their staged routes."""
    jalgo, talgo, params0 = _pair(fused_forward, model, hiddens=hiddens, entropy_coeff=0.01, num_sgd_iters=2)
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
        views = algo._training_views(buf)
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


class _JaxActionWindowMule(JMischievousMule):
    @property
    def view_requirements(self):
        from rl8_tpu.views import ViewRequirement as JViewRequirement

        return {**super().view_requirements, DataKeys.ACTIONS: JViewRequirement(shift=2)}


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


def _outcome(build) -> None | type:
    """Build, collect and step; ``None``, or the type of what raised."""
    try:
        algo = build()
        algo.collect()
        algo.step()
    except Exception as e:  # noqa: BLE001 - the type is the outcome
        return type(e)
    return None


@pytest.mark.parametrize(
    "build,jax_build,want",
    [
        (
            lambda: AlgorithmConfig(model_cls=_ActionWindowMule, device="cpu", **_config()).build(AlgoTrading),
            lambda: JAlgorithmConfig(model_cls=_JaxActionWindowMule, **_config()).build(JAlgoTrading),
            None,
        ),
        (
            lambda: RecurrentAlgorithmConfig(model_cls=MischievousMule, fused_forward=True, device="cpu").build(
                AlgoTrading
            ),
            lambda: JRecurrentAlgorithmConfig(model_cls=JMischievousMule, fused_forward=True).build(JAlgoTrading),
            AttributeError,
        ),
        (
            lambda: RecurrentAlgorithmConfig(model_cls=MischievousMule, device="cpu").build(AlgoTrading),
            lambda: JRecurrentAlgorithmConfig(model_cls=JMischievousMule).build(JAlgoTrading),
            AttributeError,
        ),
    ],
    ids=["nonobs-view-keys", "recurrent-fused-forward", "custom-recurrent-model"],
)
def test_unported_configurations_raise(build, jax_build, want) -> None:
    """Configurations the port once refused do what ``rl8_tpu`` does: a
    view requirement on past actions builds, collects and steps; a
    feedforward model in the recurrent algorithm raises the same error
    type (it has no ``state_spec``)."""
    assert _outcome(build) is want
    assert _outcome(jax_build) is want


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


# ----------------------------------------------------------------------
# LazyLemur: a custom recurrent model
# ----------------------------------------------------------------------


def _lemur_config(**kw):
    return dict(num_envs=NUM_ENVS, horizon=HORIZON, seq_len=4, seqs_per_state_reset=2, horizons_per_env_reset=2,
                model_config={"hiddens": HIDDENS, "hidden_size": 8}, seed=3, **kw)


@pytest.mark.parametrize("fused_forward", [True, False], ids=["fused", "module"])
def test_lemur_collect_and_step_match_jax(fused_forward: bool) -> None:
    """``RecurrentAlgorithmConfig(model_cls=LazyLemur)``: two deterministic
    collects (states carried, re-initialized every 2 sequences) against
    ``rl8_tpu``'s, then one whole-buffer ``step()`` (no shuffle) from its
    buffer: the module rollout and the autodiff update, with the chains
    through the chain kernels' plain versions or the module."""
    jalgo = JRecurrentAlgorithmConfig(model_cls=JLazyLemur, **_lemur_config()).build(JaxStartTrading)
    params0 = _redraw_head(jalgo, seed=5)
    talgo = RecurrentAlgorithmConfig(model_cls=LazyLemur, fused_forward=fused_forward, device="cpu",
                                     **_lemur_config()).build(TorchStartTrading)
    load_jax_params(talgo.policy.model, params0)
    assert (talgo._fused_forward, talgo._fused_act, talgo._fused_update) == (fused_forward, False, False)
    for _ in range(2):
        jalgo.collect(deterministic=True)
        talgo.collect(deterministic=True)
        jbuf, tbuf = jalgo.state.buffer, talgo.state.buffer
        _obs_close(tbuf[DataKeys.OBS], jbuf[DataKeys.OBS])
        np.testing.assert_array_equal(tbuf[DataKeys.ACTIONS].numpy(), np.asarray(jbuf[DataKeys.ACTIONS]))
        for key in (DataKeys.LOGP, DataKeys.VALUES, DataKeys.REWARDS):
            np.testing.assert_allclose(tbuf[key].numpy(), np.asarray(jbuf[key]), rtol=RTOL, atol=ATOL, err_msg=key)
        for key, want in jbuf[DataKeys.STATES].items():
            np.testing.assert_allclose(tbuf[DataKeys.STATES][key].numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        assert talgo.state.seqs == int(jalgo.state.seqs)
    assert len(np.unique(np.asarray(jalgo.state.buffer[DataKeys.ACTIONS]))) == 3
    # The step, from rl8_tpu's buffer and the same parameters.
    params = jax.device_get(jalgo.state.params)
    load_jax_params(talgo.policy.model, params)
    _copy_rollout(jalgo, talgo)
    jstats, tstats = jalgo.step(), talgo.step()
    for key in STAT_KEYS:
        assert math.isclose(tstats[key], jstats[key], rel_tol=STAT_RTOL, abs_tol=STAT_ATOL), (key, tstats[key], jstats[key])
    start = _flat(params)
    jdelta = _flat(jax.device_get(jalgo.state.params)) - start
    tdelta = _flat(to_jax_params(talgo.policy.model)) - start
    assert np.linalg.norm(jdelta) > 0
    assert np.linalg.norm(tdelta - jdelta) <= DELTA_REL * np.linalg.norm(jdelta)


# ----------------------------------------------------------------------
# Views of past actions and rewards
# ----------------------------------------------------------------------

_POSITIONS = np.random.default_rng(0).uniform(-50, 50, size=(NUM_ENVS, 1)).astype(np.float32)


class JaxStartEnv(jenv.DiscreteDummyEnv):
    def reset(self, key, *, state=None, config=None):
        pos = jnp.asarray(_POSITIONS[: self.num_envs])
        return {"position": pos, "bounds": jnp.asarray(50.0)}, pos


class TorchStartEnv(tenv.DiscreteDummyEnv):
    def reset(self, generator, *, state=None, config=None):
        pos = torch.tensor(_POSITIONS[: self.num_envs], device=self.device)
        return {"position": pos, "bounds": torch.tensor(50.0, device=self.device)}, pos


#: The windows each model reads: ``rl8_tpu``'s action-window model
#: (observations and the last two actions) and a model windowing its
#: observations, actions and rewards. (Their logits heads are redrawn from
#: seed 3, LazyLemur's from seed 5: greedy collects that take every
#: action.)
WINDOWS = {"actions": {DataKeys.OBS: 0, DataKeys.ACTIONS: 2},
           "actions-rewards": {DataKeys.OBS: 2, DataKeys.ACTIONS: 2, DataKeys.REWARDS: 1}}


def _jax_window_model(windows: dict):
    import flax.linen as fnn

    from rl8_tpu.models import GenericModel as JGenericModel
    from rl8_tpu.models import small_uniform_init
    from rl8_tpu.nn import MLP as JMLP
    from rl8_tpu.views import ViewRequirement as JViewRequirement

    class JWindowModel(JGenericModel):
        hiddens: tuple = HIDDENS

        @property
        def view_requirements(self):
            return {key: JViewRequirement(shift=shift) for key, shift in windows.items()}

        @fnn.compact
        def __call__(self, batch):
            n = self.action_spec.n
            parts = []
            for key, shift in windows.items():
                item = batch[key] if shift == 0 else batch[key][DataKeys.INPUTS]
                if key == DataKeys.ACTIONS:
                    item = jax.nn.one_hot(item[..., 0], n)
                if shift:
                    item = item * (~batch[key][DataKeys.PADDING_MASK])[..., None]
                parts.append(item.reshape(item.shape[0], -1))
            x = jnp.concatenate(parts, axis=-1)
            latents = jax.nn.relu(JMLP(self.hiddens, name="feature_model")(x))
            logits = fnn.Dense(n, kernel_init=small_uniform_init(), name="feature_head")(latents).reshape(-1, 1, n)
            values = fnn.Dense(1, name="vf_head")(jax.nn.relu(JMLP(self.hiddens, name="vf_model")(x)))
            return {"logits": logits}, values

    return JWindowModel


def _window_model(windows: dict):
    class WindowModel(GenericModel):
        def __init__(self, observation_spec, action_spec, /, *, hiddens=HIDDENS):
            super().__init__(observation_spec, action_spec)
            n = action_spec.n
            widths = {DataKeys.OBS: 1, DataKeys.ACTIONS: n, DataKeys.REWARDS: 1}
            d_in = sum(widths[key] * (shift + 1) for key, shift in windows.items())
            self.feature_model = MLP(d_in, hiddens)
            self.feature_head = torch.nn.Linear(hiddens[-1], n)
            self.vf_model = MLP(d_in, hiddens)
            self.vf_head = torch.nn.Linear(hiddens[-1], 1)

        @property
        def view_requirements(self):
            return {key: ViewRequirement(shift=shift) for key, shift in windows.items()}

        def extra_jax_params(self):
            leaves = {}
            for name in ("feature_model", "vf_model"):
                leaves.update(prefixed((name,), getattr(self, name).jax_leaves()))
            for name in ("feature_head", "vf_head"):
                leaves.update(prefixed((name,), dense_leaves(getattr(self, name))))
            return leaves

        def reset_parameters(self, generator):
            flax_init_(self, generator)
            with torch.no_grad():
                small_uniform_(self.feature_head.weight, generator)

        def forward(self, batch):
            n = self.action_spec.n
            parts = []
            for key, shift in windows.items():
                item = batch[key] if shift == 0 else batch[key][DataKeys.INPUTS]
                if key == DataKeys.ACTIONS:
                    item = torch.nn.functional.one_hot(item[..., 0].long(), n).float()
                if shift:
                    item = item * (~batch[key][DataKeys.PADDING_MASK])[..., None]
                parts.append(item.reshape(item.shape[0], -1))
            x = torch.cat(parts, dim=-1)
            logits = self.feature_head(torch.relu(self.feature_model(x))).reshape(-1, 1, n)
            return {"logits": logits}, self.vf_head(torch.relu(self.vf_model(x)))

    return WindowModel


@pytest.mark.parametrize("name", list(WINDOWS))
def test_window_models_collect_and_step_match_jax(name: str) -> None:
    """Models with views of past actions (and rewards) on
    ``DiscreteDummyEnv``: two deterministic collects (the windows restart
    each horizon; the current step's slot reads zero) and one
    whole-buffer ``step()`` from ``rl8_tpu``'s buffer, whose training
    views window the buffer's actions and rewards, against ``rl8_tpu``'s."""
    config = dict(num_envs=NUM_ENVS, horizon=HORIZON, horizons_per_env_reset=2, seed=3, entropy_coeff=0.01,
                  num_sgd_iters=2)
    jalgo = JAlgorithmConfig(model_cls=_jax_window_model(WINDOWS[name]), **config).build(JaxStartEnv)
    params0 = _redraw_head(jalgo, seed=3)
    talgo = AlgorithmConfig(model_cls=_window_model(WINDOWS[name]), device="cpu", **config).build(TorchStartEnv)
    load_jax_params(talgo.policy.model, params0)
    assert talgo._nonobs_roots == tuple(k for k in WINDOWS[name] if k != DataKeys.OBS)
    for _ in range(2):
        jalgo.collect(deterministic=True)
        talgo.collect(deterministic=True)
        jbuf, tbuf = jalgo.state.buffer, talgo.state.buffer
        np.testing.assert_array_equal(tbuf[DataKeys.ACTIONS].numpy(), np.asarray(jbuf[DataKeys.ACTIONS]))
        for key in (DataKeys.OBS, DataKeys.LOGP, DataKeys.VALUES, DataKeys.REWARDS):
            np.testing.assert_allclose(tbuf[key].numpy(), np.asarray(jbuf[key]), rtol=RTOL, atol=ATOL, err_msg=key)
    assert len(np.unique(np.asarray(jalgo.state.buffer[DataKeys.ACTIONS]))) == 2
    params = jax.device_get(jalgo.state.params)
    _copy_rollout(jalgo, talgo)
    jstats, tstats = jalgo.step(), talgo.step()
    for key in STAT_KEYS:
        assert math.isclose(tstats[key], jstats[key], rel_tol=STAT_RTOL, abs_tol=STAT_ATOL), (key, tstats[key], jstats[key])
    start = _flat(params)
    jdelta = _flat(jax.device_get(jalgo.state.params)) - start
    tdelta = _flat(to_jax_params(talgo.policy.model)) - start
    assert np.linalg.norm(jdelta) > 0
    assert np.linalg.norm(tdelta - jdelta) <= DELTA_REL * np.linalg.norm(jdelta)


@pytest.mark.parametrize("name", list(WINDOWS))
def test_rollout_views_equal_reference_buffer_views(name: str) -> None:
    """The views the rollout feeds the model at every step t (and at the
    bootstrap value, t = T) equal the reference's
    ``apply_view_requirements(buffer[:, :t + 1], kind="last")`` of the
    collect's own buffer with the current step's non-observation slots
    still zero (``rl8_tpu``'s
    ``test_carried_window_views_equal_reference_buffer_views``); in a
    first collect and in one that carries its observation over."""
    T = 5
    algo = AlgorithmConfig(model_cls=_window_model(WINDOWS[name]), num_envs=8, horizon=T, device="cpu",
                           horizons_per_env_reset=2).build(tenv.DiscreteDummyEnv)
    model, seen = algo.policy.model, []
    apply = algo._apply_model
    algo._apply_model = lambda batch: (seen.append(batch), apply(batch))[1]

    def assert_equal(got, want):
        if isinstance(want, dict):
            assert set(got) == set(want)
            for key in want:
                assert_equal(got[key], want[key])
        else:
            assert got.shape == want.shape and torch.equal(got, want.to(got.dtype))

    for _ in range(2):
        seen.clear()
        algo.collect()
        buf = algo.state.buffer
        assert len(seen) == T + 1
        for t, views in enumerate(seen):
            batch = {DataKeys.OBS: buf[DataKeys.OBS][: t + 1].transpose(0, 1)}
            for root in (DataKeys.ACTIONS, DataKeys.REWARDS):
                zero = torch.zeros_like(buf[root][0])
                batch[root] = torch.cat([buf[root][:t], zero[None]]).transpose(0, 1)
            assert_equal(views, model.apply_view_requirements(batch, kind="last"))
