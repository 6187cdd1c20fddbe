"""The port's recurrent models, their flax layout and ``RecurrentPolicy``
held against ``rl8_tpu``'s on the CPU: the stacked-LSTM forward and new
states against flax's ``OptimizedLSTMCell`` stack from the same
parameters, the ``models/convert.py`` round trips, the initialization
scales, and ``RecurrentPolicy.sample`` against JAX's."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl8_tpu.distributions import Categorical as JCategorical
from rl8_tpu.distributions import Normal as JNormal
from rl8_tpu.models import DefaultContinuousRecurrentModel as JContinuous
from rl8_tpu.models import DefaultDiscreteRecurrentModel as JDiscreteModel
from rl8_tpu.policies import RecurrentPolicy as JRecurrentPolicy
from rl8_tpu.specs import Discrete as JDiscrete
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.models import (
    DefaultContinuousRecurrentModel,
    DefaultDiscreteRecurrentModel,
    RecurrentModel,
    load_jax_params,
    to_jax_params,
)
from rl8_tpu_torch.policies import RecurrentPolicy
from rl8_tpu_torch.specs import Discrete, Unbounded

#: f32 on both sides, the same cell formula, sums in another order.
RTOL, ATOL = 1e-5, 1e-5
B, T, D = 5, 4, 3


def _pair(continuous: bool, hidden: int, layers: int, seed: int = 0):
    """The same default recurrent model in both packages, flax-initialized,
    perturbed so that biases and heads are not at their init values, and
    loaded into the port; with numpy inputs and states."""
    config = {"hidden_size": hidden, "num_layers": layers}
    if continuous:
        jmodel = JContinuous(JUnbounded(D), JUnbounded(2), **config)
        model = DefaultContinuousRecurrentModel(Unbounded(D), Unbounded(2), **config)
    else:
        jmodel = JDiscreteModel(JUnbounded(D), JDiscrete(3, shape=(2,)), **config)
        model = DefaultDiscreteRecurrentModel(Unbounded(D), Discrete(3, shape=(2,)), **config)
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(B, T, D)).astype(np.float32)
    states = {
        DataKeys.HIDDEN_STATES: (0.5 * rng.normal(size=(B, layers, hidden))).astype(np.float32),
        DataKeys.CELL_STATES: rng.normal(size=(B, layers, hidden)).astype(np.float32),
    }
    params = jmodel.init(jax.random.key(seed), {DataKeys.OBS: jnp.asarray(obs)}, jax.tree_util.tree_map(jnp.asarray, states))["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(np.asarray(p) + 0.2 * rng.normal(size=p.shape).astype(np.float32)) for p in leaves]
    )
    load_jax_params(model, jax.device_get(params))
    return jmodel, params, model, obs, states


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_forward_and_states_match_flax(continuous: bool, layers: int) -> None:
    jmodel, params, model, obs, states = _pair(continuous, hidden=12, layers=layers)
    (jfeatures, jvalues), jstates = jmodel.apply(
        {"params": params}, {DataKeys.OBS: jnp.asarray(obs)}, jax.tree_util.tree_map(jnp.asarray, states)
    )
    with torch.no_grad():
        (features, values), new_states = model({DataKeys.OBS: torch.from_numpy(obs)}, _torch(states))
    assert set(features) == set(jfeatures)
    for key in features:
        assert features[key].shape == jfeatures[key].shape
        np.testing.assert_allclose(features[key].numpy(), np.asarray(jfeatures[key]), rtol=RTOL, atol=ATOL, err_msg=key)
    assert tuple(values.shape) == (B * T, 1)
    np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), rtol=RTOL, atol=ATOL)
    for key in (DataKeys.HIDDEN_STATES, DataKeys.CELL_STATES):
        assert tuple(new_states[key].shape) == (B, layers, 12)
        np.testing.assert_allclose(new_states[key].numpy(), np.asarray(jstates[key]), rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_convert_round_trip_and_layout(continuous: bool) -> None:
    """``load_jax_params`` then ``to_jax_params`` gives the flax tree back
    bit for bit, with flax's names and shapes; the port holds each layer's
    gates concatenated in i, f, g, o order."""
    _, params, model, _, _ = _pair(continuous, hidden=8, layers=2)
    want = jax.device_get(params)
    got = to_jax_params(model)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves(got)):
        assert b.dtype == np.float32 and b.shape == a.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))
    cell = want["lstm"]["lstm_1"]
    for k, g in enumerate("ifgo"):
        np.testing.assert_array_equal(model.lstm.wi[1].detach().numpy()[:, 8 * k : 8 * (k + 1)], cell[f"i{g}"]["kernel"])
        np.testing.assert_array_equal(model.lstm.wh[1].detach().numpy()[:, 8 * k : 8 * (k + 1)], cell[f"h{g}"]["kernel"])
        np.testing.assert_array_equal(model.lstm.b[1].detach().numpy()[8 * k : 8 * (k + 1)], cell[f"h{g}"]["bias"])
    with pytest.raises(ValueError, match="LSTM layers"):
        load_jax_params(DefaultDiscreteRecurrentModel(Unbounded(D), Discrete(3, shape=(2,)), hidden_size=8), want)


def test_init_scales() -> None:
    """flax ``OptimizedLSTMCell``'s init: orthogonal ``[H, H]`` hidden
    kernels per gate, lecun-normal input kernels (std 1/sqrt(fan_in)),
    zero biases; small-uniform policy heads and a lecun-normal value
    head, as ``rl8_tpu``'s default recurrent models."""
    H, d = 64, 16
    model = DefaultDiscreteRecurrentModel(Unbounded(d), Discrete(4, shape=(2,)), hidden_size=H, num_layers=2)
    model.reset_parameters(torch.Generator().manual_seed(0))
    for l in range(2):
        wh = model.lstm.wh[l].detach()
        for g in range(4):
            block = wh[:, g * H : (g + 1) * H]
            torch.testing.assert_close(block.t() @ block, torch.eye(H), rtol=0, atol=1e-5)
        wi = model.lstm.wi[l].detach()
        fan_in = d if l == 0 else H
        assert abs(float(wi.std()) - fan_in**-0.5) < 0.1 * fan_in**-0.5
        assert float(wi.abs().max()) <= 2.0 * fan_in**-0.5 / 0.87962566103423978 + 1e-6  # truncated at 2 stds
        assert float(model.lstm.b[l].detach().abs().max()) == 0.0
    assert float(model.feature_head.weight.abs().max()) <= 1e-3
    assert abs(float(model.vf_head.weight.std()) - H**-0.5) < 0.3 * H**-0.5
    assert float(model.feature_head.bias.abs().max()) == float(model.vf_head.bias.abs().max()) == 0.0
    # Seeded: the same generator gives the same parameters.
    other = DefaultDiscreteRecurrentModel(Unbounded(d), Discrete(4, shape=(2,)), hidden_size=H, num_layers=2)
    other.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), other.parameters()))


def test_default_model_cls_states_and_bias_flag() -> None:
    assert RecurrentModel.default_model_cls(Unbounded(3), Discrete(2)) is DefaultDiscreteRecurrentModel
    assert RecurrentModel.default_model_cls(Unbounded(3), Unbounded(2)) is DefaultContinuousRecurrentModel
    with pytest.raises(TypeError):
        RecurrentModel.default_model_cls(Discrete(3), Discrete(2))
    model = DefaultContinuousRecurrentModel(Unbounded(3), Unbounded(2), hidden_size=8, num_layers=3)
    states = model.init_states(4)
    assert {k: tuple(v.shape) for k, v in states.items()} == {
        DataKeys.HIDDEN_STATES: (4, 3, 8),
        DataKeys.CELL_STATES: (4, 3, 8),
    }
    assert all(float(v.abs().max()) == 0.0 for v in states.values())
    # As in rl8_tpu, flax's LSTM cells have no bias toggle, so bias=False
    # raises instead of being ignored.
    no_bias = DefaultDiscreteRecurrentModel(Unbounded(3), Discrete(2), hidden_size=8, bias=False)
    with pytest.raises(NotImplementedError, match="bias=False"):
        no_bias({DataKeys.OBS: torch.zeros(2, 1, 3)}, no_bias.init_states(2))


@pytest.mark.parametrize("through", ["model", "policy"])
def test_init_states_default_to_the_parameters_device(through: str) -> None:
    """``init_states(n)`` with no device puts the states on the device of
    the model's parameters (``rl8_tpu``'s land beside its parameters, so
    ``policy.sample(batch, policy.init_states(n))`` runs on the card); an
    explicit device still wins. The meta device stands in for the card."""
    model = DefaultDiscreteRecurrentModel(Unbounded(3), Discrete(2), hidden_size=8, num_layers=2)
    policy = RecurrentPolicy(model.observation_spec, model.action_spec, model=model)
    owner = model if through == "model" else policy
    assert all(v.device.type == "cpu" for v in owner.init_states(4).values())
    model.to("meta")
    states = owner.init_states(4)
    assert {k: (v.device.type, tuple(v.shape)) for k, v in states.items()} == {
        DataKeys.HIDDEN_STATES: ("meta", (4, 2, 8)),
        DataKeys.CELL_STATES: ("meta", (4, 2, 8)),
    }
    assert all(v.device.type == "cpu" for v in owner.init_states(4, "cpu").values())
    assert all(v.device.type == "cpu" for v in owner.init_states(4, device=torch.device("cpu")).values())


def test_init_states_without_parameters_are_on_the_cpu() -> None:
    class Stateful(RecurrentModel):
        @property
        def state_spec(self):
            return DefaultDiscreteRecurrentModel(Unbounded(3), Discrete(2), hidden_size=4).state_spec

    model = Stateful(Unbounded(3), Discrete(2))
    assert next(model.parameters(), None) is None
    states = model.init_states(3)
    assert {k: (v.device.type, tuple(v.shape)) for k, v in states.items()} == {
        DataKeys.HIDDEN_STATES: ("cpu", (3, 1, 4)),
        DataKeys.CELL_STATES: ("cpu", (3, 1, 4)),
    }


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_init_states_equal_jax(continuous: bool) -> None:
    """The states equal ``rl8_tpu``'s ``init_states(n)``: zeros of the same
    keys, shapes and dtype, from the model and from the policy."""
    jmodel, params, model, _, _ = _pair(continuous, hidden=8, layers=2)
    jpolicy = JRecurrentPolicy(jmodel.observation_spec, jmodel.action_spec, model=jmodel)
    policy = RecurrentPolicy(model.observation_spec, model.action_spec, model=model)
    for want, got in ((jmodel.init_states(6), model.init_states(6)), (jpolicy.init_states(6), policy.init_states(6))):
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == torch.float32 and np.asarray(want[key]).dtype == np.float32
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_policy_sample_matches_jax(continuous: bool) -> None:
    """Deterministic ``RecurrentPolicy.sample`` against ``rl8_tpu``'s from
    the same parameters: actions, log-probs, values and new states, with
    outputs of batch ``[B * T]`` and states of batch ``[B]``."""
    jmodel, params, model, obs, states = _pair(continuous, hidden=16, layers=2, seed=3)
    if not continuous:
        # Logits heads far from the small init, so that argmaxes are clear.
        with torch.no_grad():
            model.feature_head.weight.mul_(30.0)
        params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(model))
    jpolicy = JRecurrentPolicy(jmodel.observation_spec, jmodel.action_spec, model=jmodel)
    policy = RecurrentPolicy(model.observation_spec, model.action_spec, model=model)
    assert jpolicy.distribution_cls is (JNormal if continuous else JCategorical)
    jout, jstates = jpolicy.sample(
        params, {DataKeys.OBS: jnp.asarray(obs)}, jax.tree_util.tree_map(jnp.asarray, states),
        deterministic=True, return_logp=True, return_values=True,
    )
    out, new_states = policy.sample(
        {DataKeys.OBS: torch.from_numpy(obs)}, _torch(states), deterministic=True, return_logp=True, return_values=True
    )
    if continuous:
        np.testing.assert_allclose(out[DataKeys.ACTIONS].numpy(), np.asarray(jout[DataKeys.ACTIONS]), rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(out[DataKeys.ACTIONS].numpy(), np.asarray(jout[DataKeys.ACTIONS]))
    for key in (DataKeys.LOGP, DataKeys.VALUES):
        assert tuple(out[key].shape) == (B * T, 1)
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), rtol=RTOL, atol=ATOL, err_msg=key)
    for key in new_states:
        np.testing.assert_allclose(new_states[key].numpy(), np.asarray(jstates[key]), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="generator"):
        policy.sample({DataKeys.OBS: torch.from_numpy(obs)}, _torch(states))
    gen = torch.Generator().manual_seed(0)
    drawn, _ = policy.sample({DataKeys.OBS: torch.from_numpy(obs)}, _torch(states), generator=gen)
    assert drawn[DataKeys.ACTIONS].shape == out[DataKeys.ACTIONS].shape
    assert policy.init_states(2)[DataKeys.CELL_STATES].shape == (2, 2, 16)
