"""The classic-control examples of the port (``rl8_tpu_torch/examples/
{cartpole,pendulum,mountain_car}``) held against ``examples/`` on the CPU:
one env step from the same numpy-seeded states and configs, resets
(shapes, ranges and moments: the two packages draw from different
generators), domain randomization, the derived config fields, training
on the default models, and the run scripts."""

from __future__ import annotations

import importlib
import json
import math

import jax
import numpy as np
import pytest
import torch

from examples.cartpole.env import CartPole as JCartPole
from examples.cartpole.env import CartPoleConfig as JCartPoleConfig
from examples.mountain_car.env import MountainCar as JMountainCar
from examples.mountain_car.env import MountainCarConfig as JMountainCarConfig
from examples.pendulum.env import Pendulum as JPendulum
from examples.pendulum.env import PendulumConfig as JPendulumConfig
from rl8_tpu_torch import AlgorithmConfig, Trainer
from rl8_tpu_torch.distributions import Categorical, Normal
from rl8_tpu_torch.examples.cartpole import CartPole, CartPoleConfig
from rl8_tpu_torch.examples.mountain_car import MountainCar, MountainCarConfig
from rl8_tpu_torch.examples.pendulum import Pendulum, PendulumConfig

#: One step in f32 on both sides: XLA's and ATen's sin/cos differ by an
#: ulp, which the dynamics carry into velocities of magnitude ~10 and the
#: rewards sum (as ``tests/test_torch_algotrading.py`` holds AlgoTrading).
ENV_RTOL, ENV_ATOL = 1e-6, 4e-6
B = 512


def _cartpole_state(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack(
        [
            rng.uniform(-2.0, 2.0, B),
            rng.uniform(-3.0, 3.0, B),
            rng.uniform(-math.pi, math.pi, B),
            rng.uniform(-4.0, 4.0, B),
        ],
        axis=1,
    ).astype(np.float32)


def _pendulum_state(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # Angles over [-3 pi, 3 pi]: the cost wraps them with a floor modulo.
    th = rng.uniform(-3 * math.pi, 3 * math.pi, B)
    th[:4] = [-3 * math.pi, -math.pi, math.pi, 3 * math.pi]
    return np.stack([th, rng.uniform(-8.0, 8.0, B)], axis=1).astype(np.float32)


def _mountain_car_state(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    state = np.stack([rng.uniform(-1.25, 0.65, B), rng.uniform(-0.08, 0.08, B)], axis=1).astype(np.float32)
    # Rows that hit the left wall moving left, and the goal.
    state[:4] = [[-1.2, -0.05], [-1.19, -0.03], [0.49, 0.02], [0.6, 0.07]]
    return state


def _discrete_actions(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 3, size=(B, 1)).astype(np.int32)


def _torques(seed: int) -> np.ndarray:
    # Beyond max_torque too, so the clamp runs.
    return np.random.default_rng(seed).uniform(-3.0, 3.0, size=(B, 1)).astype(np.float32)


ENVS = {
    "cartpole-euler": (JCartPole, CartPole, {"kinematics_integrator": "euler"}, _cartpole_state, _discrete_actions),
    "cartpole-semi-implicit": (
        JCartPole, CartPole, {"kinematics_integrator": "semi_implicit"}, _cartpole_state, _discrete_actions,
    ),
    "cartpole-randomized": (
        JCartPole, CartPole, {"gravity": 3.7, "length": 0.8, "pole_mass": 0.3, "force_mag": 7.5},
        _cartpole_state, _discrete_actions,
    ),
    "pendulum": (JPendulum, Pendulum, {}, _pendulum_state, _torques),
    "pendulum-randomized": (JPendulum, Pendulum, {"g": 9.81, "m": 1.3, "l": 0.7}, _pendulum_state, _torques),
    "mountain-car": (JMountainCar, MountainCar, {}, _mountain_car_state, _discrete_actions),
    "mountain-car-randomized": (
        JMountainCar, MountainCar, {"force_mag": 0.0015, "gravity": 0.003}, _mountain_car_state, _discrete_actions,
    ),
}


@pytest.mark.parametrize("name", list(ENVS))
@pytest.mark.parametrize("seed", [0, 1])
def test_env_step_matches_jax(name: str, seed: int) -> None:
    jcls, tcls, config, make_state, make_actions = ENVS[name]
    phys, actions = make_state(seed), make_actions(seed + 100)
    jstate, _ = jcls(B).reset(jax.random.key(0), config=config)
    tstate, _ = tcls(B, device="cpu").reset(torch.Generator().manual_seed(0), config=config)
    jstate = {**jstate, "phys": jax.numpy.asarray(phys)}
    tstate = {**tstate, "phys": torch.from_numpy(phys)}
    jstate, jobs, jrew = jcls(B).step(jstate, jax.numpy.asarray(actions))
    tstate, tobs, trew = tcls(B, device="cpu").step(tstate, torch.from_numpy(actions))
    for what, got, want in (("phys", tstate["phys"], jstate["phys"]), ("obs", tobs, jobs), ("reward", trew, jrew)):
        assert got.dtype == torch.float32, what
        assert tuple(got.shape) == tuple(want.shape), what
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ENV_RTOL, atol=ENV_ATOL, err_msg=what)
    assert bool((trew <= 1.0).all())
    # The config rides along as Python values, equal to the JAX state's.
    for key, value in tstate["cfg"].items():
        if isinstance(value, str):
            continue
        assert math.isclose(value, float(jstate["cfg"][key]), rel_tol=1e-6), key


def test_pendulum_wraps_angles_with_a_floor_modulo() -> None:
    th = torch.tensor([-3 * math.pi + 0.1, -math.pi - 0.1, -0.1, 0.1, math.pi + 0.1, 2.5 * math.pi])
    state = {"phys": torch.stack([th, torch.zeros_like(th)], 1), "cfg": vars(PendulumConfig())}
    _, _, reward = Pendulum(6, device="cpu").step(state, torch.zeros((6, 1)))
    wrapped = torch.tensor([-math.pi + 0.1, math.pi - 0.1, -0.1, 0.1, -math.pi + 0.1, 0.5 * math.pi])
    torch.testing.assert_close(-reward[:, 0], wrapped**2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tcls", [CartPole, Pendulum, MountainCar])
def test_resets_have_the_right_shapes_ranges_and_moments(tcls) -> None:
    n = 8192
    env = tcls(n, device="cpu")
    state, obs = env.reset(torch.Generator().manual_seed(3))
    phys = state["phys"]
    assert obs.dtype == phys.dtype == torch.float32
    assert tuple(obs.shape) == (n, env.observation_spec.shape[0])
    tol = 5 / math.sqrt(n)  # five standard errors, in units of the std
    if tcls is CartPole:
        assert tuple(phys.shape) == (n, 4)
        assert float(phys.mean().abs()) < 0.01 * tol
        assert abs(float(phys.std()) - 0.01) < 0.01 * 2 * tol
        torch.testing.assert_close(obs[:, 2], torch.cos(phys[:, 2]))
        torch.testing.assert_close(obs[:, 3], torch.sin(phys[:, 2]))
    elif tcls is Pendulum:
        th, thdot = phys.unbind(1)
        assert float(th.abs().max()) <= math.pi and float(thdot.abs().max()) <= 1.0
        assert abs(float(th.mean())) < math.pi / math.sqrt(3) * tol
        assert abs(float(th.std()) - math.pi / math.sqrt(3)) < math.pi / math.sqrt(3) * 2 * tol
        assert abs(float(thdot.std()) - 1 / math.sqrt(3)) < 2 * tol
        torch.testing.assert_close(obs, torch.stack([torch.cos(th), torch.sin(th), thdot], 1))
    else:
        position, velocity = phys.unbind(1)
        assert abs(float(position.mean()) + 0.5) < 0.05 * tol
        assert abs(float(position.std()) - 0.05) < 0.05 * 2 * tol
        assert abs(float(velocity.mean())) < 0.05 * tol
        assert torch.equal(obs, phys)
    # A second reset draws anew from the generator.
    _, obs2 = env.reset(torch.Generator().manual_seed(4))
    assert not torch.equal(obs, obs2)


@pytest.mark.parametrize(
    "tcls,jcls,config",
    [
        (CartPole, JCartPole, {"gravity": 1.0}),
        (Pendulum, JPendulum, {"g": 2.0}),
        (MountainCar, JMountainCar, {"gravity": 0.001}),
    ],
)
def test_domain_randomization_applies_per_reset(tcls, jcls, config) -> None:
    (key, value), = config.items()
    env, gen = tcls(4, device="cpu"), torch.Generator().manual_seed(0)
    state, _ = env.reset(gen, config=config)
    assert state["cfg"][key] == value
    # As in rl8_tpu, a reset without a config rebuilds the defaults.
    state, _ = env.reset(gen, state=state)
    jstate, _ = jcls(4).reset(jax.random.key(1), state=jcls(4).reset(jax.random.key(0), config=config)[0])
    assert math.isclose(state["cfg"][key], float(jstate["cfg"][key]), rel_tol=1e-6)
    assert state["cfg"][key] != value
    with pytest.raises(TypeError):
        env.reset(gen, config={"not_a_field": 1.0})


def test_cartpole_derived_fields_are_not_settable() -> None:
    cfg = CartPoleConfig(pole_mass=0.2, length=1.0, cart_mass=2.0)
    assert cfg.pole_mass_length == 0.2
    assert cfg.total_mass == 2.2
    for field in ("total_mass", "pole_mass_length"):
        with pytest.raises(TypeError):
            CartPoleConfig(**{field: 5.0})
        with pytest.raises(TypeError):
            CartPole(2, device="cpu").reset(torch.Generator(), config={field: 5.0})


def test_cartpole_integrators_differ_and_stay_finite() -> None:
    env = CartPole(8, device="cpu")
    action = torch.full((8, 1), 2, dtype=torch.int32)
    state_e, _ = env.reset(torch.Generator().manual_seed(0), config={"kinematics_integrator": "euler"})
    state_s, _ = env.reset(torch.Generator().manual_seed(0), config={"kinematics_integrator": "semi_implicit"})
    for _ in range(5):
        state_e, obs_e, _ = env.step(state_e, action)
        state_s, obs_s, _ = env.step(state_s, action)
    assert bool(torch.isfinite(obs_e).all() and torch.isfinite(obs_s).all())
    assert not torch.allclose(obs_e, obs_s)


@pytest.mark.parametrize("tcls,jcls", [(CartPole, JCartPole), (Pendulum, JPendulum), (MountainCar, JMountainCar)])
def test_specs_and_limits_match_jax(tcls, jcls) -> None:
    env, jenv = tcls(4, device="cpu"), jcls(4)
    assert tcls.max_horizon == jcls.max_horizon
    assert env.observation_spec.shape == jenv.observation_spec.shape
    assert env.action_spec.shape == jenv.action_spec.shape
    assert getattr(env.action_spec, "n", None) == getattr(jenv.action_spec, "n", None)
    # The card unless the caller asks for the CPU, as AlgorithmConfig.
    assert tcls(4).device.type == "cuda"
    for config_cls, jconfig_cls in (
        (CartPoleConfig, JCartPoleConfig), (PendulumConfig, JPendulumConfig), (MountainCarConfig, JMountainCarConfig),
    ):
        assert vars(config_cls()) == vars(jconfig_cls())


@pytest.mark.parametrize("tcls,dist", [(CartPole, Categorical), (Pendulum, Normal), (MountainCar, Categorical)])
def test_default_models_train_on_the_examples(tcls, dist) -> None:
    algo = AlgorithmConfig(num_envs=16, horizon=8, model_config={"hiddens": (16,)}, device="cpu").build(tcls)
    assert algo.policy.distribution_cls is dist
    # The act and update kernels' routes (their plain versions here).
    assert algo._fused_act and algo._fused_update
    stats = Trainer(algo).step()
    assert all(math.isfinite(v) for v in stats.values())
    assert stats["env/steps"] == 16 * 8


@pytest.mark.parametrize(
    "module,steps,horizon", [("cartpole", 40, 64), ("pendulum", 100, 128), ("mountain_car", 40, 64)]
)
def test_run_scripts_train_with_their_cadence(module, steps, horizon, monkeypatch, tmp_path) -> None:
    """Each run script trains with its horizon, reset and eval cadences and
    its stop condition; here on the CPU at 4 envs, and stopped after two
    eval intervals instead of ``steps``."""
    import tempfile

    from rl8_tpu_torch.conditions import HitsUpperBound

    script = importlib.import_module(f"rl8_tpu_torch.examples.{module}.__main__")
    built, bounds = [], []

    def small(**kwargs):
        config = AlgorithmConfig(num_envs=4, model_config={"hiddens": (8,)}, device="cpu", **kwargs)
        built.append(config)
        return config

    def two_evals(key, bound):
        bounds.append((key, bound))
        return HitsUpperBound(key, 2 * (4 if module == "pendulum" else 5))

    monkeypatch.setattr(script, "AlgorithmConfig", small)
    monkeypatch.setattr(script, "HitsUpperBound", two_evals)
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix: str(tmp_path / prefix))
    script.main()
    assert bounds == [("algorithm/steps", steps)]
    assert built[0].horizon == horizon
    (track,) = tmp_path.iterdir()
    records = [json.loads(line) for line in (track / "metrics.jsonl").read_text().splitlines()]
    evals = [r for r in records if "eval/returns/mean" in r]
    assert len(records) - len(evals) == 2 * (4 if module == "pendulum" else 5)
    assert len(evals) == 1
