"""The continuous slice as a whole: the port's ``collect()`` and
``step()`` on ``ContinuousDummyEnv`` with ``Normal`` and
``SquashedNormal`` held against ``rl8_tpu``'s on the CPU, from the same
parameters and the same start positions or buffer, and the learning
drive."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl8_tpu.distributions as jdist
import rl8_tpu.env as jenv
import rl8_tpu_torch.distributions as tdist
import rl8_tpu_torch.env as tenv
from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
from rl8_tpu_torch import AlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.models import load_jax_params, to_jax_params
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUM_ENVS, HORIZON, HIDDENS = 64, 8, (32, 32)
_POSITIONS = np.random.default_rng(0).uniform(-50, 50, size=(NUM_ENVS, 1)).astype(np.float32)
STAT_KEYS = ("losses/entropy", "losses/policy", "losses/vf", "losses/total", "monitors/kl_div")
#: f32 on both sides with different summation orders: values and returns
#: reach ~1e2; see tests/test_torch_step.py for the step's tolerances.
RTOL, ATOL = 1e-5, 1e-4
STAT_RTOL, STAT_ATOL = 1e-4, 1e-6
DELTA_REL = 1e-3


class JaxStartEnv(jenv.ContinuousDummyEnv):
    def reset(self, key, *, state=None, config=None):
        pos = jnp.asarray(_POSITIONS[: self.num_envs])
        return {"position": pos, "bounds": jnp.asarray(50.0)}, pos


class TorchStartEnv(tenv.ContinuousDummyEnv):
    def reset(self, generator, *, state=None, config=None):
        pos = torch.tensor(_POSITIONS[: self.num_envs], device=self.device)
        return {"position": pos, "bounds": torch.tensor(50.0, device=self.device)}, pos


def _pair(dist: str, env=(JaxStartEnv, TorchStartEnv), **kw):
    """Both packages' algorithms from one config, the port's loaded with
    the JAX package's parameters, the mean head moved off its small init
    so that actions depend on the observation."""
    config = dict(num_envs=NUM_ENVS, horizon=HORIZON, model_config={"hiddens": HIDDENS}, **kw)
    jalgo = JAlgorithmConfig(**config, distribution_cls=getattr(jdist, dist)).build(env[0])
    params = jax.device_get(jalgo.state.params)
    head = params["action_mean"]["kernel"]
    params["action_mean"]["kernel"] = head + 0.01 * np.random.default_rng(1).normal(size=head.shape).astype(np.float32)
    jalgo.state = jalgo.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    talgo = AlgorithmConfig(**config, distribution_cls=getattr(tdist, dist), device="cpu").build(env[1])
    load_jax_params(talgo.policy.model, params)
    return jalgo, talgo, params


@pytest.mark.parametrize("dist", ["Normal", "SquashedNormal"])
def test_deterministic_collect_matches_jax(dist: str) -> None:
    """Two deterministic collects (the second carrying over) from the same
    parameters and start positions: the whole buffer, f32 actions
    included, and the reward scale."""
    jalgo, talgo, _ = _pair(dist, horizons_per_env_reset=2)
    for _ in range(2):
        jalgo.collect(deterministic=True)
        talgo.collect(deterministic=True)
        jbuf, tbuf = jalgo.state.buffer, talgo.state.buffer
        assert set(tbuf) == set(jbuf) and tbuf[DataKeys.ACTIONS].dtype == torch.float32
        for key in jbuf:
            np.testing.assert_allclose(tbuf[key].numpy(), np.asarray(jbuf[key]), rtol=RTOL, atol=ATOL, err_msg=key)
        assert float(tbuf[DataKeys.ACTIONS].abs().max()) > 0.1
        np.testing.assert_allclose(float(talgo.state.reward_scale), float(jalgo.state.reward_scale), rtol=RTOL)


def _copy_rollout(jalgo, talgo) -> None:
    talgo.state.buffer = {k: torch.from_numpy(np.array(v)) for k, v in jalgo.state.buffer.items()}
    talgo.state.reward_scale = torch.tensor(float(jalgo.state.reward_scale))
    talgo.state.horizons = int(jalgo.state.horizons)
    talgo.state.buffered = True


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize(
    "dist,extra",
    [
        ("SquashedNormal", {}),
        ("SquashedNormal", {"dual_clip_param": 3.0, "accumulate_grads": True, "sgd_minibatch_size": NUM_ENVS * HORIZON // 4}),
        ("Normal", {"entropy_coeff": 0.01, "dual_clip_param": 3.0, "target_kl_div": 1e-8}),
    ],
    ids=["squashed-whole-buffer", "squashed-dual-accumulate", "normal-entropy-dual-kl-stop"],
)
def test_step_matches_jax(dist: str, extra: dict) -> None:
    """One ``step()`` in each package from the same parameters and the
    JAX package's stochastic buffer (gamma 0.99, lambda 0.95, as the JAX
    package's continuous bench line): the stats, and the parameters
    afterwards in the flax layout. No case shuffles."""
    jalgo, talgo, params0 = _pair(dist, env=(jenv.ContinuousDummyEnv, tenv.ContinuousDummyEnv), seed=3,
                                  gamma=0.99, gae_lambda=0.95, **extra)
    jalgo.collect()
    _copy_rollout(jalgo, talgo)
    jstats = jalgo.step()
    tstats = talgo.step()
    assert set(tstats) == set(jstats)
    for key in STAT_KEYS:
        assert math.isclose(tstats[key], jstats[key], rel_tol=STAT_RTOL, abs_tol=STAT_ATOL), (key, tstats[key], jstats[key])
    start = _flat(params0)
    jdelta = _flat(jax.device_get(jalgo.state.params)) - start
    tdelta = _flat(to_jax_params(talgo.policy.model)) - start
    assert np.linalg.norm(jdelta) > 0
    assert np.linalg.norm(tdelta - jdelta) <= DELTA_REL * np.linalg.norm(jdelta)
    jcount = int(jax.tree_util.tree_leaves(jalgo.state.opt_state.inner_state)[0])
    assert int(talgo.state.opt_state.count) == jcount


def test_stochastic_continuous_collect_is_seeded() -> None:
    def run(seed):
        algo = AlgorithmConfig(num_envs=16, horizon=4, seed=seed, model_config={"hiddens": (8,)},
                               distribution_cls=tdist.SquashedNormal, device="cpu").build(tenv.ContinuousDummyEnv)
        algo.collect()
        return algo.state.buffer

    a, b, c = run(0), run(0), run(1)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert not torch.equal(a[DataKeys.ACTIONS], c[DataKeys.ACTIONS])
    assert float(a[DataKeys.ACTIONS].abs().max()) <= 1.0


def test_continuous_learning_drive_on_cpu() -> None:
    """The learning drive chip_smoke.py runs on the card: SquashedNormal,
    256 envs, horizon 16, seed 1, 30 iterations with bounds 10 (rl8_tpu
    learns it too, for seeds 1-3); the greedy action must point toward
    the origin, with magnitude above 0.5 at +-5."""
    algo = AlgorithmConfig(num_envs=256, horizon=16, seed=1, distribution_cls=tdist.SquashedNormal,
                           device="cpu").build(tenv.ContinuousDummyEnv)
    for _ in range(30):
        algo.collect(env_config={"bounds": 10.0})
        algo.step()
    obs = torch.tensor([[[5.0]], [[-5.0]], [[2.0]], [[-2.0]]])
    actions = algo.policy.sample({DataKeys.OBS: obs}, kind="last", deterministic=True)[DataKeys.ACTIONS].ravel().tolist()
    assert [math.copysign(1.0, a) for a in actions] == [-1.0, 1.0, -1.0, 1.0], actions
    assert min(abs(actions[0]), abs(actions[1])) > 0.5, actions
