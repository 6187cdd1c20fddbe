"""The slice as a whole: the port's ``collect()`` and advantage stage held
against ``rl8_tpu``'s on the CPU, from the same parameters and the same
start positions."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl8_tpu.env as jenv
import rl8_tpu_torch.env as tenv
from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
from rl8_tpu.nn.functional import generalized_advantage_estimate as jax_gae
from rl8_tpu.parallel import gmean, gstd
from rl8_tpu_torch import AlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.models import load_jax_params

NUM_ENVS, HORIZON, HIDDENS = 64, 8, (32, 32)
_POSITIONS = np.random.default_rng(0).uniform(-50, 50, size=(NUM_ENVS, 1)).astype(np.float32)

#: f32 on both sides with different summation orders; values and
#: returns reach ~1e2, so the absolute tolerance is a few ulps of that.
RTOL, ATOL = 1e-5, 1e-4


class JaxStartEnv(jenv.DiscreteDummyEnv):
    def reset(self, key, *, state=None, config=None):
        pos = jnp.asarray(_POSITIONS[: self.num_envs])
        return {"position": pos, "bounds": jnp.asarray(50.0)}, pos


class TorchStartEnv(tenv.DiscreteDummyEnv):
    def reset(self, generator, *, state=None, config=None):
        pos = torch.tensor(_POSITIONS[: self.num_envs], device=self.device)
        return {"position": pos, "bounds": torch.tensor(50.0, device=self.device)}, pos


def _config(**kw):
    return dict(
        num_envs=NUM_ENVS, horizon=HORIZON, horizons_per_env_reset=2,
        model_config={"hiddens": HIDDENS}, **kw,
    )


def _buffers_close(jbuf, tbuf) -> None:
    assert set(tbuf) == set(jbuf)
    for key in (DataKeys.OBS, DataKeys.ACTIONS):
        np.testing.assert_array_equal(tbuf[key].numpy(), np.asarray(jbuf[key]), err_msg=key)
    for key in (DataKeys.LOGP, DataKeys.VALUES, DataKeys.REWARDS, DataKeys.REVERSED_DISCOUNTED_RETURNS):
        np.testing.assert_allclose(tbuf[key].numpy(), np.asarray(jbuf[key]), rtol=RTOL, atol=ATOL, err_msg=key)


def test_collect_and_advantages_match_jax() -> None:
    jalgo = JAlgorithmConfig(**_config()).build(JaxStartEnv)
    # Logits heads at lecun scale: with the small-uniform init most
    # deterministic choices would be near-ties that rounding can flip.
    params = jax.device_get(jalgo.state.params)
    head = params["feature_head"]["kernel"]
    params["feature_head"]["kernel"] = head + 0.3 * np.random.default_rng(1).normal(size=head.shape).astype(np.float32)
    jalgo.state = jalgo.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    talgo = AlgorithmConfig(**_config(device="cpu")).build(TorchStartEnv)
    load_jax_params(talgo.policy.model, params)

    for i in range(2):  # the second collect carries the first's last obs over
        jstats = jalgo.collect(deterministic=True)
        tstats = talgo.collect(deterministic=True)
        _buffers_close(jalgo.state.buffer, talgo.state.buffer)
        np.testing.assert_allclose(
            float(talgo.state.reward_scale), float(jalgo.state.reward_scale), rtol=RTOL
        )
        assert set(tstats) == set(jstats)
        for key in jstats:
            if key.startswith(("returns/", "rewards/")):
                np.testing.assert_allclose(tstats[key], jstats[key], rtol=RTOL, atol=ATOL, err_msg=key)
        assert tstats["env/resets"] == jstats["env/resets"] == (NUM_ENVS if i == 0 else 0)
        assert tstats["env/steps"] == jstats["env/steps"]

    jbuf = jalgo.state.buffer
    j_adv, j_ret = jax_gae(
        jbuf[DataKeys.REWARDS], jbuf[DataKeys.VALUES], gae_lambda=0.95, gamma=0.95,
        normalize_advantages=False, reward_scale=jalgo.state.reward_scale,
    )
    j_adv = (j_adv - gmean(j_adv)) / (gstd(j_adv) + 1e-8)
    adv, ret = talgo._advantages()
    np.testing.assert_allclose(adv.numpy(), np.asarray(j_adv), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ret.numpy(), np.asarray(j_ret), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "extra",
    [{"model_config": {"hiddens": HIDDENS, "activation_fn": "gelu"}}, {"fused_act": False}],
    ids=["gelu", "fused-act-off"],
)
def test_module_rollout_of_a_default_model_matches_jax(extra: dict) -> None:
    """A default model the act kernel does not take, or ``fused_act=False``,
    collects through the module rollout as ``rl8_tpu`` does: two
    deterministic collects from the same weights and start positions give
    the same buffers."""
    jalgo = JAlgorithmConfig(**{**_config(), **extra}).build(JaxStartEnv)
    params = jax.device_get(jalgo.state.params)
    head = params["feature_head"]["kernel"]
    params["feature_head"]["kernel"] = head + 0.3 * np.random.default_rng(1).normal(size=head.shape).astype(np.float32)
    jalgo.state = jalgo.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    talgo = AlgorithmConfig(**{**_config(device="cpu"), **extra}).build(TorchStartEnv)
    assert not talgo._fused_act
    load_jax_params(talgo.policy.model, params)
    for _ in range(2):
        jalgo.collect(deterministic=True)
        talgo.collect(deterministic=True)
        _buffers_close(jalgo.state.buffer, talgo.state.buffer)


def test_stochastic_collect_is_seeded() -> None:
    def run(seed):
        algo = AlgorithmConfig(**_config(device="cpu", seed=seed)).build(tenv.DiscreteDummyEnv)
        algo.collect()
        algo.collect()
        return algo.state.buffer

    a, b, c = run(0), run(0), run(1)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert not torch.equal(a[DataKeys.ACTIONS], c[DataKeys.ACTIONS])
    # The second collect carried over: its first obs is not a fresh reset.
    assert float(a[DataKeys.OBS].abs().max()) <= 100.0 + HORIZON * 2


def test_reset_cadence_and_step_slice() -> None:
    algo = AlgorithmConfig(**_config(device="cpu", normalize_rewards=False)).build(TorchStartEnv)
    first = algo.collect()
    last_obs = algo.state.buffer[DataKeys.OBS][-1].clone()
    second = algo.collect()
    assert (first["env/resets"], second["env/resets"]) == (NUM_ENVS, 0)
    assert torch.equal(algo.state.buffer[DataKeys.OBS][0], last_obs)
    assert DataKeys.REVERSED_DISCOUNTED_RETURNS not in algo.state.buffer
    assert float(algo.state.reward_scale) == 1.0
    third = algo.collect()  # horizons_per_env_reset=2: a reset again
    assert third["env/resets"] == NUM_ENVS
    assert algo.state.horizons == 3 and algo.state.buffered
    final_obs = algo.state.buffer[DataKeys.OBS][-1].clone()
    stats = algo.step()  # the update slice: step() runs and clears `buffered`
    assert not algo.state.buffered
    assert all(np.isfinite(v) for v in stats.values())
    assert torch.equal(algo.state.buffer[DataKeys.OBS][-1], final_obs)
    with pytest.raises(RuntimeError, match="preceded by a `collect`"):
        algo.step()
