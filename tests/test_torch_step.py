"""The update slice as a whole: the port's ``Algorithm.step()`` held
against ``rl8_tpu``'s on the CPU from the same parameters and the same
buffer, plus its own invariants (accumulation, permutation invariance,
the KL early stop, the scheduler cadence) and the learning drive of the
verify recipe."""

from __future__ import annotations

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl8_tpu.env as jenv
import rl8_tpu_torch.env as tenv
from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
from rl8_tpu_torch import AlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.models import load_jax_params, to_jax_params

NUM_ENVS, HORIZON, HIDDENS = 64, 8, (32, 32)
STAT_KEYS = ("losses/entropy", "losses/policy", "losses/vf", "losses/total", "monitors/kl_div")
#: f32 on both sides, from the same buffer and parameters: the losses and
#: gradients agree to ~1e-6 relative (XLA's and ATen's summation orders),
#: which four Adam steps carry into the parameters. Adam divides each
#: gradient by its own magnitude, so a parameter whose gradient is pure
#: rounding noise may move by up to lr per step in either package: the
#: parameters are held by a norm-relative error of their change instead
#: of elementwise.
STAT_RTOL, STAT_ATOL = 1e-4, 1e-6
DELTA_REL = 1e-3


def _jax_params(jalgo):
    params = jax.device_get(jalgo.state.params)
    # Logits head at lecun scale, so the policy is far from uniform.
    head = params["feature_head"]["kernel"]
    params["feature_head"]["kernel"] = head + 0.3 * np.random.default_rng(1).normal(size=head.shape).astype(np.float32)
    jalgo.state = jalgo.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    return params


def _copy_rollout(jalgo, talgo) -> None:
    """Hand the JAX algorithm's collected buffer (and reward scale) to the
    port, so both steps start from bit-identical inputs."""
    talgo.state.buffer = {k: torch.from_numpy(np.array(v)) for k, v in jalgo.state.buffer.items()}
    talgo.state.reward_scale = torch.tensor(float(jalgo.state.reward_scale))
    talgo.state.horizons = int(jalgo.state.horizons)
    talgo.state.buffered = True


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize(
    "extra",
    [
        {},
        {"entropy_coeff": 0.01, "dual_clip_param": 3.0, "target_kl_div": 1e-8},
        {"accumulate_grads": True, "sgd_minibatch_size": NUM_ENVS * HORIZON // 4},
    ],
    ids=["whole-buffer", "entropy-dual-kl-stop", "accumulate"],
)
def test_step_matches_jax(extra: dict) -> None:
    """One ``step()`` in each package from the same parameters and buffer:
    the stats, and the parameters afterwards in the flax layout. The
    whole-buffer and accumulating cases skip the shuffle in both."""
    config = dict(num_envs=NUM_ENVS, horizon=HORIZON, model_config={"hiddens": HIDDENS}, seed=3, **extra)
    jalgo = JAlgorithmConfig(**config).build(jenv.DiscreteDummyEnv)
    params0 = _jax_params(jalgo)
    talgo = AlgorithmConfig(**config, device="cpu").build(tenv.DiscreteDummyEnv)
    load_jax_params(talgo.policy.model, params0)
    jalgo.collect()
    _copy_rollout(jalgo, talgo)
    jstats = jalgo.step()
    tstats = talgo.step()

    assert set(tstats) == set(jstats)
    for key in STAT_KEYS:
        assert math.isclose(tstats[key], jstats[key], rel_tol=STAT_RTOL, abs_tol=STAT_ATOL), (key, tstats[key], jstats[key])
    assert tstats["coefficients/entropy"] == jstats["coefficients/entropy"]
    start = _flat(params0)
    jdelta = _flat(jax.device_get(jalgo.state.params)) - start
    tdelta = _flat(to_jax_params(talgo.policy.model)) - start
    assert np.linalg.norm(jdelta) > 0
    assert np.linalg.norm(tdelta - jdelta) <= DELTA_REL * np.linalg.norm(jdelta)
    # Adam's step count: one per applied update, as optax counts.
    jcount = int(jax.tree_util.tree_leaves(jalgo.state.opt_state.inner_state)[0])
    assert int(talgo.state.opt_state.count) == jcount
    assert not talgo.state.buffered


def _port(seed: int = 42, **kw):
    cfg = dict(num_envs=16, horizon=8, seed=seed, model_config={"hiddens": (16, 16)}, device="cpu")
    return AlgorithmConfig(**{**cfg, **kw}).build(tenv.DiscreteDummyEnv)


def test_accumulation_equivalence() -> None:
    """Same seed: accumulated and non-accumulated steps give matching
    losses (the counterpart of ``tests/test_algorithms.py``'s)."""
    algo = _port(entropy_coeff=1e-2)
    algo.collect()
    non_accumulated = algo.step()
    algo = _port(entropy_coeff=1e-2, accumulate_grads=True, sgd_minibatch_size=16)
    algo.collect()
    accumulated = algo.step()
    for key in STAT_KEYS:
        assert math.isclose(non_accumulated[key], accumulated[key], rel_tol=1e-3, abs_tol=1e-5), key


def test_full_epoch_accumulation_is_permutation_invariant() -> None:
    """With ``accumulate_grads`` the optimizer applies once per epoch, so
    permuting whole envs in the buffer must leave the step's losses and
    parameters unchanged (why the epoch shuffle is skipped)."""
    algo = _port(seed=7, accumulate_grads=True, sgd_minibatch_size=16)
    algo.collect()
    state = copy.deepcopy(algo.state)
    model_state = copy.deepcopy(algo.policy.model.state_dict())
    stats = algo.step()
    params = to_jax_params(algo.policy.model)

    perm = torch.from_numpy(np.random.default_rng(0).permutation(algo.hparams.num_envs))
    state.buffer = {k: v[:, perm] for k, v in state.buffer.items()}
    algo.state = state
    algo.policy.model.load_state_dict(model_state)
    stats_perm = algo.step()
    for key in ("losses/policy", "losses/vf", "losses/total"):
        assert math.isclose(stats[key], stats_perm[key], rel_tol=1e-4, abs_tol=1e-6), key
    np.testing.assert_allclose(_flat(to_jax_params(algo.policy.model)), _flat(params), rtol=1e-4, atol=1e-6)


def test_step_requires_collect() -> None:
    algo = _port()
    with pytest.raises(RuntimeError, match="preceded by a `collect`"):
        algo.step()
    algo.collect()
    algo.step()
    with pytest.raises(RuntimeError, match="preceded by a `collect`"):
        algo.step()


def test_kl_early_stop() -> None:
    """With a tiny ``target_kl_div`` the first minibatch (KL ~0 at the
    rollout's parameters) updates, the second triggers the stop: its
    stats still count, no later minibatch does, and Adam counts one
    update. Without a target every minibatch of every epoch updates."""
    mb = 16 * 8 // 4
    algo = _port(target_kl_div=1e-8, sgd_minibatch_size=mb)
    algo.collect()
    stopped = algo.step()
    assert int(algo.state.opt_state.count) == 1
    assert stopped["monitors/kl_div"] > 0 and all(math.isfinite(stopped[k]) for k in STAT_KEYS)
    algo = _port(sgd_minibatch_size=mb)
    algo.collect()
    algo.step()
    assert int(algo.state.opt_state.count) == 4 * algo.hparams.num_sgd_iters


def test_scheduler_cadence_matches_jax() -> None:
    """The entropy coefficient reported per step and the learning rate
    after each step follow the schedules at ``num_envs * horizons``, as
    in ``rl8_tpu``; ``train_steps`` keeps the same cadence."""
    kw = dict(
        num_envs=16, horizon=4, model_config={"hiddens": (8,)},
        lr_schedule=[(0, 1e-3), (32, 5e-4)],
        entropy_coeff_schedule=[(0, 0.02), (48, 0.0)], entropy_coeff_schedule_kind="interp",
    )
    jalgo = JAlgorithmConfig(**kw).build(jenv.DiscreteDummyEnv)
    talgo = AlgorithmConfig(**kw, device="cpu").build(tenv.DiscreteDummyEnv)
    trained = AlgorithmConfig(**kw, device="cpu").build(tenv.DiscreteDummyEnv)
    records = trained.train_steps(3)
    for i in range(3):
        jalgo.collect()
        talgo.collect()
        jstats, tstats = jalgo.step(), talgo.step()
        assert tstats["coefficients/entropy"] == pytest.approx(jstats["coefficients/entropy"], abs=1e-12)
        assert records[i]["coefficients/entropy"] == tstats["coefficients/entropy"]
        assert talgo.lr_scheduler.coeff == jalgo.lr_scheduler.coeff
        assert talgo.entropy_scheduler.coeff == pytest.approx(jalgo.entropy_scheduler.coeff, abs=1e-12)
    assert [r["coefficients/entropy"] for r in records] == pytest.approx([0.02, 0.02 * 2 / 3, 0.02 / 3])
    assert trained.lr_scheduler.coeff == talgo.lr_scheduler.coeff == 5e-4
    expected_keys = {
        "returns/min", "returns/max", "returns/mean", "returns/std", "rewards/min", "rewards/max",
        "rewards/mean", "rewards/std", "env/resets", "env/steps", *STAT_KEYS,
        "coefficients/entropy", "coefficients/vf", "profiling/train_ms",
    }
    assert all(set(r) == expected_keys for r in records)
    with pytest.raises(ValueError):
        trained.train_steps(0)


@pytest.mark.parametrize(
    "kw,error",
    [
        ({"optimizer_cls": object()}, NotImplementedError),
        ({"flatten_optimizer": False}, NotImplementedError),
        ({"enable_amp": True}, NotImplementedError),
        ({"mesh": object()}, NotImplementedError),
        ({"optimizer_config": {"lr": 1e-3, "nesterov": True}}, NotImplementedError),
        ({"exact_sharding": True}, NotImplementedError),
        ({"optimizer_config": {"lr": 1e-3, "learning_rate": 1e-3}}, ValueError),
    ],
)
def test_unported_configurations_raise(kw: dict, error: type) -> None:
    with pytest.raises(error):
        AlgorithmConfig(**{"num_envs": 4, "horizon": 2, "model_config": {"hiddens": (8,)}, "device": "cpu", **kw}).build(
            tenv.DiscreteDummyEnv
        )


@pytest.mark.parametrize(
    "extra,fused",
    [
        ({"model_config": {"hiddens": HIDDENS, "activation_fn": "gelu"}}, (False, False)),
        ({"model_config": {"hiddens": HIDDENS, "bias": False}}, (False, False)),
        ({"model_config": {"hiddens": (8,) * 9}}, (False, False)),
        ({"fused_update": False, "fused_act": False}, (False, False)),
        ({"fused_act": False}, (False, True)),
    ],
    ids=["gelu", "no-bias", "nine-layers", "fused-off", "module-rollout-update-kernel"],
)
def test_default_models_off_the_kernels_match_jax(extra: dict, fused: tuple) -> None:
    """Default models the kernels do not take, and the kernels turned off,
    train as ``rl8_tpu`` trains them (module rollout, autodiff update):
    one whole-buffer ``step()`` from the same numpy weights and buffer
    gives the same losses and parameters. ``fused_act=False`` alone keeps
    the update kernel (its plain version here) behind the module rollout."""
    config = dict(num_envs=NUM_ENVS, horizon=HORIZON, model_config={"hiddens": HIDDENS}, seed=3,
                  entropy_coeff=0.01)
    config.update(extra)
    jalgo = JAlgorithmConfig(**config).build(jenv.DiscreteDummyEnv)
    params0 = _jax_params(jalgo)
    talgo = AlgorithmConfig(**config, device="cpu").build(tenv.DiscreteDummyEnv)
    assert (talgo._fused_act, talgo._fused_update) == fused
    load_jax_params(talgo.policy.model, params0)
    jalgo.collect()
    _copy_rollout(jalgo, talgo)
    jstats, tstats = jalgo.step(), talgo.step()
    for key in STAT_KEYS:
        assert math.isclose(tstats[key], jstats[key], rel_tol=STAT_RTOL, abs_tol=STAT_ATOL), (key, tstats[key], jstats[key])
    start = _flat(params0)
    jdelta = _flat(jax.device_get(jalgo.state.params)) - start
    tdelta = _flat(to_jax_params(talgo.policy.model)) - start
    assert np.linalg.norm(jdelta) > 0
    assert np.linalg.norm(tdelta - jdelta) <= DELTA_REL * np.linalg.norm(jdelta)
    assert int(talgo.state.opt_state.count) == int(jax.tree_util.tree_leaves(jalgo.state.opt_state.inner_state)[0])


def test_learning_drive_on_cpu() -> None:
    """The verify recipe's end-to-end drive: 30 collect+step iterations
    at 256 envs, horizon 16, seed 1 and the default model; the greedy
    policy must push every position toward the origin."""
    algo = AlgorithmConfig(num_envs=256, horizon=16, seed=1, device="cpu").build(tenv.DiscreteDummyEnv)
    for _ in range(30):
        algo.collect(env_config={"bounds": 10.0})
        algo.step()
    obs = torch.tensor([[[5.0]], [[-5.0]], [[2.0]], [[-2.0]]])
    out = algo.policy.sample({DataKeys.OBS: obs}, kind="last", deterministic=True)
    assert out[DataKeys.ACTIONS].ravel().tolist() == [0, 1, 0, 1]
