"""The recurrent slice as a whole: the port's ``RecurrentAlgorithm``
``collect()`` and ``step()`` held against ``rl8_tpu``'s on the CPU from
the same parameters, start positions and buffer, plus its own invariants
(the state-reset cadence, the sequence counter, accumulation, the
options it refuses) and the recurrent learning drive."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl8_tpu.env as jenv
import rl8_tpu_torch.env as tenv
from rl8_tpu import RecurrentAlgorithmConfig as JRecurrentAlgorithmConfig
from rl8_tpu_torch import RecurrentAlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.distributions import Normal, SquashedNormal
from rl8_tpu_torch.models import load_jax_params, to_jax_params

NUM_ENVS, HORIZON, SEQ_LEN = 32, 8, 2
MODEL = {"hidden_size": 16, "num_layers": 2}
STAT_KEYS = ("losses/entropy", "losses/policy", "losses/vf", "losses/total", "monitors/kl_div")
_POSITIONS = np.random.default_rng(0).uniform(-50, 50, size=(NUM_ENVS, 1)).astype(np.float32)
#: f32 on both sides with other summation orders; values and returns
#: reach ~1e2.
RTOL, ATOL = 1e-5, 1e-4
#: A step from the same buffer: the losses agree to ~1e-6 relative, which
#: four Adam steps carry into the parameters; Adam divides each gradient
#: by its own magnitude, so the parameters are held by a norm-relative
#: error of their change (as tests/test_torch_step.py holds the
#: feedforward step).
STAT_RTOL, STAT_ATOL, DELTA_REL = 1e-4, 1e-6, 1e-3


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
        num_envs=NUM_ENVS, horizon=HORIZON, seq_len=SEQ_LEN, seqs_per_state_reset=2,
        horizons_per_env_reset=2, model_config=MODEL, **kw,
    )


def _pair(**kw):
    """Both packages' recurrent algorithms with the JAX one's parameters,
    the logits head re-drawn at a scale where argmaxes are clear."""
    jalgo = JRecurrentAlgorithmConfig(**_config(**kw)).build(JaxStartEnv)
    params = jax.device_get(jalgo.state.params)
    head = params["feature_head"]["kernel"]
    params["feature_head"]["kernel"] = (0.5 * np.random.default_rng(1).normal(size=head.shape)).astype(np.float32)
    jalgo.state = jalgo.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    talgo = RecurrentAlgorithmConfig(**_config(device="cpu", **kw)).build(TorchStartEnv)
    load_jax_params(talgo.policy.model, params)
    return jalgo, talgo, params


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def test_collect_matches_jax() -> None:
    """Two deterministic collects (the second carries obs and states over),
    with states re-initialized every 2 sequences of 2 steps: the buffer,
    per-step states included, the stats, the reward scale and the
    sequence counter match ``rl8_tpu``'s."""
    jalgo, talgo, _ = _pair()
    for i in range(2):
        jstats = jalgo.collect(deterministic=True)
        tstats = talgo.collect(deterministic=True)
        jbuf, tbuf = jalgo.state.buffer, talgo.state.buffer
        assert set(tbuf) == set(jbuf)
        for key in (DataKeys.OBS, DataKeys.ACTIONS):
            np.testing.assert_array_equal(tbuf[key].numpy(), np.asarray(jbuf[key]), err_msg=key)
        for key in (DataKeys.LOGP, DataKeys.VALUES, DataKeys.REWARDS, DataKeys.REVERSED_DISCOUNTED_RETURNS):
            np.testing.assert_allclose(tbuf[key].numpy(), np.asarray(jbuf[key]), rtol=RTOL, atol=ATOL, err_msg=key)
        for key in (DataKeys.HIDDEN_STATES, DataKeys.CELL_STATES):
            got, want = tbuf[DataKeys.STATES][key], jbuf[DataKeys.STATES][key]
            assert tuple(got.shape) == (HORIZON + 1, NUM_ENVS, 2, 16)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=key)
        np.testing.assert_allclose(float(talgo.state.reward_scale), float(jalgo.state.reward_scale), rtol=RTOL)
        assert talgo.state.seqs == int(jalgo.state.seqs) == (i + 1) * HORIZON // SEQ_LEN
        assert set(tstats) == set(jstats)
        for key in jstats:
            if key.startswith(("returns/", "rewards/")):
                np.testing.assert_allclose(tstats[key], jstats[key], rtol=RTOL, atol=ATOL, err_msg=key)
        assert tstats["env/resets"] == jstats["env/resets"] == (NUM_ENVS if i == 0 else 0)


@pytest.mark.parametrize(
    "extra",
    [
        {},
        {"entropy_coeff": 0.01, "dual_clip_param": 3.0, "target_kl_div": 1e-8},
        {"accumulate_grads": True, "sgd_minibatch_size": NUM_ENVS * HORIZON // SEQ_LEN // 4},
    ],
    ids=["whole-buffer", "entropy-dual-kl-stop", "accumulate"],
)
def test_step_matches_jax(extra: dict) -> None:
    """One ``step()`` in each package from the same parameters and the same
    buffer (``rl8_tpu``'s, handed to the port): the stats, the parameters
    afterwards in the flax layout, Adam's count, and the buffer kept for
    the next collect (final obs and final states). The whole-buffer and
    accumulating cases skip the minibatch shuffle in both."""
    jalgo, talgo, params0 = _pair(seed=3, **extra)
    jalgo.collect()
    jbuf = jax.device_get(jalgo.state.buffer)
    talgo.state.buffer = {
        k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()} if isinstance(v, dict) else torch.from_numpy(np.array(v))
        for k, v in jbuf.items()
    }
    talgo.state.reward_scale = torch.tensor(float(jalgo.state.reward_scale))
    talgo.state.horizons = int(jalgo.state.horizons)
    talgo.state.buffered = True
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
    assert not talgo.state.buffered
    tbuf = talgo.state.buffer
    np.testing.assert_array_equal(tbuf[DataKeys.OBS][-1].numpy(), jbuf[DataKeys.OBS][-1])
    for key, value in jbuf[DataKeys.STATES].items():
        np.testing.assert_array_equal(tbuf[DataKeys.STATES][key][-1].numpy(), value[-1])
        assert float(tbuf[DataKeys.STATES][key][:-1].abs().max()) == 0.0


def _port(**kw):
    cfg = dict(num_envs=4, horizon=4, seq_len=2, seqs_per_state_reset=2, model_config={"hidden_size": 8}, device="cpu")
    return RecurrentAlgorithmConfig(**{**cfg, **kw}).build(tenv.DiscreteDummyEnv)


def test_state_reset_cadence_and_counter() -> None:
    """With ``seqs_per_state_reset=1`` the stored input states are zeros at
    every sequence start and not in between; a negative cadence resets
    them only at the very first step; the sequence counter advances by
    horizon / seq_len per collect (``rl8_tpu``'s
    ``test_recurrent_algorithm_seq_counters`` and cadence tests)."""
    algo = _port(seqs_per_state_reset=1)
    algo.collect()
    states = algo.state.buffer[DataKeys.STATES][DataKeys.HIDDEN_STATES]
    assert float(states[0].abs().max()) == float(states[2].abs().max()) == 0.0
    assert float(states[1].abs().max()) > 0.0 and float(states[3].abs().max()) > 0.0
    assert algo.state.horizons == 1 and algo.state.seqs == 2
    algo.collect()
    assert algo.state.horizons == 2 and algo.state.seqs == 4

    algo = _port(seqs_per_state_reset=-1, horizons_per_env_reset=-1)
    algo.collect()
    first = algo.state.buffer[DataKeys.STATES][DataKeys.HIDDEN_STATES]
    assert float(first[0].abs().max()) == 0.0 and float(first[1:].abs().amax(dim=(1, 2, 3)).min()) > 0.0
    algo.collect()
    second = algo.state.buffer[DataKeys.STATES][DataKeys.HIDDEN_STATES]
    assert float(second.abs().amax(dim=(1, 2, 3)).min()) > 0.0
    # A collect carries the previous one's final states in.
    assert torch.equal(second[0], first[-1])


@pytest.mark.parametrize("env_cls", [tenv.ContinuousDummyEnv, tenv.DiscreteDummyEnv])
def test_accumulation_equivalence(env_cls) -> None:
    """Same seed: accumulated and non-accumulated steps give matching
    losses (``rl8_tpu``'s ``test_recurrent_accumulation_equivalence``)."""
    common = dict(
        num_envs=16, horizon=8, seq_len=2, seqs_per_state_reset=4, seed=42, model_config={"hidden_size": 8},
        entropy_coeff=1e-2 if env_cls is tenv.DiscreteDummyEnv else 0.0, device="cpu",
    )
    algo = RecurrentAlgorithmConfig(**common).build(env_cls)
    algo.collect()
    non_accumulated = algo.step()
    algo = RecurrentAlgorithmConfig(**common, accumulate_grads=True, sgd_minibatch_size=16).build(env_cls)
    algo.collect()
    accumulated = algo.step()
    for key in STAT_KEYS:
        assert math.isclose(non_accumulated[key], accumulated[key], rel_tol=1e-3, abs_tol=1e-5), key


def test_step_requires_collect_and_train_steps() -> None:
    algo = _port()
    with pytest.raises(RuntimeError, match="preceded by a `collect`"):
        algo.step()
    algo.collect()
    algo.step()
    with pytest.raises(RuntimeError, match="preceded by a `collect`"):
        algo.step()
    records = algo.train_steps(2)
    assert len(records) == 2 and all("profiling/train_ms" in r and "losses/total" in r for r in records)
    assert algo.state.horizons == 3 and algo.state.seqs == 6
    with pytest.raises(ValueError):
        algo.train_steps(0)


@pytest.mark.parametrize(
    "kw,error",
    [
        ({"model": object()}, NotImplementedError),
        ({"model_cls": object}, NotImplementedError),
        ({"fused_update": False}, NotImplementedError),
        ({"enable_amp": True}, NotImplementedError),
        ({"optimizer_cls": object()}, NotImplementedError),
        ({"flatten_optimizer": False}, NotImplementedError),
        ({"mesh": object()}, NotImplementedError),
        ({"optimizer_config": {"lr": 1e-3, "nesterov": True}}, NotImplementedError),
        ({"distribution_cls": Normal}, NotImplementedError),
        ({"model_config": {"hidden_size": 8, "num_layers": 9}}, NotImplementedError),
        ({"model_config": {"hidden_size": 8, "bias": False}}, NotImplementedError),
        ({"seq_len": 3}, ValueError),
        ({"seqs_per_state_reset": 0}, ValueError),
        ({"sgd_minibatch_size": 3}, ValueError),
        ({"fused_act": False}, NotImplementedError),
        ({"exact_sharding": True}, NotImplementedError),
    ],
)
def test_unported_and_invalid_configurations_raise(kw: dict, error: type) -> None:
    with pytest.raises(error):
        _port(**kw)


def test_fused_forward_is_accepted_and_off_like_jax() -> None:
    """``fused_forward=True`` on the default recurrent model builds and
    stays off, as in ``rl8_tpu`` (the model declares no
    ``FusedRecurrentApplySpec``), and the algorithm collects and steps as
    without it; ``fused_update=False`` raises ``NotImplementedError``
    naming the missing autodiff route, not ``TypeError``."""
    kw = dict(num_envs=4, horizon=4, seq_len=2, seqs_per_state_reset=2, model_config={"hidden_size": 8})
    jalgo = JRecurrentAlgorithmConfig(fused_forward=True, **kw).build(jenv.DiscreteDummyEnv)
    talgo = RecurrentAlgorithmConfig(fused_forward=True, device="cpu", **kw).build(tenv.DiscreteDummyEnv)
    assert talgo._fused_forward is jalgo._fused_forward is False
    talgo.collect()
    assert all(math.isfinite(v) for v in talgo.step().values())
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #5"):
        RecurrentAlgorithmConfig(fused_update=False, device="cpu", **kw).build(tenv.DiscreteDummyEnv)


def test_wide_model_trains_on_the_cpu() -> None:
    """The CPU's plain update takes any width: a 1024-wide LSTM, past the
    card kernel's shared-memory limit (``card_takes_rnn_update``, held
    on the card by ``chip_smoke.py``), builds, collects and steps."""
    algo = _port(model_config={"hidden_size": 1024})
    algo.collect()
    stats = algo.step()
    assert all(math.isfinite(stats[key]) for key in STAT_KEYS)


def test_zero_seq_len_raises_the_hparams_error() -> None:
    """``seq_len=0`` with the default (whole-buffer) minibatch raises the
    hyperparameters' own ``ValueError``; ``rl8_tpu`` divides by it first
    (``rl8_tpu/algorithms/_recurrent.py:176``) and raises
    ``ZeroDivisionError`` (ROADMAP Queue 3)."""
    with pytest.raises(ValueError, match="`seq_len` must be > 0"):
        _port(seq_len=0)
    with pytest.raises(ZeroDivisionError):
        JRecurrentAlgorithmConfig(num_envs=4, horizon=4, seq_len=0, model_config={"hidden_size": 8}).build(
            jenv.DiscreteDummyEnv
        )


def test_squashed_normal_needs_zero_entropy() -> None:
    config = dict(
        num_envs=4, horizon=4, seq_len=2, seqs_per_state_reset=2, model_config={"hidden_size": 8}, device="cpu",
        distribution_cls=SquashedNormal,
    )
    with pytest.raises(NotImplementedError, match="SquashedNormal"):
        RecurrentAlgorithmConfig(**config, entropy_coeff=0.01).build(tenv.ContinuousDummyEnv)
    algo = RecurrentAlgorithmConfig(**config).build(tenv.ContinuousDummyEnv)
    algo.collect()
    assert float(algo.state.buffer[DataKeys.ACTIONS].abs().max()) <= 1.0
    assert all(math.isfinite(v) for v in algo.step().values())


def test_build_defaults_to_cuda() -> None:
    assert RecurrentAlgorithmConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build would succeed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RecurrentAlgorithmConfig(num_envs=4, horizon=4).build(tenv.DiscreteDummyEnv)


def test_learning_drive_on_cpu() -> None:
    """``rl8_tpu``'s recurrent learning test's settings (64 envs, horizon
    16, seq_len 4, states reset every 4 sequences, one 16-wide layer, seed
    1, 15 iterations with bounds 10): the mean return must rise."""
    algo = RecurrentAlgorithmConfig(
        num_envs=64, horizon=16, seq_len=4, seqs_per_state_reset=4, seed=1,
        model_config={"hidden_size": 16}, device="cpu",
    ).build(tenv.DiscreteDummyEnv)
    first = None
    for _ in range(15):
        stats = algo.collect(env_config={"bounds": 10.0})
        if first is None:
            first = stats["returns/mean"]
        algo.step()
    assert stats["returns/mean"] > first
