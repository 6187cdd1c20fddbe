"""The recurrent module rollout and autodiff update (``fused_act=False``,
``fused_update=False``, and default recurrent models the kernels do not
take) against ``rl8_tpu`` on the CPU from the same numpy weights, and the
route table: the port's ``_fused_act``, ``_fused_update`` and
``_fused_forward`` against ``rl8_tpu``'s for each model, dtype and flag."""

from __future__ import annotations

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl8_tpu.env as jenv
import rl8_tpu_torch.env as tenv
from examples.algotrading.env import AlgoTrading as JAlgoTrading
from examples.algotrading.models import MischievousMule as JMischievousMule
from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
from rl8_tpu import RecurrentAlgorithmConfig as JRecurrentAlgorithmConfig
from rl8_tpu.algorithms._feedforward import Algorithm as JAlgorithm
from rl8_tpu.algorithms._recurrent import RecurrentAlgorithm as JRecurrentAlgorithm
from rl8_tpu.distributions import SquashedNormal as JSquashedNormal
from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.distributions import SquashedNormal
from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule
from rl8_tpu_torch.models import load_jax_params, to_jax_params
from tests.test_torch_recurrent_step import JaxStartEnv, TorchStartEnv

NUM_ENVS, HORIZON, SEQ_LEN = 32, 8, 2
STAT_KEYS = ("losses/entropy", "losses/policy", "losses/vf", "losses/total", "monitors/kl_div")
#: As ``tests/test_torch_recurrent_step.py``: f32 on both sides with other
#: summation orders; values and returns reach ~1e2.
RTOL, ATOL = 1e-5, 1e-4
#: A step from the same buffer: the losses to ~1e-6 relative, which four
#: Adam steps carry into the parameters, held by a norm-relative error of
#: their change.
STAT_RTOL, STAT_ATOL, DELTA_REL = 1e-4, 1e-6, 1e-3


def _config(model=None, **kw):
    return dict(
        num_envs=NUM_ENVS, horizon=HORIZON, seq_len=SEQ_LEN, seqs_per_state_reset=2, horizons_per_env_reset=2,
        model_config=model or {"hidden_size": 16, "num_layers": 2}, **kw,
    )


def _pair(model=None, **kw):
    """Both packages' recurrent algorithms with the JAX one's parameters,
    the logits head re-drawn at a scale where argmaxes are clear."""
    jalgo = JRecurrentAlgorithmConfig(**_config(model, **kw)).build(JaxStartEnv)
    params = jax.device_get(jalgo.state.params)
    head = params["feature_head"]["kernel"]
    params["feature_head"]["kernel"] = (0.5 * np.random.default_rng(1).normal(size=head.shape)).astype(np.float32)
    jalgo.state = jalgo.state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    talgo = RecurrentAlgorithmConfig(**_config(model, device="cpu", **kw)).build(TorchStartEnv)
    load_jax_params(talgo.policy.model, params)
    return jalgo, talgo, params


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


NINE = {"hidden_size": 8, "num_layers": 9}


@pytest.mark.parametrize(
    "model,kw,fused",
    [
        (None, {"fused_act": False}, (False, True)),
        (None, {"fused_act": False, "fused_update": False}, (False, False)),
        (NINE, {}, (False, False)),
    ],
    ids=["fused-act-off", "both-off", "nine-layers"],
)
def test_module_rollout_matches_jax(model, kw: dict, fused: tuple) -> None:
    """Two deterministic collects through the module rollout (the model's
    forward per step from the carried states, the states re-initialized
    every 2 sequences of 2 steps): the buffer with its per-step states,
    the stats, the reward scale and the sequence counter match
    ``rl8_tpu``'s non-fused scan."""
    jalgo, talgo, _ = _pair(model, **kw)
    assert (talgo._fused_act, talgo._fused_update) == fused
    K, H = talgo.policy.model.num_layers, talgo.policy.model.hidden_size
    for i in range(2):
        jstats = jalgo.collect(deterministic=True)
        tstats = talgo.collect(deterministic=True)
        jbuf, tbuf = jalgo.state.buffer, talgo.state.buffer
        assert set(tbuf) == set(jbuf)
        for key in (DataKeys.OBS, DataKeys.ACTIONS):
            np.testing.assert_array_equal(tbuf[key].numpy(), np.asarray(jbuf[key]), err_msg=key)
        for key in (DataKeys.LOGP, DataKeys.VALUES, DataKeys.REWARDS, DataKeys.REVERSED_DISCOUNTED_RETURNS):
            assert tbuf[key].dtype == torch.float32
            np.testing.assert_allclose(tbuf[key].numpy(), np.asarray(jbuf[key]), rtol=RTOL, atol=ATOL, err_msg=key)
        for key in (DataKeys.HIDDEN_STATES, DataKeys.CELL_STATES):
            got = tbuf[DataKeys.STATES][key]
            assert tuple(got.shape) == (HORIZON + 1, NUM_ENVS, K, H) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(jbuf[DataKeys.STATES][key]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(talgo.state.reward_scale), float(jalgo.state.reward_scale), rtol=RTOL)
        assert talgo.state.seqs == int(jalgo.state.seqs)
        for key in jstats:
            if key.startswith(("returns/", "rewards/")):
                np.testing.assert_allclose(tstats[key], jstats[key], rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize(
    "model,kw,fused",
    [
        (None, {"fused_update": False}, (True, False)),
        (None, {"fused_update": False, "fused_act": False}, (False, False)),
        (None, {"fused_update": False, "entropy_coeff": 0.01, "dual_clip_param": 3.0, "target_kl_div": 1e-8},
         (True, False)),
        (None, {"fused_update": False, "accumulate_grads": True,
                "sgd_minibatch_size": NUM_ENVS * HORIZON // SEQ_LEN // 4}, (True, False)),
        (NINE, {"entropy_coeff": 0.01}, (False, False)),
    ],
    ids=["autodiff", "both-off", "autodiff-entropy-dual-kl-stop", "autodiff-accumulate", "nine-layers"],
)
def test_autodiff_update_matches_jax(model, kw: dict, fused: tuple) -> None:
    """One ``step()`` through the autodiff update (truncated BPTT through
    the module over ``[seq_len]`` sequences from their stored initial
    states) in each package from the same parameters and buffer: the
    stats, the parameters afterwards and Adam's count."""
    jalgo, talgo, params0 = _pair(model, seed=3, **kw)
    assert (talgo._fused_act, talgo._fused_update) == fused
    jalgo.collect()
    jbuf = jax.device_get(jalgo.state.buffer)
    talgo.state.buffer = {
        k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()} if isinstance(v, dict) else torch.from_numpy(np.array(v))
        for k, v in jbuf.items()
    }
    talgo.state.reward_scale = torch.tensor(float(jalgo.state.reward_scale))
    talgo.state.horizons = int(jalgo.state.horizons)
    talgo.state.buffered = True
    jstats, tstats = jalgo.step(), talgo.step()
    for key in STAT_KEYS:
        assert math.isclose(tstats[key], jstats[key], rel_tol=STAT_RTOL, abs_tol=STAT_ATOL), (key, tstats[key], jstats[key])
    start = _flat(params0)
    jdelta = _flat(jax.device_get(jalgo.state.params)) - start
    tdelta = _flat(to_jax_params(talgo.policy.model)) - start
    assert np.linalg.norm(jdelta) > 0
    assert np.linalg.norm(tdelta - jdelta) <= DELTA_REL * np.linalg.norm(jdelta)
    assert int(talgo.state.opt_state.count) == int(jax.tree_util.tree_leaves(jalgo.state.opt_state.inner_state)[0])
    # The buffer is spent but keeps the final observation and states.
    for key, value in jbuf[DataKeys.STATES].items():
        np.testing.assert_array_equal(talgo.state.buffer[DataKeys.STATES][key][-1].numpy(), value[-1])


def test_bias_false_raises_like_jax() -> None:
    """``bias=False`` takes the default recurrent model off the kernels in
    both packages, where its forward raises ``rl8_tpu``'s error at
    build."""
    kw = _config({"hidden_size": 8, "bias": False})
    with pytest.raises(NotImplementedError) as jerr:
        JRecurrentAlgorithmConfig(**kw).build(jenv.DiscreteDummyEnv)
    with pytest.raises(NotImplementedError) as terr:
        RecurrentAlgorithmConfig(**kw, device="cpu").build(tenv.DiscreteDummyEnv)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("env_cls", [tenv.DiscreteDummyEnv, tenv.ContinuousDummyEnv])
def test_module_rollout_samples_from_its_seeded_generator(env_cls) -> None:
    """The module rollout draws from its own generator, seeded from the
    config's seed: equal seeds collect the same stochastic buffer, other
    seeds another; a train step runs on it."""
    def collect(seed: int):
        algo = RecurrentAlgorithmConfig(**_config(fused_act=False, seed=seed, device="cpu")).build(env_cls)
        algo.collect()
        return algo, algo.state.buffer[DataKeys.ACTIONS]

    algo, a = collect(0)
    assert torch.equal(a, collect(0)[1]) and not torch.equal(a, collect(1)[1])
    assert all(math.isfinite(v) for v in algo.step().values())


def test_learning_drive_on_the_module_route() -> None:
    """The recurrent learning drive of ``tests/test_torch_recurrent_step.py``
    through the module rollout and the autodiff update."""
    algo = RecurrentAlgorithmConfig(num_envs=64, horizon=8, seq_len=4, seqs_per_state_reset=2, seed=1,
                                    model_config={"hidden_size": 16}, fused_act=False, fused_update=False,
                                    device="cpu").build(tenv.DiscreteDummyEnv)
    for _ in range(25):
        algo.collect(env_config={"bounds": 10.0})
        algo.step()
    obs = torch.tensor([[[5.0]], [[-5.0]], [[2.0]], [[-2.0]]])
    out, _ = algo.policy.sample({DataKeys.OBS: obs}, algo.policy.init_states(4), deterministic=True)
    assert out[DataKeys.ACTIONS].ravel().tolist() == [0, 1, 0, 1]


# ----------------------------------------------------------------------
# The route table
# ----------------------------------------------------------------------


def _jax_flags(algo_cls, env_cls, config, monkeypatch):
    """``rl8_tpu``'s route flags as it sets them on a TPU: the algorithm is
    constructed with ``jax.local_devices()`` reporting a TPU (it only
    reads the platform to choose routes; nothing runs on one)."""
    with monkeypatch.context() as m:
        m.setattr(jax, "local_devices", lambda *a, **k: [types.SimpleNamespace(platform="tpu")])
        algo = algo_cls(env_cls, config)
    return algo._fused_act, algo._fused_update, algo._fused_forward


FF = dict(num_envs=4, horizon=8, model_config={"hiddens": (8, 8)})
RNN = dict(num_envs=4, horizon=8, seq_len=2, seqs_per_state_reset=2, model_config={"hidden_size": 8})
MULE = dict(num_envs=4, horizon=8, model_config={"hiddens": (8, 8)})

#: ``(name, recurrent, kind, config for rl8_tpu, config for the port)``.
GATES = [
    *[
        (f"{env}-{name}", False, env, dict(FF, **jkw), dict(FF, **tkw))
        for env in ("discrete", "continuous")
        for name, jkw, tkw in (
            ("default", {}, {}),
            ("enable-amp", {"enable_amp": True}, {"enable_amp": True}),
            ("bf16", {"model_config": {"hiddens": (8, 8), "dtype": jnp.bfloat16}},
             {"model_config": {"hiddens": (8, 8), "dtype": torch.bfloat16}}),
            ("act-off", {"fused_act": False}, {"fused_act": False}),
            ("update-off", {"fused_update": False}, {"fused_update": False}),
            ("gelu", {"model_config": {"hiddens": (8, 8), "activation_fn": "gelu"}},
             {"model_config": {"hiddens": (8, 8), "activation_fn": "gelu"}}),
            ("no-bias", {"model_config": {"hiddens": (8, 8), "bias": False}},
             {"model_config": {"hiddens": (8, 8), "bias": False}}),
            ("fused-forward", {"fused_forward": True}, {"fused_forward": True}),
            ("fused-forward-amp", {"fused_forward": True, "enable_amp": True},
             {"fused_forward": True, "enable_amp": True}),
        )
    ],
    ("continuous-squashed", False, "continuous", dict(FF, distribution_cls=JSquashedNormal),
     dict(FF, distribution_cls=SquashedNormal)),
    *[
        (f"recurrent-{env}-{name}", True, env, dict(RNN, **kw), dict(RNN, **kw))
        for env in ("discrete", "continuous")
        for name, kw in (
            ("default", {}),
            ("enable-amp", {"enable_amp": True}),
            ("act-off", {"fused_act": False}),
            ("update-off", {"fused_update": False}),
            ("nine-layers", {"model_config": {"hidden_size": 8, "num_layers": 9}}),
            ("fused-forward", {"fused_forward": True}),
        )
    ],
    *[
        (f"mule-{dt}-{ff}", False, "mule",
         dict(MULE, fused_forward=ff == "fused", model_config={"hiddens": (8, 8), "dtype": jdt}),
         dict(MULE, fused_forward=ff == "fused", model_config={"hiddens": (8, 8), "dtype": tdt}))
        for dt, jdt, tdt in (("f32", None, None), ("bf16", jnp.bfloat16, torch.bfloat16))
        for ff in ("fused", "module")
    ],
]


@pytest.mark.parametrize("name,recurrent,kind,jconfig,tconfig", GATES, ids=[g[0] for g in GATES])
def test_route_flags_match_jax(name, recurrent, kind, jconfig, tconfig, monkeypatch) -> None:
    """The port chooses each route at build as ``rl8_tpu`` does on its
    device, from the model, its dtype and the config's flags."""
    if kind == "mule":
        jenv_cls, tenv_cls = JAlgoTrading, AlgoTrading
        jconfig, tconfig = dict(jconfig, model_cls=JMischievousMule), dict(tconfig, model_cls=MischievousMule)
    else:
        jenv_cls, tenv_cls = {
            "discrete": (jenv.DiscreteDummyEnv, tenv.DiscreteDummyEnv),
            "continuous": (jenv.ContinuousDummyEnv, tenv.ContinuousDummyEnv),
        }[kind]
    if recurrent:
        want = _jax_flags(JRecurrentAlgorithm, jenv_cls, JRecurrentAlgorithmConfig(**jconfig), monkeypatch)
        talgo = RecurrentAlgorithmConfig(**tconfig, device="cpu").build(tenv_cls)
    else:
        want = _jax_flags(JAlgorithm, jenv_cls, JAlgorithmConfig(**jconfig), monkeypatch)
        talgo = AlgorithmConfig(**tconfig, device="cpu").build(tenv_cls)
    assert (talgo._fused_act, talgo._fused_update, talgo._fused_forward) == want


def test_nine_layer_feedforward_is_the_known_capacity_difference(monkeypatch) -> None:
    """The route the table once left out, now in agreement: ``rl8_tpu``'s
    kernels take a default feedforward model of 9 or 16 narrow layers (its
    gate is their VMEM residency), and so do the port's act and update
    kernels, which take any depth; at 512 wide the first depth its gate
    refuses (23 layers) takes the module rollout and the autodiff update in
    both packages."""
    for hiddens, want in (((8,) * 9, (True, True)), ((8,) * 16, (True, True)), ((512,) * 23, (False, False))):
        cfg = dict(FF, model_config={"hiddens": hiddens})
        assert _jax_flags(JAlgorithm, jenv.DiscreteDummyEnv, JAlgorithmConfig(**cfg), monkeypatch)[:2] == want
        talgo = AlgorithmConfig(**cfg, device="cpu").build(tenv.DiscreteDummyEnv)
        assert (talgo._fused_act, talgo._fused_update) == want
