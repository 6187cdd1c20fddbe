"""Wide LSTMs: the port's recurrent plain versions and step at the widths
past the card kernels' shared-memory tiles (``H`` 721 to 1617, which
``rl8_tpu``'s residency gate admits at the dummy envs' shapes) against
``rl8_tpu`` on the CPU, and the recurrent algorithm's build-time capacity
check and the act wrapper's refusal. The helpers here are shared with
the two files split off it to spread its run time over the test workers.

- ``rnn_ppo_grads_plain`` (what ``csrc/rnn_ppo.cu``'s wide route is held
  against on the card) against ``jax.grad`` of ``rl8_tpu``'s recurrent
  loss at H = 1024, one layer (two layers in
  ``tests/test_torch_rnn_wide_update.py``), Categorical with an entropy
  bonus, Normal, and SquashedNormal without one.
- ``rnn_act_plain`` (what ``csrc/rnn_act.cu``'s staged route is held
  against), deterministic, against ``rl8_tpu``'s module forward at two
  1024-wide layers (the staged route's per-layer launches, layer 2
  reading layer 1's h'; one layer at H = 1210 and 1617 in
  ``tests/test_torch_rnn_wide_act.py``).
- One whole-buffer ``step()`` of a 1024-wide LSTM in each package from
  the same parameters and buffer, and the route flags of a 1300-wide LSTM
  against ``rl8_tpu``'s.
- ``_check_card_takes_kernels`` with the device patched to ``cuda`` and
  the kernels' queries patched, and ``fused_rnn_act`` on tensors that
  report ``cuda``: with the query saying -1 it raises before any launch;
  with a positive answer it allocates that scratch and passes it to the
  launch.

Tolerances, f32 on both sides with other summation orders over 1024- to
1617-term sums: gradients by norm-relative error 1e-5, losses rtol 1e-5
atol 1e-6 (as ``tests/test_torch_rnn_update.py``); values, log-probs and
new states rtol = atol = 1e-5 (as ``tests/test_torch_rnn_act.py``); the
step by ``tests/test_torch_recurrent_step.py``'s rule.
"""

from __future__ import annotations

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl8_tpu.env as jenv
import rl8_tpu_torch.env as tenv
from rl8_tpu import RecurrentAlgorithmConfig as JRecurrentAlgorithmConfig
from rl8_tpu.algorithms._recurrent import RecurrentAlgorithm as JRecurrentAlgorithm
from rl8_tpu.distributions import Categorical as JCategorical
from rl8_tpu.distributions import Normal as JNormal
from rl8_tpu.distributions import SquashedNormal as JSquashedNormal
from rl8_tpu.models import DefaultContinuousRecurrentModel as JContinuous
from rl8_tpu.models import DefaultDiscreteRecurrentModel as JDiscreteModel
from rl8_tpu.nn import ppo_losses as jax_ppo_losses
from rl8_tpu.specs import Discrete as JDiscrete
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu_torch import RecurrentAlgorithmConfig
from rl8_tpu_torch.algorithms import _recurrent
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.distributions import Categorical
from rl8_tpu_torch.models import (
    DefaultContinuousRecurrentModel,
    DefaultDiscreteRecurrentModel,
    load_jax_params,
    to_jax_params,
)
from rl8_tpu_torch.ops import (
    PPOLossConfig,
    fused_rnn_act,
    load_rnn_params,
    pack_rnn_params,
    pack_rows,
    rnn_act_plain,
    rnn_ppo_grads_plain,
    supports_fused_rnn_update,
)
from rl8_tpu_torch.specs import Discrete, Unbounded
from tests.test_torch_recurrent_route import _jax_flags
from tests.test_torch_recurrent_step import DELTA_REL, STAT_ATOL, STAT_KEYS, STAT_RTOL, _flat
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_GRAD_REL, F32_LOSS_RTOL, F32_LOSS_ATOL = 1e-5, 1e-5, 1e-6
ACT_RTOL = ACT_ATOL = 1e-5
#: The module (``rl8_tpu_torch.ops`` binds its name to the function).
fused_rnn_act_module = importlib.import_module("rl8_tpu_torch.ops.fused_rnn_act")
#: Sequences, steps, observation dim and accumulation of the update cases.
N, L, D, ACCUM = 6, 4, 3, 2
JDISTS = {"categorical": JCategorical, "normal": JNormal, "squashed": JSquashedNormal}


def _norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _models(kind: str, H: int, layers: int):
    config = {"hidden_size": H, "num_layers": layers}
    if kind == "categorical":
        return (JDiscreteModel(JUnbounded(D), JDiscrete(3, shape=(2,)), **config),
                DefaultDiscreteRecurrentModel(Unbounded(D), Discrete(3, shape=(2,)), **config))
    return (JContinuous(JUnbounded(D), JUnbounded(2), **config),
            DefaultContinuousRecurrentModel(Unbounded(D), Unbounded(2), **config))


def _params(jmodel, model, obs, states, rng, scale: float = 0.02):
    """flax's initial parameters, perturbed by ``scale`` normal noise (at
    these widths a larger perturbation saturates every gate), loaded into
    the port's model too."""
    params = jax.device_get(
        jmodel.init(jax.random.key(0), {DataKeys.OBS: jnp.asarray(obs)}, jax.tree_util.tree_map(jnp.asarray, states))["params"]
    )
    params = jax.tree_util.tree_map(lambda p: p + scale * rng.normal(size=p.shape).astype(np.float32), params)
    load_jax_params(model, params)
    return jax.tree_util.tree_map(jnp.asarray, params)


def _states(rng, B: int, layers: int, H: int) -> dict:
    return {
        DataKeys.CELL_STATES: rng.normal(size=(B, layers, H)).astype(np.float32),
        DataKeys.HIDDEN_STATES: (0.5 * rng.normal(size=(B, layers, H))).astype(np.float32),
    }


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}


#: The update cases' distributions and entropy coefficients.
UPDATE_KINDS = [("categorical", 0.013), ("normal", 0.0), ("squashed", 0.0)]


@pytest.mark.parametrize("layers", [1])
@pytest.mark.parametrize("kind,ec", UPDATE_KINDS)
def test_plain_update_matches_jax_autodiff_at_1024(kind: str, ec: float, layers: int) -> None:
    """``rnn_ppo_grads_plain`` against ``jax.grad`` at one 1024-wide layer
    (``check_update_against_jax``; two layers in
    ``tests/test_torch_rnn_wide_update.py``)."""
    check_update_against_jax(kind, ec, layers)


def check_update_against_jax(kind: str, ec: float, layers: int) -> None:
    """``rnn_ppo_grads_plain`` against ``jax.grad`` of ``ppo_losses(...)
    ["total"] / accum`` through ``rl8_tpu``'s 1024-wide recurrent model over
    N sequences of L steps: losses, KL and every gradient."""
    H = 1024
    rng = np.random.default_rng(layers)
    jmodel, model = _models(kind, H, layers)
    obs = rng.normal(size=(N, L, D)).astype(np.float32)
    states = _states(rng, N, layers, H)
    params = _params(jmodel, model, obs, states, rng)
    if kind == "categorical":
        actions = rng.integers(0, 3, size=(N, L, 2)).astype(np.int32)
    elif kind == "normal":
        actions = rng.normal(size=(N, L, 2)).astype(np.float32)
    else:
        actions = rng.uniform(-0.9, 0.9, size=(N, L, 2)).astype(np.float32)
    batch = {
        DataKeys.ACTIONS: actions,
        DataKeys.ADVANTAGES: rng.normal(size=(N, L, 1)).astype(np.float32),
        DataKeys.LOGP: (0.1 * rng.normal(size=(N, L, 1)) - 1.5).astype(np.float32),
        DataKeys.OBS: obs,
        DataKeys.RETURNS: rng.normal(size=(N, L, 1)).astype(np.float32),
        DataKeys.STATES: states,
    }
    loss_kw = dict(clip_param=0.2, dual_clip_param=3.0, vf_clip_param=1.5, vf_coeff=0.9)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        (f, v), _ = jmodel.apply({"params": p}, {DataKeys.OBS: jbatch[DataKeys.OBS]}, jbatch[DataKeys.STATES])
        dist = JDISTS[kind](f, jmodel)
        flat = {
            k: jbatch[k].reshape(-1, *jbatch[k].shape[2:])
            for k in (DataKeys.ACTIONS, DataKeys.LOGP, DataKeys.ADVANTAGES, DataKeys.RETURNS)
        }
        losses = jax_ppo_losses(flat, v, dist, entropy_coeff=ec, **loss_kw)
        lr = dist.logp(flat[DataKeys.ACTIONS]) - flat[DataKeys.LOGP]
        return losses["total"] / ACCUM, (losses, jnp.mean((jnp.exp(lr) - 1) - lr))

    (_, (ref_losses, ref_kl)), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    cfg = PPOLossConfig(n_rows=N, accum=ACCUM, use_entropy=ec != 0.0, squashed=kind == "squashed", **loss_kw)
    packed, unpack = pack_rows(_torch_tree(batch))
    losses, kl, flat = rnn_ppo_grads_plain(
        pack_rnn_params(model, squashed=kind == "squashed"), packed, unpack, torch.tensor(ec), cfg
    )
    for k in ("entropy", "policy", "vf", "total"):
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL, err_msg=k)
    np.testing.assert_allclose(float(kl), float(ref_kl), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL)
    grad_model = _models(kind, H, layers)[1]
    load_rnn_params(grad_model, flat)
    grads = to_jax_params(grad_model)
    for path, ref in jax.tree_util.tree_leaves_with_path(ref_grads):
        got = grads
        for key in path:
            got = got[key.key]
        assert _norm_rel(got, ref) < F32_GRAD_REL, (jax.tree_util.keystr(path), _norm_rel(got, ref))


def check_act_plain_against_jax(H: int, layers: int, kind: str) -> None:
    """``rnn_act_plain``, deterministic, against ``rl8_tpu``'s module forward
    at ``layers`` H-wide LSTM layers: the values, the log-prob of the
    greedy action (the argmax, or the mean, squashed when the kind is)
    under ``rl8_tpu``'s distribution, and the new states."""
    B = 16
    rng = np.random.default_rng(H + layers - 1)
    jmodel, model = _models(kind, H, layers)
    obs = rng.normal(size=(B, D)).astype(np.float32)
    states = _states(rng, B, layers, H)
    params = _params(jmodel, model, obs[:, None], states, rng)
    (features, values), new_states = jmodel.apply(
        {"params": params}, {DataKeys.OBS: jnp.asarray(obs[:, None])}, jax.tree_util.tree_map(jnp.asarray, states)
    )
    packed = pack_rnn_params(model, squashed=kind == "squashed")
    actions, logp, tvalues, tstates = rnn_act_plain(packed, torch.from_numpy(obs), _torch_tree(states), (1, 2),
                                                    deterministic=True)
    jdist = JDISTS[kind](features, jmodel)
    if kind == "categorical":
        greedy = np.asarray(jdist.deterministic_sample()).reshape(B, -1)
        np.testing.assert_array_equal(actions.numpy(), greedy)
    else:
        greedy = np.asarray(jdist.deterministic_sample()).reshape(B, -1)
        np.testing.assert_allclose(actions.numpy(), greedy, rtol=ACT_RTOL, atol=ACT_ATOL)
    ref_logp = np.asarray(jdist.logp(jnp.asarray(actions.numpy()))).reshape(B, 1)
    np.testing.assert_allclose(logp.numpy(), ref_logp, rtol=ACT_RTOL, atol=ACT_ATOL)
    np.testing.assert_allclose(tvalues.numpy(), np.asarray(values).reshape(B, 1), rtol=ACT_RTOL, atol=ACT_ATOL)
    for key in (DataKeys.HIDDEN_STATES, DataKeys.CELL_STATES):
        np.testing.assert_allclose(tstates[key].numpy(), np.asarray(new_states[key]), rtol=ACT_RTOL, atol=ACT_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("kind", ["categorical", "normal", "squashed"])
def test_act_plain_matches_jax_forward_two_layers_1024(kind: str) -> None:
    """``rnn_act_plain`` against ``rl8_tpu``'s module forward at two
    1024-wide LSTM layers, the shape the staged route runs as one gate
    launch a layer on the card (``check_act_plain_against_jax``)."""
    check_act_plain_against_jax(1024, 2, kind)


def test_step_matches_jax_at_1024() -> None:
    """One whole-buffer ``step()`` of a 1024-wide LSTM in each package, from
    the same parameters and buffer (``rl8_tpu``'s, handed to the port): the
    kernel routes in both (their plain versions here, XLA autodiff on
    ``rl8_tpu``'s CPU). The stats, and the parameters' change by a
    norm-relative error."""
    config = dict(num_envs=8, horizon=8, seq_len=4, seqs_per_state_reset=2, model_config={"hidden_size": 1024},
                  seed=3, entropy_coeff=0.01)
    jalgo = JRecurrentAlgorithmConfig(**config).build(jenv.DiscreteDummyEnv)
    params0 = jax.device_get(jalgo.state.params)
    talgo = RecurrentAlgorithmConfig(**config, device="cpu").build(tenv.DiscreteDummyEnv)
    assert (talgo._fused_act, talgo._fused_update) == (True, True)
    load_jax_params(talgo.policy.model, params0)
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


#: ``(name, config flags, whether the act kernel takes the model, whether
#: the update kernel does, the kernel named by the error or None, the
#: queries asked)``.
BUILD_CHECKS = [
    ("update-off-act-refuses", {"fused_update": False}, False, True, "act", ["act"]),
    ("update-off-act-takes", {"fused_update": False}, True, True, None, ["act"]),
    ("both-off", {"fused_update": False, "fused_act": False}, False, False, None, []),
    ("update-refuses", {}, True, False, "update", ["update"]),
    ("act-refuses", {}, False, True, "act", ["update", "act"]),
    ("act-off-update-takes", {"fused_act": False}, False, True, None, ["update"]),
    ("both-take", {}, True, True, None, ["update", "act"]),
]


@pytest.mark.parametrize("name,flags,act_takes,update_takes,raises,asked", BUILD_CHECKS, ids=[c[0] for c in BUILD_CHECKS])
def test_build_asks_the_card_kernels(name: str, flags: dict, act_takes: bool, update_takes: bool, raises, asked: list,
                                     monkeypatch) -> None:
    """On a CUDA device the recurrent algorithm asks each card kernel that
    its routes launch whether it takes the model, at build, and raises
    ``NotImplementedError`` naming the kernel that refuses: the act kernel
    whenever ``_fused_act`` is on (with ``fused_update=False`` too), the
    update kernel whenever ``_fused_update`` is on; with both off it asks
    nothing. (Built on the CPU, then checked with the device patched.)"""
    algo = RecurrentAlgorithmConfig(num_envs=4, horizon=4, seq_len=2, seqs_per_state_reset=2,
                                    model_config={"hidden_size": 8}, device="cpu", **flags).build(tenv.DiscreteDummyEnv)
    calls = []
    monkeypatch.setattr(_recurrent, "card_takes_rnn_act", lambda params: calls.append("act") or act_takes)
    monkeypatch.setattr(_recurrent, "card_takes_rnn_update", lambda params: calls.append("update") or update_takes)
    algo._check_card_takes_kernels(algo.policy.model)
    assert calls == []  # the CPU asks nothing
    monkeypatch.setattr(algo, "device", torch.device("cuda"))
    if raises is None:
        algo._check_card_takes_kernels(algo.policy.model)
    else:
        with pytest.raises(NotImplementedError, match=f"recurrent {raises} kernel"):
            algo._check_card_takes_kernels(algo.policy.model)
    assert calls == asked


@pytest.mark.parametrize("extra,want", [({}, (True, True)), ({"fused_update": False}, (True, False))],
                         ids=["default", "update-off"])
def test_wide_lstm_routes_match_jax(extra: dict, want: tuple, monkeypatch) -> None:
    """A 1300-wide LSTM (past both card kernels' shared-memory tiles) takes
    the act and update kernel routes, the act kernel alone with
    ``fused_update=False``: the route flags equal ``rl8_tpu``'s as it sets
    them on a TPU (``tests/test_torch_wide.py`` holds 1617 and 1618)."""
    H = 1300
    kw = dict(num_envs=4, horizon=4, seq_len=2, seqs_per_state_reset=2, model_config={"hidden_size": H}, **extra)
    with torch.device("meta"):
        model = DefaultDiscreteRecurrentModel(Unbounded(1), Discrete(2, shape=(1,)), hidden_size=H)
    assert supports_fused_rnn_update(model, Categorical)
    jflags = _jax_flags(JRecurrentAlgorithm, jenv.DiscreteDummyEnv, JRecurrentAlgorithmConfig(**kw), monkeypatch)
    algo = RecurrentAlgorithmConfig(device="cpu", **kw).build(tenv.DiscreteDummyEnv)
    got = (algo._fused_act, algo._fused_update, algo._fused_forward)
    assert got == jflags
    assert got[:2] == want


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    card path up to the point where it would allocate or launch."""

    @property
    def device(self) -> torch.device:
        return torch.device("cuda", 0)


def _reports_cuda(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_ReportsCuda, t)


def test_act_wrapper_refuses_before_any_launch(monkeypatch) -> None:
    """``fused_rnn_act`` raises ``NotImplementedError`` where the kernel's
    capacity query says -1, before it allocates or launches anything."""
    B, H = 4, 8
    model = DefaultDiscreteRecurrentModel(Unbounded(1), Discrete(2, shape=(1,)), hidden_size=H)
    params = pack_rnn_params(model)
    params = type(params)(**{**params.__dict__, "flat": _reports_cuda(params.flat)})
    obs = _reports_cuda(torch.zeros((B, 1)))
    states = {k: _reports_cuda(torch.zeros((B, 1, H))) for k in (DataKeys.HIDDEN_STATES, DataKeys.CELL_STATES)}
    asked = []

    class Library:
        def rl8_rnn_act(self, *args):
            raise AssertionError("the kernel was launched")

    monkeypatch.setattr(fused_rnn_act_module, "_scratch_floats", lambda p, rows: asked.append(rows) or -1)
    monkeypatch.setattr(fused_rnn_act_module, "load", Library)
    launches = fused_rnn_act.launches
    with pytest.raises(NotImplementedError, match="card_takes_rnn_act"):
        fused_rnn_act(params, obs, states, (1, 2))
    assert asked == [B] and fused_rnn_act.launches == launches
