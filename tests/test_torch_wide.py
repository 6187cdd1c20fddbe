"""Wide models: ``rl8_tpu``'s residency gates as the port's routes, and the
port's plain update, act and step at a 1024-wide twin torso against
``rl8_tpu`` on the CPU.

- The gates: the port's ``model_fits_vmem`` (default models over widths,
  depths, action spaces; the custom models' LayerNorm chains) and the
  residency term of ``supports_fused_rnn_update`` equal ``rl8_tpu``'s,
  at the exact width where each flips. Models are built without values
  (the port's on the ``meta`` device, ``rl8_tpu``'s through
  ``jax.eval_shape``): the gates read shapes only.
- The route flags at twin torsos of 1024, 2388 and 2389 and LSTMs of
  1617 and 1618, against ``rl8_tpu``'s as it sets them on a TPU.
- ``ppo_grads_plain`` against ``jax.grad`` and ``act_plain`` against the
  flax forward at 1024 wide on 64 rows, and one ``step()`` of a 1024-wide
  model against ``rl8_tpu``'s from the same parameters and buffer.
- ``fused_act`` on tensors that report ``cuda`` with the kernel's capacity
  query saying -1 (it raises before any launch), and ``card_takes_act``
  reading that query at one row.

Tolerances, f32 on both sides with other summation orders over 1024-term
sums: gradients by norm-relative error 1e-5, losses rtol 1e-5 atol 1e-6
(as ``tests/test_torch_update.py``); log-probs and values rtol = atol =
1e-5; the step by ``tests/test_torch_step.py``'s rule.
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
from examples.algotrading.env import AlgoTrading as JAlgoTrading
from examples.algotrading.models import AttentiveAlpaca as JAttentiveAlpaca
from examples.algotrading.models import LazyLemur as JLazyLemur
from examples.algotrading.models import MischievousMule as JMischievousMule
from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
from rl8_tpu import RecurrentAlgorithmConfig as JRecurrentAlgorithmConfig
from rl8_tpu.algorithms._feedforward import Algorithm as JAlgorithm
from rl8_tpu.algorithms._recurrent import RecurrentAlgorithm as JRecurrentAlgorithm
from rl8_tpu.distributions import Categorical as JCategorical
from rl8_tpu.distributions import Normal as JNormal
from rl8_tpu.distributions import SquashedNormal as JSquashedNormal
from rl8_tpu.models import DefaultContinuousModel as JContinuousModel
from rl8_tpu.models import DefaultContinuousRecurrentModel as JContinuousRecurrentModel
from rl8_tpu.models import DefaultDiscreteModel as JDiscreteModel
from rl8_tpu.models import DefaultDiscreteRecurrentModel as JDiscreteRecurrentModel
from rl8_tpu.nn import ppo_losses as jax_ppo_losses
from rl8_tpu.ops.fused_mlp import model_fits_vmem as jax_model_fits_vmem
from rl8_tpu.ops.fused_rnn_ppo import supports_fused_rnn_update as jax_supports_fused_rnn_update
from rl8_tpu.policies import Policy as JPolicy
from rl8_tpu.policies import RecurrentPolicy as JRecurrentPolicy
from rl8_tpu.specs import Discrete as JDiscrete
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.distributions import Categorical, Normal, SquashedNormal
from rl8_tpu_torch.examples.algotrading import AlgoTrading, AttentiveAlpaca, LazyLemur, MischievousMule
from rl8_tpu_torch.models import (
    DefaultContinuousModel,
    DefaultContinuousRecurrentModel,
    DefaultDiscreteModel,
    DefaultDiscreteRecurrentModel,
    load_jax_params,
    to_jax_params,
)
from rl8_tpu_torch.ops import (
    PPOLossConfig,
    act_plain,
    card_takes_act,
    fused_act,
    chains_fit_vmem,
    model_fits_vmem,
    pack_act_params,
    pack_rows,
    ppo_grads_plain,
    supports_fused_rnn_update,
)
from rl8_tpu_torch.ops.fused_mlp import chain_names, load_flat_params, named_chains
from rl8_tpu_torch.policies import Policy, RecurrentPolicy
from rl8_tpu_torch.specs import Discrete, Unbounded
from tests.test_torch_recurrent_route import _jax_flags
from tests.test_torch_step import DELTA_REL, STAT_KEYS, STAT_RTOL, STAT_ATOL, _copy_rollout, _flat, _jax_params
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_GRAD_REL, F32_LOSS_RTOL, F32_LOSS_ATOL = 1e-5, 1e-5, 1e-6
ACT_RTOL = ACT_ATOL = 1e-5
WIDTHS = (64, 256, 736, 737, 1024, 1813, 1814, 2048, 2388, 2389, 4096)

# ----------------------------------------------------------------------
# The gates
# ----------------------------------------------------------------------

#: ``(name, observation dim, action spec (discrete A, n) or box dim)``.
SPECS = [
    ("discrete-dummy", 1, (1, 2)),
    ("discrete-A2-n3", 4, (2, 3)),
    ("discrete-n64", 3, (1, 64)),
    ("continuous-dummy", 1, 1),
    ("continuous-box6", 3, 6),
]


def _default_models(obs_dim: int, action, hiddens: tuple):
    """The default model of both packages without values: ``rl8_tpu``'s
    and its parameters' shapes, the port's on the ``meta`` device."""
    if isinstance(action, tuple):
        A, n = action
        jcls, tcls, jact, tact = JDiscreteModel, DefaultDiscreteModel, JDiscrete(n, shape=(A,)), Discrete(n, shape=(A,))
    else:
        jcls, tcls, jact, tact = JContinuousModel, DefaultContinuousModel, JUnbounded(action), Unbounded(action)
    jmodel = jcls(JUnbounded(obs_dim), jact, hiddens=hiddens)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), {"obs": jnp.zeros((1, obs_dim))})["params"]
    with torch.device("meta"):
        tmodel = tcls(Unbounded(obs_dim), tact, hiddens=hiddens)
    return jmodel, shapes, tmodel


def _flip(fits, lo: int = 1, hi: int = 1 << 20) -> int:
    """The widest width at which ``fits(width)`` holds (it holds at ``lo``
    and fails at ``hi``, and is monotone between)."""
    assert fits(lo) and not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


@pytest.mark.parametrize("layers", [1, 2, 3, 8])
@pytest.mark.parametrize("name,obs_dim,action", SPECS, ids=[s[0] for s in SPECS])
def test_default_model_gate_matches_jax(name: str, obs_dim: int, action, layers: int) -> None:
    """``model_fits_vmem`` of the default models equals ``rl8_tpu``'s over
    the widths, and at ``rl8_tpu``'s last admitted width and the next."""

    def jax_fits(width: int) -> bool:
        jmodel, shapes, _ = _default_models(obs_dim, action, (width,) * layers)
        return jax_model_fits_vmem(jmodel, shapes)

    flip = _flip(jax_fits)
    if (name, layers) == ("discrete-dummy", 2):
        assert flip == 2388  # the twin torso of the dummy envs
    for width in sorted({*WIDTHS, flip, flip + 1}):
        jmodel, shapes, tmodel = _default_models(obs_dim, action, (width,) * layers)
        want = jax_model_fits_vmem(jmodel, shapes)
        assert model_fits_vmem(tmodel) == want, width
        assert chains_fit_vmem(named_chains(tmodel, chain_names(tmodel))) == want


def test_uneven_torsos_match_jax() -> None:
    """Torsos whose layers differ in width."""
    for hiddens in ((2388, 64), (64, 2388), (3000, 16, 16), (1024, 2048, 512), (737, 1813, 2388, 64)):
        for action in ((1, 2), 2):
            jmodel, shapes, tmodel = _default_models(1, action, hiddens)
            assert model_fits_vmem(tmodel) == jax_model_fits_vmem(jmodel, shapes), (hiddens, action)


#: ``(name, rl8_tpu's model, the port's, recurrent, extra config)``.
CUSTOM = [
    ("mule", JMischievousMule, MischievousMule, False, {}),
    ("alpaca", JAttentiveAlpaca, AttentiveAlpaca, False, {}),
    ("lemur", JLazyLemur, LazyLemur, True, {"hidden_size": 64}),
]


def _custom_models(jcls, tcls, recurrent: bool, width: int, extra: dict):
    jenv_, tenv_ = JAlgoTrading(1), AlgoTrading(1, device="cpu")
    config = {"hiddens": (width, width), **extra}
    jpolicy = (JRecurrentPolicy if recurrent else JPolicy)(
        jenv_.observation_spec, jenv_.action_spec, model_cls=jcls, model_config=config
    )
    shapes = jax.eval_shape(jpolicy.init_params, jax.random.key(0))
    with torch.device("meta"):
        tpolicy = (RecurrentPolicy if recurrent else Policy)(
            tenv_.observation_spec, tenv_.action_spec, model_cls=tcls, model_config=config
        )
    return jpolicy.model, shapes, tpolicy.model


@pytest.mark.parametrize("name,jcls,tcls,recurrent,extra", CUSTOM, ids=[c[0] for c in CUSTOM])
def test_custom_model_gate_matches_jax(name: str, jcls, tcls, recurrent: bool, extra: dict) -> None:
    """``model_fits_vmem`` of the custom models' LayerNorm chains equals
    ``rl8_tpu``'s, at the widths and where it flips."""

    def jax_fits(width: int) -> bool:
        jmodel, shapes, _ = _custom_models(jcls, tcls, recurrent, width, extra)
        return jax_model_fits_vmem(jmodel, shapes)

    flip = _flip(jax_fits)
    for width in sorted({64, 768, 1024, 2048, flip, flip + 1, 4096}):
        jmodel, shapes, tmodel = _custom_models(jcls, tcls, recurrent, width, extra)
        assert model_fits_vmem(tmodel) == jax_model_fits_vmem(jmodel, shapes), width


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("kind", ["discrete", "discrete-A2-n5", "normal", "squashed"])
def test_recurrent_gate_matches_jax(kind: str, layers: int) -> None:
    """``supports_fused_rnn_update`` with its residency term equals
    ``rl8_tpu``'s (hidden_size 1617 admitted and 1618 not at the dummy
    envs' shapes with one layer)."""
    obs_dim = 1 if kind in ("discrete", "normal", "squashed") else 3
    if kind.startswith("discrete"):
        A, n = (1, 2) if kind == "discrete" else (2, 5)
        specs = (JUnbounded(obs_dim), JDiscrete(n, shape=(A,))), (Unbounded(obs_dim), Discrete(n, shape=(A,)))
        classes, dists = (JDiscreteRecurrentModel, DefaultDiscreteRecurrentModel), (JCategorical, Categorical)
    else:
        specs = (JUnbounded(obs_dim), JUnbounded(1)), (Unbounded(obs_dim), Unbounded(1))
        classes = (JContinuousRecurrentModel, DefaultContinuousRecurrentModel)
        dists = (JSquashedNormal, SquashedNormal) if kind == "squashed" else (JNormal, Normal)

    def gates(H: int) -> tuple[bool, bool]:
        jmodel = classes[0](*specs[0], hidden_size=H, num_layers=layers)
        with torch.device("meta"):
            tmodel = classes[1](*specs[1], hidden_size=H, num_layers=layers)
        return (
            jax_supports_fused_rnn_update(jmodel, dists[0], zero_entropy=True),
            supports_fused_rnn_update(tmodel, dists[1], zero_entropy=True),
        )

    flip = _flip(lambda H: gates(H)[0])
    if (kind, layers) == ("discrete", 1):
        assert flip == 1617
    for H in sorted({16, 256, 720, 1024, 1617, 1618, flip, flip + 1, 2048}):
        want, got = gates(H)
        assert got == want, H


# ----------------------------------------------------------------------
# The route flags
# ----------------------------------------------------------------------

FF = dict(num_envs=4, horizon=8)
ROUTES = [
    *[
        (f"{env}-{width}{suffix}", False, env, dict(FF, model_config={"hiddens": (width, width)}, **kw))
        for env in ("discrete", "continuous")
        for width in (1024, 2388, 2389)
        for suffix, kw in (("", {}), ("-fused-forward", {"fused_forward": True}))
    ],
    *[
        (f"squashed-{width}", False, "squashed", dict(FF, model_config={"hiddens": (width, width)}))
        for width in (2388, 2389)
    ],
    *[
        (f"recurrent-{env}-{H}", True, env, dict(FF, seq_len=2, seqs_per_state_reset=2, model_config={"hidden_size": H}))
        for env in ("discrete",)
        for H in (1617, 1618)
    ],
]


@pytest.mark.parametrize("name,recurrent,kind,config", ROUTES, ids=[r[0] for r in ROUTES])
def test_wide_route_flags_match_jax(name: str, recurrent: bool, kind: str, config: dict, monkeypatch) -> None:
    """The port's ``_fused_act``, ``_fused_update`` and ``_fused_forward``
    for wide models equal ``rl8_tpu``'s on its TPU: the kernels up to the
    residency gate, the module routes past it."""
    jenv_cls, tenv_cls = {
        "discrete": (jenv.DiscreteDummyEnv, tenv.DiscreteDummyEnv),
        "continuous": (jenv.ContinuousDummyEnv, tenv.ContinuousDummyEnv),
        "squashed": (jenv.ContinuousDummyEnv, tenv.ContinuousDummyEnv),
    }[kind]
    jconfig, tconfig = dict(config), dict(config, device="cpu")
    if kind == "squashed":
        jconfig["distribution_cls"], tconfig["distribution_cls"] = JSquashedNormal, SquashedNormal
    if recurrent:
        want = _jax_flags(JRecurrentAlgorithm, jenv_cls, JRecurrentAlgorithmConfig(**jconfig), monkeypatch)
        talgo = RecurrentAlgorithmConfig(**tconfig).build(tenv_cls)
    else:
        want = _jax_flags(JAlgorithm, jenv_cls, JAlgorithmConfig(**jconfig), monkeypatch)
        talgo = AlgorithmConfig(**tconfig).build(tenv_cls)
    got = (talgo._fused_act, talgo._fused_update, talgo._fused_forward)
    assert got == want
    admitted = "2389" not in name and "1618" not in name
    assert got[:2] == (admitted, admitted)


# ----------------------------------------------------------------------
# The plain versions and a step at 1024 wide
# ----------------------------------------------------------------------

N, ACCUM, WIDE = 64, 2, (1024, 1024)


def _norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _setup(kind: str, seed: int = 0):
    """A 1024-wide default model of the dummy envs' shapes in both
    packages (flax-initialized, perturbed), and one minibatch of numpy
    inputs: actions drawn from the model's own distribution (squashed ones
    from a pre-squash clipped to |x| <= 2), old log-probs near the model's
    own."""
    rng = np.random.default_rng(seed)
    if kind == "categorical":
        jmodel = JDiscreteModel(JUnbounded(1), JDiscrete(2, shape=(1,)), hiddens=WIDE)
        model = DefaultDiscreteModel(Unbounded(1), Discrete(2, shape=(1,)), hiddens=WIDE)
    else:
        jmodel = JContinuousModel(JUnbounded(1), JUnbounded(1), hiddens=WIDE)
        model = DefaultContinuousModel(Unbounded(1), Unbounded(1), hiddens=WIDE)
    params = jmodel.init(jax.random.key(seed), {"obs": jnp.zeros((1, 1))})["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(np.asarray(p) + 0.02 * rng.normal(size=p.shape).astype(np.float32)) for p in leaves]
    )
    load_jax_params(model, jax.device_get(params))
    obs = rng.normal(scale=2.0, size=(N, 1)).astype(np.float32)
    feats, _ = jmodel.apply({"params": params}, {"obs": jnp.asarray(obs)})
    if kind == "categorical":
        jdist = JCategorical(feats, jmodel)
        actions = np.asarray(jdist.sample(jax.random.key(seed + 1))).astype(np.int32)
    else:
        x = np.asarray(feats["mean"]) + np.exp(np.asarray(feats["log_std"])) * rng.normal(size=(N, 1))
        jdist = (JSquashedNormal if kind == "squashed" else JNormal)(feats, jmodel)
        actions = (np.tanh(np.clip(x, -2.0, 2.0)) if kind == "squashed" else x).astype(np.float32)
    logp = np.asarray(jdist.logp(jnp.asarray(actions)))
    batch = {
        DataKeys.ACTIONS: actions,
        DataKeys.LOGP: (logp + 0.3 * rng.normal(size=(N, 1))).astype(np.float32),
        DataKeys.ADVANTAGES: rng.normal(size=(N, 1)).astype(np.float32),
        DataKeys.RETURNS: rng.normal(size=(N, 1)).astype(np.float32),
        DataKeys.VIEWS: {DataKeys.OBS: obs},
    }
    return jmodel, params, model, batch


def _torch_tree(batch):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("kind,ec", [("categorical", 0.013), ("normal", 0.013), ("squashed", 0.0)])
def test_plain_update_matches_jax_autodiff_at_1024(kind: str, ec: float) -> None:
    """``ppo_grads_plain`` (what ``csrc/ppo.cu``'s wide route is held
    against on the card) against ``jax.grad`` of ``ppo_losses(...)["total"]
    / accum`` through ``rl8_tpu``'s 1024-wide model: losses, KL and every
    gradient."""
    jmodel, params, model, batch = _setup(kind)
    jdist_cls = {"categorical": JCategorical, "normal": JNormal, "squashed": JSquashedNormal}[kind]
    loss_kw = dict(clip_param=0.2, dual_clip_param=3.0, vf_clip_param=1.5, vf_coeff=0.9)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        f, v = jmodel.apply({"params": p}, jbatch[DataKeys.VIEWS])
        dist = jdist_cls(f, jmodel)
        losses = jax_ppo_losses(jbatch, v, dist, entropy_coeff=ec, **loss_kw)
        lr = dist.logp(jbatch[DataKeys.ACTIONS]) - jbatch[DataKeys.LOGP]
        return losses["total"] / ACCUM, (losses, jnp.mean((jnp.exp(lr) - 1) - lr))

    (_, (ref_losses, ref_kl)), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    cfg = PPOLossConfig(n_rows=N, accum=ACCUM, use_entropy=ec != 0.0, squashed=kind == "squashed", **loss_kw)
    packed, unpack = pack_rows(_torch_tree(batch))
    losses, kl, flat = ppo_grads_plain(
        pack_act_params(model, squashed=kind == "squashed"), packed, unpack, torch.tensor(ec), cfg
    )
    for k in ("entropy", "policy", "vf", "total"):
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL, err_msg=k)
    np.testing.assert_allclose(float(kl), float(ref_kl), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL)
    grad_model = type(model)(model.observation_spec, model.action_spec, hiddens=WIDE)
    load_flat_params(grad_model, flat)
    grads = to_jax_params(grad_model)
    for path, ref in jax.tree_util.tree_leaves_with_path(ref_grads):
        got = grads
        for key in path:
            got = got[key.key]
        assert _norm_rel(got, ref) < F32_GRAD_REL, jax.tree_util.keystr(path)


@pytest.mark.parametrize("kind", ["categorical", "normal", "squashed"])
def test_act_plain_matches_jax_forward_at_1024(kind: str) -> None:
    """``act_plain`` (what ``csrc/act.cu``'s staged route is held
    against on the card), deterministic, against ``rl8_tpu``'s 1024-wide
    module forward: the values, and the log-prob of the greedy action (the
    mean, or its tanh) under ``rl8_tpu``'s distribution."""
    jmodel, params, model, batch = _setup(kind, seed=3)
    obs = batch[DataKeys.VIEWS][DataKeys.OBS]
    feats, values = jmodel.apply({"params": params}, {"obs": jnp.asarray(obs)})
    packed = pack_act_params(model, squashed=kind == "squashed")
    actions, logp, tvalues = act_plain(packed, torch.from_numpy(obs), (1, 2), deterministic=True)
    if kind == "categorical":
        greedy = np.argmax(np.asarray(feats["logits"]), axis=-1).astype(np.int32)
        np.testing.assert_array_equal(actions.numpy(), greedy)
        ref_logp = JCategorical(feats, jmodel).logp(jnp.asarray(greedy))
    else:
        mean = np.asarray(feats["mean"])
        greedy = np.tanh(mean) if kind == "squashed" else mean
        np.testing.assert_allclose(actions.numpy(), greedy, rtol=ACT_RTOL, atol=ACT_ATOL)
        ref_logp = (JSquashedNormal if kind == "squashed" else JNormal)(feats, jmodel).logp(jnp.asarray(actions.numpy()))
    np.testing.assert_allclose(logp.numpy(), np.asarray(ref_logp).reshape(-1, 1), rtol=ACT_RTOL, atol=ACT_ATOL)
    np.testing.assert_allclose(tvalues.numpy(), np.asarray(values), rtol=ACT_RTOL, atol=ACT_ATOL)


def test_step_matches_jax_at_1024() -> None:
    """One whole-buffer ``step()`` of a 1024-wide default model in each
    package, from the same parameters and buffer: the kernel routes in
    both (their plain versions here, XLA autodiff on ``rl8_tpu``'s CPU)."""
    config = dict(num_envs=16, horizon=8, model_config={"hiddens": WIDE}, seed=3, entropy_coeff=0.01)
    jalgo = JAlgorithmConfig(**config).build(jenv.DiscreteDummyEnv)
    params0 = _jax_params(jalgo)
    talgo = AlgorithmConfig(**config, device="cpu").build(tenv.DiscreteDummyEnv)
    assert (talgo._fused_act, talgo._fused_update) == (True, True)
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


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    card path up to the point where it would allocate or launch."""

    @property
    def device(self) -> torch.device:
        return torch.device("cuda", 0)


def _reports_cuda(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_ReportsCuda, t)


@pytest.mark.parametrize("kind", ["categorical", "squashed"])
def test_act_wrapper_refuses_before_any_launch(kind: str, monkeypatch) -> None:
    """``fused_act`` raises ``NotImplementedError`` where the kernel's
    capacity query says -1 (for the launch's rows and the parameters'
    alignment), before it launches anything or counts a launch; and
    ``card_takes_act`` is that query at one row."""
    fused_act_module = importlib.import_module("rl8_tpu_torch.ops.fused_act")
    B = 4
    if kind == "categorical":
        model = DefaultDiscreteModel(Unbounded(1), Discrete(2, shape=(1,)), hiddens=(300, 300))
    else:
        model = DefaultContinuousModel(Unbounded(1), Unbounded(1), hiddens=(300, 300))
    params = pack_act_params(model, squashed=kind == "squashed")
    params = type(params)(**{**params.__dict__, "flat": _reports_cuda(params.flat)})
    obs = _reports_cuda(torch.zeros((B, 1)))
    asked = []

    class Library:
        def rl8_discrete_act(self, *args):
            raise AssertionError("the kernel was launched")

        rl8_continuous_act = rl8_discrete_act

    monkeypatch.setattr(fused_act_module, "_scratch_floats",
                        lambda p, rows, aligned=True: asked.append((rows, aligned)) or -1)
    monkeypatch.setattr(fused_act_module, "load", Library)
    launches = (fused_act.launches, fused_act.continuous_launches)
    with pytest.raises(NotImplementedError, match="card_takes_act"):
        fused_act(params, obs, (1, 2))
    assert asked == [(B, params.flat.data_ptr() % 16 == 0)]
    assert (fused_act.launches, fused_act.continuous_launches) == launches
    assert not card_takes_act(params) and asked[-1] == (1, True)
    monkeypatch.setattr(fused_act_module, "_scratch_floats", lambda p, rows, aligned=True: 12345)
    assert card_takes_act(params)
