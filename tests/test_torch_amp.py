"""bf16 mixed precision (``enable_amp`` and a model's ``dtype``) in the
port against ``rl8_tpu`` on the CPU, from the same numpy weights of a
seed at small widths.

The tolerance rule: both packages' bf16 results are held against an f32
reference (``rl8_tpu``'s f32 forward or step from the same weights and
inputs). The port's error must be at most twice ``rl8_tpu``'s own error
against that reference (plus :data:`FLOOR`, for results where both round
alike), and the port must agree with ``rl8_tpu`` to :data:`BF16_REL` of
the reference's scale: a few bf16 rounding steps (2^-8 relative).

XLA on the CPU keeps some elementwise chains in f32 where flax's code
rounds to bf16 (inside ``jit``, a bf16 ``tanh`` or bias add followed by
a cast to f32 loses its rounding), so a jitted ``rl8_tpu`` step is more
precise than its own code says; the port rounds where flax's code does.
The 2x rule on a step therefore takes ``rl8_tpu``'s error from its step
run op by op (``jax.disable_jit()``: flax's code as written), and the
port-vs-``rl8_tpu`` tolerance from its jitted step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rl8_tpu.env as jenv
import rl8_tpu_torch.env as tenv
from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
from rl8_tpu import RecurrentAlgorithmConfig as JRecurrentAlgorithmConfig
from rl8_tpu.models import DefaultContinuousModel as JContinuous
from rl8_tpu.models import DefaultContinuousRecurrentModel as JContinuousRecurrent
from rl8_tpu.models import DefaultDiscreteModel as JDiscrete
from rl8_tpu.models import DefaultDiscreteRecurrentModel as JDiscreteRecurrent
from rl8_tpu.specs import Discrete as JDiscreteSpec
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.models import (
    DefaultContinuousModel,
    DefaultContinuousRecurrentModel,
    DefaultDiscreteModel,
    DefaultDiscreteRecurrentModel,
    load_jax_params,
    to_jax_params,
)
from rl8_tpu_torch.nn import MLP, LayerNorm
from rl8_tpu_torch.specs import Discrete, Unbounded
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: The port's distance to ``rl8_tpu`` in bf16, relative to the f32
#: reference's largest magnitude: a few bf16 rounding steps (2^-8).
BF16_REL = 2e-2
#: Absolute slack of the 2x rule where both packages round exactly alike.
FLOOR = 1e-6
OBS_DIM, HIDDENS = 6, (64, 64)
_OBS = (3.0 * np.random.default_rng(0).normal(size=(64, OBS_DIM))).astype(np.float32)


def _hold(port, jax_bf16, ref, what: str) -> None:
    """The tolerance rule on one output."""
    port, jax_bf16, ref = (np.asarray(x, dtype=np.float64) for x in (port, jax_bf16, ref))
    scale = max(np.abs(ref).max(), 1e-3)
    port_err = np.abs(port - ref).max()
    jax_err = np.abs(jax_bf16 - ref).max()
    assert port_err <= 2.0 * jax_err + FLOOR * scale, (what, port_err, jax_err)
    assert np.abs(port - jax_bf16).max() <= BF16_REL * scale, (what, np.abs(port - jax_bf16).max(), scale)


def _leaves(tree) -> list:
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x) for x in jax.tree_util.tree_leaves(tree)]


FEEDFORWARD = {
    "discrete": (JDiscrete, DefaultDiscreteModel, JDiscreteSpec(4, shape=(2,)), Discrete(4, shape=(2,))),
    "continuous": (JContinuous, DefaultContinuousModel, JUnbounded(shape=(2,)), Unbounded(shape=(2,))),
}


@pytest.mark.parametrize("activation", ["relu", "tanh"])
@pytest.mark.parametrize("kind", list(FEEDFORWARD))
def test_default_models_bf16_forward_matches_flax(kind: str, activation: str) -> None:
    """The default feedforward models with ``dtype=bfloat16`` against
    flax's bf16 forward from the same f32 parameters; features and values
    come back f32."""
    jcls, tcls, jspec, tspec = FEEDFORWARD[kind]
    kw = dict(hiddens=HIDDENS, activation_fn=activation)
    j32 = jcls(JUnbounded(shape=(OBS_DIM,)), jspec, **kw)
    j16 = jcls(JUnbounded(shape=(OBS_DIM,)), jspec, dtype=jnp.bfloat16, **kw)
    batch = {DataKeys.OBS: jnp.asarray(_OBS)}
    params = j32.init(jax.random.key(0), batch)["params"]
    ref = j32.apply({"params": params}, batch)
    want = j16.apply({"params": params}, batch)
    model = tcls(Unbounded(shape=(OBS_DIM,)), tspec, dtype=torch.bfloat16, **kw)
    load_jax_params(model, jax.device_get(params))
    got = model({DataKeys.OBS: torch.from_numpy(_OBS)})
    assert all(leaf.dtype == torch.float32 for leaf in jax.tree_util.tree_leaves(got))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for g, w, r in zip(_leaves(got), _leaves(want), _leaves(ref)):
        _hold(g, w, r, kind)


RECURRENT = {
    "discrete": (JDiscreteRecurrent, DefaultDiscreteRecurrentModel, JDiscreteSpec(3), Discrete(3)),
    "continuous": (JContinuousRecurrent, DefaultContinuousRecurrentModel, JUnbounded(shape=(2,)), Unbounded(shape=(2,))),
}


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("kind", list(RECURRENT))
def test_default_recurrent_models_bf16_forward_matches_flax(kind: str, num_layers: int) -> None:
    """The default recurrent models with ``dtype=bfloat16`` over a
    ``[B, 5]`` sequence from nonzero states against flax's bf16 forward:
    the features, the values and the new states, which stay f32 (the f32
    carry promotes the cells' bf16 gates, as in flax)."""
    jcls, tcls, jspec, tspec = RECURRENT[kind]
    kw = dict(hidden_size=32, num_layers=num_layers)
    rng = np.random.default_rng(1)
    obs = (2.0 * rng.normal(size=(8, 5, OBS_DIM))).astype(np.float32)
    states = {
        DataKeys.HIDDEN_STATES: (0.5 * rng.normal(size=(8, num_layers, 32))).astype(np.float32),
        DataKeys.CELL_STATES: rng.normal(size=(8, num_layers, 32)).astype(np.float32),
    }
    j32 = jcls(JUnbounded(shape=(OBS_DIM,)), jspec, **kw)
    j16 = jcls(JUnbounded(shape=(OBS_DIM,)), jspec, dtype=jnp.bfloat16, **kw)
    jbatch = {DataKeys.OBS: jnp.asarray(obs)}
    jstates = {k: jnp.asarray(v) for k, v in states.items()}
    params = j32.init(jax.random.key(0), jbatch, jstates)["params"]
    ref = j32.apply({"params": params}, jbatch, jstates)
    want = j16.apply({"params": params}, jbatch, jstates)
    model = tcls(Unbounded(shape=(OBS_DIM,)), tspec, dtype=torch.bfloat16, **kw)
    load_jax_params(model, jax.device_get(params))
    got = model({DataKeys.OBS: torch.from_numpy(obs)}, {k: torch.from_numpy(v) for k, v in states.items()})
    assert all(leaf.dtype == torch.float32 for leaf in jax.tree_util.tree_leaves(got))
    for g, w, r in zip(_leaves(got), _leaves(want), _leaves(ref)):
        _hold(g, w, r, kind)


def test_mlp_and_layer_norm_compute_dtype() -> None:
    """``MLP(dtype=bfloat16, layer_norm=True)`` keeps f32 parameters and
    returns bf16; its LayerNorm reduces in f32 (flax's
    ``_compute_stats``): a row whose mean dwarfs its spread normalizes as
    the f32 LayerNorm of the bf16 input does."""
    mlp = MLP(3, (8, 8), layer_norm=True, dtype=torch.bfloat16)
    assert mlp(torch.ones(2, 3)).dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in mlp.parameters())
    z = (torch.tensor([[512.0, 514.0, 516.0, 518.0]])).to(torch.bfloat16)
    got = LayerNorm(4, dtype=torch.bfloat16)(z)
    want = LayerNorm(4)(z.to(torch.float32)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# ----------------------------------------------------------------------
# enable_amp: a step against rl8_tpu's
# ----------------------------------------------------------------------


def _copy_buffer(jalgo, talgo) -> None:
    jbuf = jax.device_get(jalgo.state.buffer)
    talgo.state.buffer = {
        k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()} if isinstance(v, dict) else torch.from_numpy(np.array(v))
        for k, v in jbuf.items()
    }
    talgo.state.reward_scale = torch.tensor(float(jalgo.state.reward_scale))
    talgo.state.horizons = int(jalgo.state.horizons)
    talgo.state.buffered = True


STAT_KEYS = ("losses/entropy", "losses/policy", "losses/vf", "losses/total")


def _flat_tree(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def _amp_steps(jcfg_cls, tcfg_cls, jenv_cls, tenv_cls, config: dict, jamp_kw=None, tamp_kw=None):
    """rl8_tpu's f32 step, its bf16 step (jitted, and op by op) and the
    port's bf16 step from the same weights and buffer (``rl8_tpu``'s f32
    rollout), each one SGD update of the whole buffer: the parameters
    move by ``-lr`` times the gradient, so the deltas hold the gradients.
    bf16 is ``enable_amp=True`` unless ``jamp_kw``/``tamp_kw`` say."""
    jamp_kw = jamp_kw or {"enable_amp": True}
    tamp_kw = tamp_kw or {"enable_amp": True}
    common = dict(config, optimizer_config={"lr": 0.5}, num_sgd_iters=1, entropy_coeff=0.01, max_grad_norm=1e6)
    jref = jcfg_cls(**common, optimizer_cls=optax.sgd).build(jenv_cls)
    params0 = jax.device_get(jref.state.params)
    jref.collect()
    jamp = jcfg_cls(**{**common, **jamp_kw}, optimizer_cls=optax.sgd).build(jenv_cls)
    # Copies: each step donates its state's buffers.
    fields = ("params", "buffer", "reward_scale", "horizons", "buffered") + (("seqs",) if hasattr(jref.state, "seqs") else ())
    jamp.state = jamp.state.replace(
        **{f: jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), getattr(jref.state, f)) for f in fields}
    )
    tamp = tcfg_cls(**{**common, **tamp_kw}, optimizer_cls=torch.optim.SGD, device="cpu").build(tenv_cls)
    assert tamp.policy.model.dtype == torch.bfloat16
    assert (tamp._fused_act, tamp._fused_update) == (False, False)
    load_jax_params(tamp.policy.model, params0)
    _copy_buffer(jref, tamp)
    jeager = jcfg_cls(**{**common, **jamp_kw}, optimizer_cls=optax.sgd).build(jenv_cls)
    jeager.state = jeager.state.replace(
        **{f: jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), getattr(jamp.state, f)) for f in fields}
    )
    out = [(jref.step(), jref.state.params), (jamp.step(), jamp.state.params)]
    with jax.disable_jit():
        out.append((jeager.step(), jeager.state.params))
    stats = tamp.step()
    out.append((stats, to_jax_params(tamp.policy.model)))
    start = _flat_tree(params0)
    return [(s, _flat_tree(jax.device_get(p)) - start) for s, p in out]


def _hold_step(results) -> None:
    """The rule on one step. Its gradients (the parameter deltas) are held
    by their root-mean-square errors over every parameter: the port's
    against the f32 step at most twice ``rl8_tpu``'s, and the port within
    three times ``rl8_tpu``'s own error of ``rl8_tpu``'s jitted step (the
    two bf16 results agree as closely as bf16 lets either approach f32;
    a bf16 gradient through LayerNorm is off by several percent of its
    RMS). One scalar's bf16 error is a sum of many roundings whose size
    varies by more than 2x between two equally precise implementations,
    so the losses are held by the port-vs-``rl8_tpu`` tolerance alone, on
    the scale of the total loss they sum into (the per-row outputs they
    are means of are held by the 2x rule in the forward tests above)."""
    (rs, rd), (js, jd), (es, ed), (ts, td) = results
    for key in STAT_KEYS:
        scale = max(abs(rs[key]), abs(rs["losses/total"]), 1e-3)
        assert abs(ts[key] - js[key]) <= BF16_REL * scale, (key, ts[key], js[key], rs[key])
    assert np.linalg.norm(jd) > 0
    rms = lambda x: float(np.sqrt(np.mean(np.square(x))))  # noqa: E731
    floor = FLOOR * rms(rd)
    assert rms(td - rd) <= 2.0 * rms(ed - rd) + floor, (rms(td - rd), rms(ed - rd))
    assert rms(td - jd) <= 3.0 * rms(jd - rd) + floor, (rms(td - jd), rms(jd - rd))


@pytest.mark.parametrize("env", ["discrete", "continuous"])
def test_enable_amp_step_matches_jax(env: str) -> None:
    """``AlgorithmConfig(enable_amp=True)``: the default model computes in
    bf16 on the module rollout and the autodiff update, and one step's
    losses and gradients hold against ``rl8_tpu``'s AMP step."""
    jenv_cls, tenv_cls = {
        "discrete": (jenv.DiscreteDummyEnv, tenv.DiscreteDummyEnv),
        "continuous": (jenv.ContinuousDummyEnv, tenv.ContinuousDummyEnv),
    }[env]
    config = dict(num_envs=64, horizon=8, model_config={"hiddens": (32, 32)}, seed=3)
    _hold_step(_amp_steps(JAlgorithmConfig, AlgorithmConfig, jenv_cls, tenv_cls, config))


def test_enable_amp_recurrent_step_matches_jax() -> None:
    """``RecurrentAlgorithmConfig(enable_amp=True)``: the default recurrent
    model computes in bf16 on the recurrent module rollout and autodiff
    update; one step against ``rl8_tpu``'s AMP step."""
    config = dict(num_envs=32, horizon=8, seq_len=2, seqs_per_state_reset=2, model_config={"hidden_size": 16}, seed=3)
    _hold_step(_amp_steps(JRecurrentAlgorithmConfig, RecurrentAlgorithmConfig, jenv.DiscreteDummyEnv,
                          tenv.DiscreteDummyEnv, config))


def test_enable_amp_collect_and_learning_drive() -> None:
    """An AMP rollout's log-probs and values are the bf16 module's own on
    the buffer (f32 in the buffer, as ``rl8_tpu`` casts them), and the
    verify recipe's drive with ``enable_amp=True`` learns the optimal
    greedy policy."""
    algo = AlgorithmConfig(num_envs=256, horizon=16, seed=1, enable_amp=True, device="cpu").build(tenv.DiscreteDummyEnv)
    for _ in range(30):
        algo.collect(env_config={"bounds": 10.0})
        buf = algo.state.buffer
        assert buf[DataKeys.LOGP].dtype == buf[DataKeys.VALUES].dtype == torch.float32
        with torch.no_grad():
            _, values = algo.policy.model(algo._training_views(buf))
        v = buf[DataKeys.VALUES][:-1].transpose(0, 1).reshape(-1, 1)
        torch.testing.assert_close(values, v, rtol=1e-6, atol=1e-6)
        algo.step()
    obs = torch.tensor([[[5.0]], [[-5.0]], [[2.0]], [[-2.0]]])
    out = algo.policy.sample({DataKeys.OBS: obs}, kind="last", deterministic=True)
    assert out[DataKeys.ACTIONS].ravel().tolist() == [0, 1, 0, 1]


def test_enable_amp_leaves_custom_models_alone() -> None:
    """With a custom model, ``enable_amp`` changes nothing but the
    hyperparameters, as in ``rl8_tpu``."""
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule

    algo = AlgorithmConfig(model_cls=MischievousMule, enable_amp=True, num_envs=8, horizon=8,
                           model_config={"hiddens": (8, 8)}, device="cpu").build(AlgoTrading)
    assert algo.policy.model.dtype is None and algo.hparams.enable_amp
    assert algo.params["enable_amp"] is True


# ----------------------------------------------------------------------
# bf16 MischievousMule (the JAX bench's algotrading configuration)
# ----------------------------------------------------------------------


def _mule_models():
    """rl8_tpu's MischievousMule in f32 and bf16 with the same perturbed
    parameters, the port's bf16 one with them, and a views batch."""
    from examples.algotrading.env import AlgoTrading as JAlgoTrading
    from examples.algotrading.models import MischievousMule as JMischievousMule
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule
    from tests.test_torch_algotrading import _mule_batch

    jenv_ = JAlgoTrading(1)
    j32 = JMischievousMule(jenv_.observation_spec, jenv_.action_spec, hiddens=(32, 32))
    j16 = JMischievousMule(jenv_.observation_spec, jenv_.action_spec, hiddens=(32, 32), dtype=jnp.bfloat16)
    batch = _mule_batch()
    params = j32.init(jax.random.key(3), jax.tree_util.tree_map(jnp.asarray, batch))["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(4), len(leaves))
    params = jax.tree_util.tree_unflatten(treedef, [p + 0.2 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])
    tenv_ = AlgoTrading(1, device="cpu")
    tmodel = MischievousMule(tenv_.observation_spec, tenv_.action_spec, hiddens=(32, 32), dtype=torch.bfloat16)
    load_jax_params(tmodel, jax.device_get(params))
    return j32, j16, params, tmodel, batch


def _unmasked(feat_values) -> list[np.ndarray]:
    """Logits (masked entries, at FMIN, zeroed) and values as numpy."""
    feat, values = feat_values
    logits = np.asarray(feat["logits"].detach() if isinstance(feat["logits"], torch.Tensor) else feat["logits"])
    values = np.asarray(values.detach() if isinstance(values, torch.Tensor) else values)
    return [np.where(logits < -1e37, 0.0, logits), values]


@pytest.mark.parametrize("route", ["module", "fused"])
def test_bf16_mule_forward_matches_flax(route: str) -> None:
    """``MischievousMule(dtype=bfloat16)`` against ``rl8_tpu``'s bf16 model
    from the same parameters: the module forward against flax's, and the
    fused apply (the chains' plain versions on the bf16 input upcast to
    f32) against ``rl8_tpu``'s ``fused_custom_apply`` (the Pallas kernel
    in interpret mode, bf16 operands); both under the 2x rule against the
    f32 flax forward, and f32 outputs."""
    from rl8_tpu.ops.fused_mlp import fused_custom_apply as jfused_custom_apply
    from rl8_tpu_torch.ops import fused_custom_apply, supports_fused_apply
    from rl8_tpu_torch.views import tree_map

    j32, j16, params, tmodel, batch = _mule_models()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    ref = j32.apply({"params": params}, jbatch)
    tbatch = tree_map(torch.from_numpy, batch)
    if route == "module":
        want = j16.apply({"params": params}, jbatch)
        with torch.no_grad():
            got = tmodel(tbatch)
    else:
        assert supports_fused_apply(tmodel)
        want = jfused_custom_apply(j16, params, jbatch, interpret=True)
        got = fused_custom_apply(tmodel, tbatch)
    assert got[0]["logits"].dtype == got[1].dtype == torch.float32
    for g, w, r in zip(_unmasked(got), _unmasked(want), _unmasked(ref)):
        _hold(g, w, r, route)


@pytest.mark.parametrize("fused_forward", [True, False], ids=["fused", "module"])
def test_bf16_mule_step_matches_jax(fused_forward: bool) -> None:
    """BASELINE #5's model, ``MischievousMule(dtype=bfloat16)``, in a step
    against ``rl8_tpu``'s bf16 step: through the chain kernels' plain
    versions (f32 compute on the bf16-assembled input, which only
    tightens the numerics) and through the bf16 module with autograd.
    ``rl8_tpu`` on the CPU runs the module either way."""
    from examples.algotrading.models import MischievousMule as JMischievousMule
    from rl8_tpu_torch.examples.algotrading import MischievousMule
    from tests.test_torch_custom_step import JaxStartTrading, TorchStartTrading

    config = dict(num_envs=16, horizon=8, horizons_per_env_reset=2, seed=3, model_config={"hiddens": (32, 32)})
    results = _amp_steps(
        lambda **kw: JAlgorithmConfig(model_cls=JMischievousMule, **kw),
        lambda **kw: AlgorithmConfig(model_cls=MischievousMule, fused_forward=fused_forward, **kw),
        JaxStartTrading, TorchStartTrading, config,
        jamp_kw={"model_config": {"hiddens": (32, 32), "dtype": jnp.bfloat16}},
        tamp_kw={"model_config": {"hiddens": (32, 32), "dtype": torch.bfloat16}},
    )
    _hold_step(results)


# ----------------------------------------------------------------------
# A bf16 model across the flax tree, export and serving
# ----------------------------------------------------------------------


@pytest.mark.parametrize("recurrent", [False, True], ids=["feedforward", "recurrent"])
def test_bf16_policy_converts_exports_and_serves(tmp_path, recurrent: bool) -> None:
    """A bf16 default model's parameters cross to and from the flax tree as
    f32 with the model's dtype kept; ``Policy.save``/``load`` keep it, and
    ``PolicyModel.predict`` serves f32 values and log-probs held against
    ``rl8_tpu``'s ``PolicyModel`` over its bf16 model under the rule."""
    from rl8_tpu.policies import Policy as JPolicy
    from rl8_tpu.policies import RecurrentPolicy as JRecurrentPolicy
    from rl8_tpu.policies.serving import PolicyModel as JPolicyModel
    from rl8_tpu.policies.serving import RecurrentPolicyModel as JRecurrentPolicyModel
    from rl8_tpu_torch.policies import Policy, RecurrentPolicy
    from rl8_tpu_torch.policies.serving import PolicyModel, RecurrentPolicyModel

    jcls, tcls, jserve, tserve = (
        (JRecurrentPolicy, RecurrentPolicy, JRecurrentPolicyModel, RecurrentPolicyModel) if recurrent
        else (JPolicy, Policy, JPolicyModel, PolicyModel)
    )
    mc = {"hidden_size": 16} if recurrent else {"hiddens": (16, 16)}
    jspecs, tspecs = (JUnbounded(5), JDiscreteSpec(3, shape=(1,))), (Unbounded(5), Discrete(3, shape=(1,)))
    j32 = jcls(*jspecs, model_config=mc)
    j16 = jcls(*jspecs, model_config={**mc, "dtype": jnp.bfloat16})
    params = j32.init_params(jax.random.key(0))
    policy = tcls(*tspecs, model_config={**mc, "dtype": torch.bfloat16})
    load_jax_params(policy.model, jax.device_get(params))
    tree = to_jax_params(policy.model)
    assert all(leaf.dtype == np.float32 for leaf in jax.tree_util.tree_leaves(tree))
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(jax.device_get(params))):
        np.testing.assert_array_equal(a, b)
    path = tmp_path / "policy.pkl"
    policy.save(path)
    loaded = tcls.load(path, device="cpu")
    assert loaded.model.dtype is torch.bfloat16
    assert all(p.dtype == torch.float32 for p in loaded.model.parameters())
    obs = np.random.default_rng(3).normal(size=(7, 3, 5)).astype(np.float32)
    got, want, ref = (m.predict({DataKeys.OBS: obs}) for m in (
        tserve(loaded, device="cpu"), jserve(j16, params), jserve(j32, params)))
    if recurrent:
        (got, got_states), (want, want_states), (ref, ref_states) = got, want, ref
        for key in got_states:
            _hold(np.stack(got_states[key].to_list()), np.stack(want_states[key].to_list()),
                  np.stack(ref_states[key].to_list()), key)
    arrays = tserve(loaded, device="cpu")._predict_arrays({DataKeys.OBS: obs})
    arrays = arrays[0] if recurrent else arrays
    assert arrays[DataKeys.LOGP].dtype == arrays[DataKeys.VALUES].dtype == np.float32
    for key in (DataKeys.LOGP, DataKeys.VALUES):
        _hold(np.stack(got[key].to_list()), np.stack(want[key].to_list()), np.stack(ref[key].to_list()), key)
