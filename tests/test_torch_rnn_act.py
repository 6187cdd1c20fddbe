"""The recurrent act kernel's plain version
(``rl8_tpu_torch.ops.fused_rnn_act``) held against ``rl8_tpu`` on the CPU:
its parameter layout against ``rl8_tpu``'s ``_concat_lstm_params`` and
``_head_params``, its deterministic and noise-fed steps against flax plus
``rl8_tpu``'s distributions, and its deterministic step against
``rl8_tpu``'s Pallas kernel in interpret mode. The CUDA kernel itself is
held against this plain version on the card by ``chip_smoke.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rl8_tpu.distributions import Categorical as JCategorical
from rl8_tpu.distributions import Normal as JNormal
from rl8_tpu.distributions import SquashedNormal as JSquashedNormal
from rl8_tpu.models import DefaultContinuousRecurrentModel as JContinuous
from rl8_tpu.models import DefaultDiscreteRecurrentModel as JDiscreteModel
from rl8_tpu.ops.fused_rnn_act import fused_rnn_act as jax_fused_rnn_act
from rl8_tpu.ops.fused_rnn_ppo import _concat_lstm_params, _head_layout, _head_params
from rl8_tpu.specs import Discrete as JDiscrete
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.models import DefaultContinuousRecurrentModel, DefaultDiscreteRecurrentModel, load_jax_params
from rl8_tpu_torch.ops import fused_rnn_act, pack_rnn_params, rnn_act_plain
from rl8_tpu_torch.ops.distmath import philox_normal, philox_uniform
from rl8_tpu_torch.ops.fused_rnn_act import RnnParams
from rl8_tpu_torch.specs import Discrete, Unbounded

#: Against flax: f32 both sides, sums in another order.
RTOL, ATOL = 1e-5, 1e-5
#: Against the Pallas kernel, which multiplies in bf16 (``fused_mlp._dot``):
#: the JAX package's own recurrent act test's tolerances.
BF16_RTOL, BF16_ATOL = 2e-2, 3e-2
B, D, H = 48, 3, 16
KINDS = ["categorical", "normal", "squashed"]


def _setup(kind: str, layers: int, seed: int = 0, head_scale: float = 1.0):
    """The same default recurrent model in both packages (flax-initialized,
    perturbed, policy head kernels re-drawn with std ``head_scale`` so that
    argmaxes and means are away from ties and zero), one step's
    observations and states, and the packed parameters."""
    config = {"hidden_size": H, "num_layers": layers}
    if kind == "categorical":
        jmodel = JDiscreteModel(JUnbounded(D), JDiscrete(3, shape=(2,)), **config)
        model = DefaultDiscreteRecurrentModel(Unbounded(D), Discrete(3, shape=(2,)), **config)
        heads = ("feature_head",)
    else:
        jmodel = JContinuous(JUnbounded(D), JUnbounded(2), **config)
        model = DefaultContinuousRecurrentModel(Unbounded(D), Unbounded(2), **config)
        heads = ("action_mean", "action_log_std")
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(B, D)).astype(np.float32)
    states = {
        DataKeys.HIDDEN_STATES: (0.5 * rng.normal(size=(B, layers, H))).astype(np.float32),
        DataKeys.CELL_STATES: rng.normal(size=(B, layers, H)).astype(np.float32),
    }
    params = jax.device_get(
        jmodel.init(jax.random.key(seed), {DataKeys.OBS: jnp.asarray(obs[:, None])}, jax.tree_util.tree_map(jnp.asarray, states))["params"]
    )
    params = jax.tree_util.tree_map(lambda p: p + 0.2 * rng.normal(size=p.shape).astype(np.float32), params)
    for name in heads:
        params[name]["kernel"] = (head_scale * rng.normal(size=params[name]["kernel"].shape)).astype(np.float32)
    load_jax_params(model, params)
    packed = pack_rnn_params(model, squashed=kind == "squashed")
    return jmodel, jax.tree_util.tree_map(jnp.asarray, params), packed, obs, states


def _flax_step(jmodel, params, obs, states):
    (features, values), new_states = jmodel.apply(
        {"params": params}, {DataKeys.OBS: jnp.asarray(obs[:, None])}, jax.tree_util.tree_map(jnp.asarray, states)
    )
    return features, values, new_states


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _gap(logits: np.ndarray) -> np.ndarray:
    """Per-row smallest gap between the top two scores of any group."""
    top2 = -np.sort(-logits, axis=-1)[..., :2]
    return (top2[..., 0] - top2[..., 1]).min(axis=1)


@pytest.mark.parametrize("kind", ["categorical", "normal"])
def test_layout_matches_jax(kind: str) -> None:
    """``pack_rnn_params`` is ``rl8_tpu``'s ``_concat_lstm_params`` then
    ``_head_params`` (the layout both recurrent kernels read), bit for
    bit."""
    jmodel, params, packed, _, _ = _setup(kind, layers=2)
    want = _concat_lstm_params(params, 2)
    got = [t for layer in packed.lstm() for t in layer]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.reshape(b.shape).numpy(), np.asarray(b))
    head_names, _, _ = _head_layout(jmodel)
    for (w, b), (jw, jb) in zip(packed.heads(), zip(*[iter(_head_params(params, head_names))] * 2)):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb).ravel())
    assert packed.flat.dtype == torch.float32 and packed.flat.is_contiguous()
    with pytest.raises(ValueError, match="values"):
        RnnParams(**{**packed.__dict__, "flat": packed.flat[:-1]}).lstm()


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_deterministic_matches_flax(kind: str, layers: int) -> None:
    """The deterministic step (argmax, or the mean, squashed when the kind
    is) against flax's forward and ``rl8_tpu``'s distribution: actions,
    log-probs, values and new states."""
    jmodel, params, packed, obs, states = _setup(kind, layers, seed=layers)
    features, jvalues, jstates = _flax_step(jmodel, params, obs, states)
    dist_cls = {"categorical": JCategorical, "normal": JNormal, "squashed": JSquashedNormal}[kind]
    jdist = dist_cls(features, jmodel)
    jactions = np.asarray(jdist.deterministic_sample())
    actions, logp, values, new_states = rnn_act_plain(packed, torch.from_numpy(obs), _torch(states), (0, 0), deterministic=True)
    if kind == "categorical":
        keep = _gap(np.asarray(features["logits"])) > 1e-5
        assert keep.mean() > 0.9
        np.testing.assert_array_equal(actions.numpy()[keep], jactions[keep])
    else:
        np.testing.assert_allclose(actions.numpy(), jactions, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jdist.logp(jnp.asarray(actions.numpy()))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), rtol=RTOL, atol=ATOL)
    for key in new_states:
        assert tuple(new_states[key].shape) == (B, layers, H)
        np.testing.assert_allclose(new_states[key].numpy(), np.asarray(jstates[key]), rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("kind", KINDS)
def test_injected_noise_matches_jax_distribution(kind: str) -> None:
    """With noise fed in: Gumbel-argmax of flax's log-probs on the same
    uniforms, or mean + std * noise (tanh-squashed), and ``rl8_tpu``'s
    log-prob of those actions. Squashed log-probs are compared where the
    pre-squash |x| < 2 (ROADMAP Queue 3: XLA's FMA and ATen's rounding of
    1 - a^2 differ near +-1)."""
    jmodel, params, packed, obs, states = _setup(kind, layers=2, seed=7)
    features, _, _ = _flax_step(jmodel, params, obs, states)
    rng = np.random.default_rng(8)
    if kind == "categorical":
        logits = np.asarray(features["logits"], dtype=np.float64)  # [B, A, n]
        u = rng.uniform(1e-7, 1.0, size=(B, 6)).astype(np.float32)
        z = logits - logits.max(-1, keepdims=True)
        z = z - np.log(np.exp(z).sum(-1, keepdims=True))
        scores = z - np.log(-np.log(u.astype(np.float64).reshape(B, 2, 3)))
        expected = scores.argmax(-1)
        actions, logp, _, _ = rnn_act_plain(
            packed, torch.from_numpy(obs), _torch(states), (0, 0), deterministic=False, noise=torch.from_numpy(u)
        )
        keep = _gap(scores) > 1e-4
        np.testing.assert_array_equal(actions.numpy()[keep], expected[keep])
        jlogp = np.asarray(JCategorical(features, jmodel).logp(jnp.asarray(actions.numpy())))
        np.testing.assert_allclose(logp.numpy(), jlogp, rtol=RTOL, atol=ATOL)
        return
    noise = rng.normal(size=(B, 2)).astype(np.float32)
    mean, log_std = np.asarray(features["mean"]), np.asarray(features["log_std"])
    x = mean + np.exp(log_std) * noise
    actions, logp, _, _ = rnn_act_plain(
        packed, torch.from_numpy(obs), _torch(states), (0, 0), deterministic=False, noise=torch.from_numpy(noise)
    )
    keep = np.ones(B, dtype=bool)
    if kind == "squashed":
        keep = (np.abs(x) < 2.0).all(axis=1)
        assert keep.mean() > 0.25
        x = np.tanh(x)
    np.testing.assert_allclose(actions.numpy(), x, rtol=RTOL, atol=ATOL)
    dist = (JSquashedNormal if kind == "squashed" else JNormal)(features, jmodel)
    jlogp = np.asarray(dist.logp(jnp.asarray(actions.numpy())))
    np.testing.assert_allclose(logp.numpy()[keep], jlogp[keep], rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("kind", ["categorical", "normal"])
def test_philox_draws_are_the_kernels(kind: str) -> None:
    """Without injected noise, the plain version draws the act kernel's
    Philox stream: the same as feeding it ``philox_uniform`` /
    ``philox_normal`` of the step's key."""
    _, _, packed, obs, states = _setup(kind, layers=1, seed=9)
    key = (123, 456)
    noise = philox_uniform(*key, B, 2, 3) if kind == "categorical" else philox_normal(*key, B, 2)
    a1, l1, v1, s1 = rnn_act_plain(packed, torch.from_numpy(obs), _torch(states), key, deterministic=False)
    a2, l2, v2, s2 = rnn_act_plain(packed, torch.from_numpy(obs), _torch(states), key, deterministic=False, noise=noise)
    assert torch.equal(a1, a2) and torch.equal(l1, l2) and torch.equal(v1, v2)
    a3, _, _, _ = rnn_act_plain(packed, torch.from_numpy(obs), _torch(states), (123, 457), deterministic=False)
    assert not torch.equal(a1, a3)


def test_deterministic_matches_pallas_kernel_interpret() -> None:
    """Against ``rl8_tpu``'s recurrent act kernel run in interpret mode
    (two layers, categorical): it multiplies in bf16, hence bf16
    tolerances, and actions compared where the top-2 logits are apart by
    more than that error."""
    jmodel, params, packed, obs, states = _setup("categorical", layers=2, seed=11, head_scale=3.0)
    with pltpu.force_tpu_interpret_mode():
        ja, jl, jv, jstates = jax_fused_rnn_act(
            jmodel, params, jnp.asarray(obs), jax.tree_util.tree_map(jnp.asarray, states), jax.random.key(5),
            deterministic=True,
        )
    actions, logp, values, new_states = rnn_act_plain(packed, torch.from_numpy(obs), _torch(states), (0, 0), deterministic=True)
    features, _, _ = _flax_step(jmodel, params, obs, states)
    keep = _gap(np.asarray(features["logits"])) > 0.1
    assert keep.mean() > 0.5
    np.testing.assert_array_equal(actions.numpy()[keep], np.asarray(ja)[keep])
    np.testing.assert_allclose(logp.numpy()[keep], np.asarray(jl)[keep], rtol=BF16_RTOL, atol=BF16_ATOL)
    np.testing.assert_allclose(values.numpy(), np.asarray(jv), rtol=BF16_RTOL, atol=BF16_ATOL)
    for key in new_states:
        np.testing.assert_allclose(new_states[key].numpy(), np.asarray(jstates[key]), rtol=BF16_RTOL, atol=BF16_ATOL)


def test_fused_rnn_act_cpu_takes_the_plain_version_and_validates() -> None:
    _, _, packed, obs, states = _setup("normal", layers=2, seed=12)
    tobs, tstates = torch.from_numpy(obs), _torch(states)
    before = (fused_rnn_act.launches, fused_rnn_act.continuous_launches)
    got = fused_rnn_act(packed, tobs, tstates, (5, 6))
    want = rnn_act_plain(packed, tobs, tstates, (5, 6), deterministic=False)
    assert (fused_rnn_act.launches, fused_rnn_act.continuous_launches) == before  # no kernel on the CPU
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    assert all(torch.equal(got[3][k], want[3][k]) for k in want[3])
    # Narrow observations are widened to f32 first.
    widened = fused_rnn_act(packed, tobs.to(torch.bfloat16), tstates, (5, 6), deterministic=True)
    assert widened[0].dtype == torch.float32
    with pytest.raises(ValueError, match="obs must be"):
        fused_rnn_act(packed, tobs[:, :2], tstates, (5, 6))
    with pytest.raises(ValueError, match="hidden_states must be"):
        fused_rnn_act(packed, tobs, {**tstates, DataKeys.HIDDEN_STATES: tstates[DataKeys.HIDDEN_STATES][:, :1]}, (5, 6))
    with pytest.raises(ValueError, match="cell_states must be"):
        fused_rnn_act(packed, tobs, {**tstates, DataKeys.CELL_STATES: tstates[DataKeys.CELL_STATES].double()}, (5, 6))
    with pytest.raises(ValueError, match="32-bit"):
        fused_rnn_act(packed, tobs, tstates, (-1, 6))
    with pytest.raises(ValueError, match="meta"):
        fused_rnn_act(packed, tobs.to("meta"), {k: v.to("meta") for k, v in tstates.items()}, (5, 6))
    with pytest.raises(ValueError, match="squashed"):
        pack_rnn_params(DefaultDiscreteRecurrentModel(Unbounded(D), Discrete(3), hidden_size=4), squashed=True)
    with pytest.raises(ValueError, match="LSTM layers"):
        pack_rnn_params(DefaultDiscreteRecurrentModel(Unbounded(D), Discrete(3), hidden_size=4, num_layers=9))
