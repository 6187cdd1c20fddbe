"""The continuous slice's distributions, model, distribution math, act
plain version and policy, held against ``rl8_tpu`` on the CPU. The
continuous act kernel itself is held against ``act_plain`` on the card by
``chip_smoke.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rl8_tpu.distributions import Normal as JNormal
from rl8_tpu.distributions import SquashedNormal as JSquashedNormal
from rl8_tpu.models import DefaultContinuousModel as JModel
from rl8_tpu.ops import distmath as jdm
from rl8_tpu.ops.fused_act import fused_act as jax_fused_act
from rl8_tpu.policies import Policy as JPolicy
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu_torch.distributions import Distribution, Normal, SquashedNormal
from rl8_tpu_torch.models import DefaultContinuousModel, Model, load_jax_params, to_jax_params
from rl8_tpu_torch.ops import act_plain, fused_act, pack_act_params
from rl8_tpu_torch.ops import distmath as tdm
from rl8_tpu_torch.ops.distmath import philox4x32, philox_normal
from rl8_tpu_torch.policies import Policy
from rl8_tpu_torch.specs import Unbounded

#: f32 on both sides, other summation orders and transcendental
#: implementations (XLA's against ATen's): a few ulps of values of order
#: 1-10, and of log-probs whose atanh magnifies a squashed action's ulps.
ATOL, RTOL = 1e-5, 1e-5
LOGP_ATOL = 1e-4
#: Squashed log-probs are compared where every pre-squash |x| is below
#: this: near a squashed action of +-1 (but not on the clip), 1 - a^2
#: cancels, and XLA contracts it into an FMA where ATen rounds a^2 first,
#: which moves the log-det term by up to ~1e-2. Actions of exactly +-1 (the
#: clip) are well-conditioned and are compared too.
SQUASH_LIMIT = 2.0
#: Against the Pallas act kernel, which multiplies the hidden layers in
#: bf16 (``fused_mlp._dot``): the discrete act test's tolerances.
BF16_RTOL, BF16_ATOL = 2e-2, 3e-2

DISTS = [(Normal, JNormal), (SquashedNormal, JSquashedNormal)]
KINDS = ["normal", "squashed"]


def _features(B: int = 32, A: int = 3, seed: int = 0):
    rng = np.random.default_rng(seed)
    mean = (rng.normal(size=(B, A)) * 2).astype(np.float32)
    log_std = np.tanh(rng.normal(size=(B, A))).astype(np.float32)
    return rng, {"mean": mean, "log_std": log_std}


def _both(cls, jcls, feats):
    return cls({k: torch.from_numpy(v) for k, v in feats.items()}), jcls({k: jnp.asarray(v) for k, v in feats.items()})


@pytest.mark.parametrize("cls,jcls", DISTS)
def test_distribution_matches_jax(cls, jcls) -> None:
    """logp, entropy and the deterministic sample on the same features;
    squashed samples include the clip (+-1) and the +-100 clamp."""
    rng, feats = _features()
    dist, jdist = _both(cls, jcls, feats)
    if cls is SquashedNormal:
        samples = np.tanh(np.clip(rng.normal(size=(32, 3)), -SQUASH_LIMIT, SQUASH_LIMIT)).astype(np.float32)
        samples[:4] = np.sign(samples[:4])  # on the clip; far from a small-std mean
    else:
        samples = (rng.normal(size=(32, 3)) * 3).astype(np.float32)
    np.testing.assert_allclose(
        dist.logp(torch.from_numpy(samples)).numpy(), np.asarray(jdist.logp(jnp.asarray(samples))),
        rtol=RTOL, atol=LOGP_ATOL,
    )
    np.testing.assert_allclose(
        dist.deterministic_sample().numpy(), np.asarray(jdist.deterministic_sample()), rtol=RTOL, atol=ATOL
    )
    if cls is SquashedNormal:
        with pytest.raises(NotImplementedError) as err:
            dist.entropy()
        with pytest.raises(NotImplementedError) as jerr:
            jdist.entropy()
        assert str(err.value) == str(jerr.value)
    else:
        np.testing.assert_allclose(dist.entropy().numpy(), np.asarray(jdist.entropy()), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cls", [Normal, SquashedNormal])
def test_distribution_sample_moments(cls) -> None:
    """Samples from a generator: standardized pre-squash draws have mean
    0 and variance 1 within 5 sampling stds; squashed ones lie in [-1, 1]."""
    mean, log_std = torch.full((20000, 1), 0.3), torch.full((20000, 1), -0.5)
    x = cls({"mean": mean, "log_std": log_std}).sample(torch.Generator().manual_seed(0))
    assert x.shape == (20000, 1) and x.dtype == torch.float32
    if cls is SquashedNormal:
        assert float(x.abs().max()) <= 1.0
        x = torch.atanh(x.clamp(-1 + 1e-6, 1 - 1e-6))
    z = ((x - 0.3) / np.exp(-0.5)).double()
    assert abs(float(z.mean())) < 5 / np.sqrt(20000)
    assert abs(float(z.var()) - 1) < 5 * np.sqrt(2 / 20000)


def test_default_classes_for_unbounded_actions() -> None:
    assert Distribution.default_dist_cls(Unbounded(2)) is Normal
    assert Model.default_model_cls(Unbounded(3), Unbounded(2)) is DefaultContinuousModel


def _setup(A: int = 2, d: int = 3, hiddens=(32, 16), activation: str = "relu", seed: int = 0, scale: float = 0.3):
    """The same continuous model in both packages, flax-initialized and
    perturbed so that the small-init heads give means and log-stds of
    order 1."""
    jmodel = JModel(JUnbounded(d), JUnbounded(A), hiddens=hiddens, activation_fn=activation)
    params = jmodel.init(jax.random.key(seed), {"obs": jnp.zeros((1, d))})["params"]
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(np.asarray(p) + scale * rng.normal(size=p.shape).astype(np.float32)) for p in leaves]
    )
    model = DefaultContinuousModel(Unbounded(d), Unbounded(A), hiddens=hiddens, activation_fn=activation)
    load_jax_params(model, jax.device_get(params))
    return jmodel, params, model, rng


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_model_forward_matches_flax(activation: str) -> None:
    jmodel, params, model, rng = _setup(activation=activation)
    obs = (rng.normal(size=(64, 3)) * 5).astype(np.float32)
    jfeat, jval = jmodel.apply({"params": params}, {"obs": jnp.asarray(obs)})
    with torch.no_grad():
        feat, val = model({"obs": torch.from_numpy(obs)})
    for key in ("mean", "log_std"):
        assert feat[key].shape == (64, 2)
        np.testing.assert_allclose(feat[key].numpy(), np.asarray(jfeat[key]), rtol=RTOL, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=RTOL, atol=ATOL)


def test_to_jax_params_round_trip_and_layout() -> None:
    """to_jax_params gives the flax tree back leaf for leaf, and a port
    model initialized on its own loads into flax with its structure."""
    _, params, model, _ = _setup()
    tree = to_jax_params(model)
    flat_ref = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
    flat_got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_got] == [jax.tree_util.keystr(p) for p, _ in flat_ref]
    for (_, got), (_, ref) in zip(flat_got, flat_ref):
        np.testing.assert_array_equal(got, np.asarray(ref))
    other = DefaultContinuousModel(Unbounded(3), Unbounded(2), hiddens=(32, 16))
    other.reset_parameters(torch.Generator().manual_seed(1))
    jax.tree_util.tree_map(lambda a, b: None, to_jax_params(other), jax.device_get(params))
    with pytest.raises(ValueError):
        load_jax_params(DefaultContinuousModel(Unbounded(3), Unbounded(2), hiddens=(32, 16, 8)), jax.device_get(params))


def test_init_matches_flax_scales() -> None:
    """lecun-normal torsos and value head, small-uniform mean and log-std
    heads, zero biases, as flax initializes them."""
    model = DefaultContinuousModel(Unbounded(64), Unbounded(2), hiddens=(256, 256))
    model.reset_parameters(torch.Generator().manual_seed(0))
    w = model.latent_model.layers[1].weight.detach()
    assert abs(float(w.std()) - 256**-0.5) < 0.05 * 256**-0.5
    for head in (model.action_mean, model.action_log_std):
        assert 0 < float(head.weight.detach().abs().max()) <= 1e-3
    assert abs(float(model.vf_head.weight.detach().std()) - 256**-0.5) < 0.3 * 256**-0.5
    heads = (model.action_mean, model.action_log_std, model.vf_head)
    assert all(float(m.bias.detach().abs().max()) == 0 for m in heads)
    assert sum(p.numel() for p in DefaultContinuousModel(Unbounded(1), Unbounded(1)).parameters()) == 133379


def test_distmath_matches_jax() -> None:
    """normal_per_dim_logp, squashed_normal_logp (with its strict gate)
    and deterministic sample_continuous_actions, plain math in both."""
    rng, feats = _features(B=64, A=2, seed=2)
    mean, log_std = feats["mean"], feats["log_std"]
    inv_var = np.exp(-2 * log_std).astype(np.float32)
    diff = (rng.normal(size=(64, 2)) * 4).astype(np.float32)
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    np.testing.assert_allclose(
        tdm.normal_per_dim_logp(t(diff), t(log_std), t(inv_var)).numpy(),
        np.asarray(jdm.normal_per_dim_logp(diff, log_std, inv_var)), rtol=RTOL, atol=ATOL,
    )
    actions = np.tanh(np.clip(rng.normal(size=(64, 2)), -SQUASH_LIMIT, SQUASH_LIMIT)).astype(np.float32)
    actions[:8] = np.sign(actions[:8])
    got = tdm.squashed_normal_logp(t(actions), t(mean), t(log_std), t(inv_var))
    want = jdm.squashed_normal_logp(jnp.asarray(actions), mean, log_std, inv_var)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=LOGP_ATOL)
    assert 0 < float((got[2] == 0).sum()) < got[2].numel()  # some rows clamped, not all
    pre = np.arctanh(log_std).astype(np.float32)
    for squashed in (False, True):
        a, lp = tdm.sample_continuous_actions(t(mean), t(pre), True, squashed)
        ja, jlp = jdm.sample_continuous_actions(jnp.asarray(mean), jnp.asarray(pre), True, squashed)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=RTOL, atol=ATOL)
        keep = np.abs(mean).max(1) < SQUASH_LIMIT
        np.testing.assert_allclose(lp.numpy()[keep], np.asarray(jlp)[keep], rtol=RTOL, atol=LOGP_ATOL)


def test_philox_normal_is_box_muller_on_philox_words() -> None:
    """Words 0 and 1 of Philox at counter (row, dim, 0, 1), each made a
    uniform from its top 23 bits (clamped to 1e-7), through Box-Muller; a
    row's draws do not depend on how many rows are drawn."""
    z = philox_normal(7, 11, 1000, 4)
    assert z.shape == (1000, 4) and z.dtype == torch.float32
    assert torch.equal(philox_normal(7, 11, 10, 4), z[:10])
    assert not torch.equal(philox_normal(7, 12, 10, 4), z[:10])
    for (r, d), got in zip(np.ndindex(3, 4), z[:3].flatten().tolist()):
        ctr = tuple(torch.tensor([x], dtype=torch.int64) for x in (r, d, 0, 1))
        w0, w1 = (int(w) for w in philox4x32(ctr, (7, 11))[:2])
        u1, u2 = (np.float32(max((w >> 9) / 2**23, np.float32(1e-7))) for w in (w0, w1))
        want = np.sqrt(np.float32(-2) * np.log(u1)) * np.cos(np.float32(tdm.TWO_PI) * u2)
        assert got == pytest.approx(float(want), rel=1e-6, abs=1e-6)
    zz = z.double()
    assert abs(float(zz.mean())) < 5 / np.sqrt(4000) and abs(float(zz.var()) - 1) < 5 * np.sqrt(2 / 4000)


def _flax_dist(jmodel, params, obs, jcls):
    feats, values = jmodel.apply({"params": params}, {"obs": jnp.asarray(obs)})
    return jcls(feats), np.asarray(values)


@pytest.mark.parametrize("kind,jcls", [("normal", JNormal), ("squashed", JSquashedNormal)])
def test_act_plain_deterministic_matches_flax(kind: str, jcls) -> None:
    jmodel, params, model, rng = _setup(A=3)
    obs = rng.normal(size=(64, 3)).astype(np.float32)
    packed = pack_act_params(model, squashed=kind == "squashed")
    assert packed.kind == kind and packed.policy_heads == (3, 3)
    actions, logp, values = act_plain(packed, torch.from_numpy(obs), (0, 0), deterministic=True)
    jdist, jvalues = _flax_dist(jmodel, params, obs, jcls)
    assert actions.dtype == torch.float32 and actions.shape == (64, 3)
    np.testing.assert_allclose(actions.numpy(), np.asarray(jdist.deterministic_sample()), rtol=RTOL, atol=ATOL)
    keep = np.abs(np.asarray(jdist.features["mean"])).max(1) < SQUASH_LIMIT
    assert keep.mean() > 0.25
    np.testing.assert_allclose(
        logp.numpy()[keep], np.asarray(jdist.logp(jnp.asarray(actions.numpy())))[keep], rtol=RTOL, atol=LOGP_ATOL
    )
    np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind,jcls", [("normal", JNormal), ("squashed", JSquashedNormal)])
def test_act_plain_stochastic_logp_matches_jax(kind: str, jcls) -> None:
    """Philox-keyed draws: the port's log-probs against rl8_tpu's logp of
    the port's own actions, and the draws are the kernel's Box-Muller
    noise on the tanh-bounded std."""
    jmodel, params, model, rng = _setup(A=2, seed=3)
    obs = rng.normal(size=(256, 3)).astype(np.float32)
    packed = pack_act_params(model, squashed=kind == "squashed")
    actions, logp, _ = act_plain(packed, torch.from_numpy(obs), (5, 6), deterministic=False)
    jdist, _ = _flax_dist(jmodel, params, obs, jcls)
    feats = jdist.features
    x = np.asarray(feats["mean"]) + np.exp(np.asarray(feats["log_std"])) * philox_normal(5, 6, 256, 2).numpy()
    keep = np.abs(x).max(1) < SQUASH_LIMIT
    assert keep.mean() > 0.25
    np.testing.assert_allclose(
        logp.numpy()[keep], np.asarray(jdist.logp(jnp.asarray(actions.numpy())))[keep], rtol=RTOL, atol=LOGP_ATOL
    )
    np.testing.assert_allclose(actions.numpy(), np.tanh(x) if kind == "squashed" else x, rtol=1e-4, atol=1e-5)
    assert fused_act(packed, torch.from_numpy(obs), (5, 6))[0].dtype == torch.float32


@pytest.mark.parametrize("kind", KINDS)
def test_act_plain_with_injected_noise_matches_numpy(kind: str) -> None:
    jmodel, params, model, rng = _setup(A=2, seed=4)
    obs = rng.normal(size=(64, 3)).astype(np.float32)
    noise = rng.normal(size=(64, 2)).astype(np.float32)
    feats, _ = jmodel.apply({"params": params}, {"obs": jnp.asarray(obs)})
    mean, log_std = (np.asarray(feats[k], np.float64) for k in ("mean", "log_std"))
    x = mean + np.exp(log_std) * noise
    per = -0.5 * (x - mean) ** 2 * np.exp(-2 * log_std) - log_std - 0.5 * np.log(2 * np.pi)
    want_logp = per.sum(1)
    if kind == "squashed":
        x = np.tanh(x)
        want_logp = np.clip(per, -100, 100).sum(1) - np.log(1 - x**2 + tdm.SQUASH_EPS).sum(1)
    packed = pack_act_params(model, squashed=kind == "squashed")
    actions, logp, _ = act_plain(packed, torch.from_numpy(obs), (0, 0), deterministic=False, noise=torch.from_numpy(noise))
    keep = np.abs(mean + np.exp(log_std) * noise).max(1) < SQUASH_LIMIT
    np.testing.assert_allclose(actions.numpy(), x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logp.numpy()[keep, 0], want_logp[keep], rtol=1e-5, atol=1e-4)


#: The narrow model (obs dim 3, A=2, 32/16-wide torsos, 64 rows), and the
#: main path's widths (obs dim 1, A=1, twin 256-wide relu torsos, 300 rows),
#: where the card's tiled act kernel runs; there the perturbation is scaled
#: to the fan-in so that the means stay of order 1.
_ACT_KERNEL_SHAPES = {
    "narrow": dict(setup=dict(A=2, seed=5), rows=64, d=3),
    "main": dict(setup=dict(A=1, d=1, hiddens=(256, 256), seed=5, scale=0.3 / 4), rows=300, d=1),
}


@pytest.mark.parametrize(
    "kind,jcls,shape",
    [
        pytest.param("normal", JNormal, "narrow", id="normal-JNormal"),
        pytest.param("squashed", JSquashedNormal, "narrow", id="squashed-JSquashedNormal"),
        pytest.param("normal", JNormal, "main", id="main-width-normal"),
        pytest.param("squashed", JSquashedNormal, "main", id="main-width-squashed"),
    ],
)
def test_act_plain_deterministic_matches_pallas_act_kernel(kind: str, jcls, shape: str) -> None:
    cfg = _ACT_KERNEL_SHAPES[shape]
    jmodel, params, model, rng = _setup(**cfg["setup"])
    obs = rng.normal(size=(cfg["rows"], cfg["d"])).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ja, jl, jv = jax_fused_act(
            jmodel, params, {"obs": jnp.asarray(obs)}, jax.random.key(5),
            deterministic=True, squashed=kind == "squashed",
        )
    actions, logp, values = act_plain(
        pack_act_params(model, squashed=kind == "squashed"), torch.from_numpy(obs), (0, 0), deterministic=True
    )
    np.testing.assert_allclose(actions.numpy(), np.asarray(ja), rtol=BF16_RTOL, atol=BF16_ATOL)
    np.testing.assert_allclose(values.numpy(), np.asarray(jv), rtol=BF16_RTOL, atol=BF16_ATOL)
    # The bf16 products move the mean; compare where the squash keeps the
    # log-prob's sensitivity to it small.
    keep = np.abs(np.asarray(ja)).max(1) < 0.9
    assert keep.mean() > 0.5
    np.testing.assert_allclose(logp.numpy()[keep], np.asarray(jl)[keep], rtol=BF16_RTOL, atol=BF16_ATOL)


def test_fused_act_cpu_takes_the_plain_version_and_validates() -> None:
    _, _, model, rng = _setup()
    obs = torch.from_numpy(rng.normal(size=(16, 3)).astype(np.float32))
    before = (fused_act.launches, fused_act.continuous_launches)
    for squashed in (False, True):
        packed = pack_act_params(model, squashed=squashed)
        for det in (True, False):
            for g, w in zip(fused_act(packed, obs, (3, 4), deterministic=det),
                            act_plain(packed, obs, (3, 4), deterministic=det)):
                assert torch.equal(g, w)
    assert (fused_act.launches, fused_act.continuous_launches) == before
    with pytest.raises(ValueError, match="obs"):
        fused_act(pack_act_params(model), obs[:, :2], (0, 0))
    with pytest.raises(ValueError, match="squashed"):
        from rl8_tpu_torch.models import DefaultDiscreteModel
        from rl8_tpu_torch.specs import Discrete

        pack_act_params(DefaultDiscreteModel(Unbounded(3), Discrete(2), hiddens=(8,)), squashed=True)


@pytest.mark.parametrize("cls,jcls", DISTS)
def test_policy_sample_matches_jax(cls, jcls) -> None:
    """Policy.sample, deterministic, with Normal and SquashedNormal: the
    actions, their log-probs and the values over both view kinds."""
    jmodel, params, _, rng = _setup(A=2, seed=6)
    jpolicy = JPolicy(JUnbounded(3), JUnbounded(2), model=jmodel, distribution_cls=jcls)
    policy = Policy(Unbounded(3), Unbounded(2), model_config={"hiddens": (32, 16)}, distribution_cls=cls)
    load_jax_params(policy.model, jax.device_get(params))
    obs = rng.normal(size=(16, 4, 3)).astype(np.float32)
    for kind in ("last", "all"):
        kw = dict(kind=kind, deterministic=True, return_logp=True, return_values=True)
        jout = jpolicy.sample(params, {"obs": jnp.asarray(obs)}, **kw)
        out = policy.sample({"obs": torch.from_numpy(obs)}, **kw)
        np.testing.assert_allclose(out["actions"].numpy(), np.asarray(jout["actions"]), rtol=RTOL, atol=ATOL)
        keep = np.abs(np.asarray(jout["features"]["mean"])).max(1) < SQUASH_LIMIT
        assert keep.mean() > 0.25
        np.testing.assert_allclose(out["logp"].numpy()[keep], np.asarray(jout["logp"])[keep], rtol=RTOL, atol=LOGP_ATOL)
        np.testing.assert_allclose(out["values"].numpy(), np.asarray(jout["values"]), rtol=RTOL, atol=ATOL)
    stochastic = policy.sample({"obs": torch.from_numpy(obs)}, generator=torch.Generator().manual_seed(0))
    assert stochastic["actions"].shape == (16, 2)
