"""The continuous update's plain version (``ppo_grads_plain`` for
``Normal`` and ``SquashedNormal``) held against ``rl8_tpu`` on the CPU:
against ``jax.grad`` of ``rl8_tpu.nn.ppo_losses`` through the flax model,
and against ``rl8_tpu``'s Pallas ``_continuous_kernel`` in interpret mode.
The CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl8_tpu.distributions import Categorical as JCategorical
from rl8_tpu.distributions import Normal as JNormal
from rl8_tpu.distributions import SquashedNormal as JSquashedNormal
from rl8_tpu.models import DefaultContinuousModel as JModel
from rl8_tpu.models import DefaultDiscreteModel as JDiscreteModel
from rl8_tpu.nn import ppo_losses as jax_ppo_losses
from rl8_tpu.ops import pack_rows as jax_pack_rows
from rl8_tpu.ops.fused_ppo import PPOLossConfig as JPPOLossConfig
from rl8_tpu.ops.fused_ppo import fused_ppo_grads as jax_fused_ppo_grads
from rl8_tpu.ops.fused_ppo import supports_fused_update as jax_supports_fused_update
from rl8_tpu.specs import Discrete as JDiscrete
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu_torch import AlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.distributions import Categorical, Normal, SquashedNormal
from rl8_tpu_torch.env import ContinuousDummyEnv, DiscreteDummyEnv
from rl8_tpu_torch.models import DefaultContinuousModel, DefaultDiscreteModel, load_jax_params, to_jax_params
from rl8_tpu_torch.nn import ppo_losses
from rl8_tpu_torch.ops import PPOLossConfig, fused_ppo_grads, pack_act_params, pack_rows, ppo_grads_plain, supports_fused_update
from rl8_tpu_torch.ops.distmath import squashed_normal_logp
from rl8_tpu_torch.ops.fused_mlp import load_flat_params
from rl8_tpu_torch.specs import Discrete, Unbounded

#: f32 on both sides, sums in another order: each gradient within 1e-5 of
#: its norm, the losses to rtol 1e-5 (atol 1e-6 for near-zero means).
F32_GRAD_REL, F32_LOSS_RTOL, F32_LOSS_ATOL = 1e-5, 1e-5, 1e-6
#: Against the Pallas kernel, which multiplies the hidden layers in bf16:
#: the discrete update test's tolerances (tests/test_torch_update.py).
BF16_LOSS_REL, BF16_GRAD_REL = 2e-2, 8e-2

N, ACCUM, A, D = 53, 3, 2, 3
#: (distribution, entropy coefficient, dual clip).
CASES = [("normal", 0.0, None), ("normal", 0.013, 3.0), ("squashed", 0.0, None), ("squashed", 0.0, 3.0)]
IDS = ["normal", "normal-entropy-dual", "squashed", "squashed-dual"]


def _norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _jdist(kind: str):
    return JSquashedNormal if kind == "squashed" else JNormal


def _setup(kind: str, hiddens=(32, 16), activation: str = "relu", seed: int = 0, clip_rows: int = 0, log_std_bias: float = 0.0):
    """The same continuous model in both packages, flax-initialized and
    perturbed, and one minibatch of numpy inputs: actions drawn from the
    model's own distribution (squashed ones clipped to |x| <= 2 before the
    tanh, where the log-prob is well-conditioned), old log-probs near the
    model's own, so that ratios lie around 1 on both sides of the clip.
    ``clip_rows`` rows get squashed actions of exactly +-1."""
    jmodel = JModel(JUnbounded(D), JUnbounded(A), hiddens=hiddens, activation_fn=activation)
    params = jmodel.init(jax.random.key(seed), {"obs": jnp.zeros((1, D))})["params"]
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(np.float32)) for p in leaves]
    )
    params["action_log_std"]["bias"] = params["action_log_std"]["bias"] + log_std_bias
    model = DefaultContinuousModel(Unbounded(D), Unbounded(A), hiddens=hiddens, activation_fn=activation)
    load_jax_params(model, jax.device_get(params))
    obs = rng.normal(size=(N, D)).astype(np.float32)
    feats, _ = jmodel.apply({"params": params}, {"obs": jnp.asarray(obs)})
    mean, log_std = np.asarray(feats["mean"]), np.asarray(feats["log_std"])
    x = mean + np.exp(log_std) * rng.normal(size=(N, A)).astype(np.float32)
    if kind == "squashed":
        actions = np.tanh(np.clip(x, -2.0, 2.0)).astype(np.float32)
        actions[:clip_rows] = np.sign(rng.normal(size=(clip_rows, A)))
    else:
        actions = x.astype(np.float32)
    logp = np.asarray(_jdist(kind)(feats).logp(jnp.asarray(actions)))
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


def _loss_kw(dual):
    return dict(clip_param=0.2, dual_clip_param=dual, vf_clip_param=1.5, vf_coeff=0.9)


def _cfg(kind: str, ec: float, dual) -> PPOLossConfig:
    return PPOLossConfig(
        clip_param=0.2, vf_clip_param=1.5, vf_coeff=0.9, dual_clip_param=dual,
        n_rows=N, accum=ACCUM, use_entropy=ec != 0.0, squashed=kind == "squashed",
    )


def _port_grads(model, batch, kind: str, ec: float, dual):
    params = pack_act_params(model, squashed=kind == "squashed")
    packed, unpack = pack_rows(_torch_tree(batch))
    losses, kl, flat = ppo_grads_plain(params, packed, unpack, torch.tensor(ec), _cfg(kind, ec, dual))
    grad_model = DefaultContinuousModel(
        model.observation_spec, model.action_spec, hiddens=model.hiddens, activation_fn=model.activation_fn
    )
    load_flat_params(grad_model, flat)
    return losses, kl, to_jax_params(grad_model)


def _jax_autodiff(jmodel, params, batch, kind: str, ec: float, dual):
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        f, v = jmodel.apply({"params": p}, jbatch[DataKeys.VIEWS])
        dist = _jdist(kind)(f, jmodel)
        losses = jax_ppo_losses(jbatch, v, dist, entropy_coeff=ec, **_loss_kw(dual))
        lr = dist.logp(jbatch[DataKeys.ACTIONS]) - jbatch[DataKeys.LOGP]
        return losses["total"] / ACCUM, (losses, jnp.mean((jnp.exp(lr) - 1) - lr))

    (_, (losses, kl)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return losses, kl, grads


def _assert_grads(grads, ref_grads, tol: float) -> None:
    for path, ref in jax.tree_util.tree_leaves_with_path(ref_grads):
        got = grads
        for key in path:
            got = got[key.key]
        assert _norm_rel(got, ref) < tol, jax.tree_util.keystr(path)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
@pytest.mark.parametrize("kind,ec,dual", CASES, ids=IDS)
def test_plain_matches_jax_autodiff(kind: str, ec: float, dual, activation: str) -> None:
    """Losses, KL and every gradient against ``jax.grad`` of
    ``ppo_losses(...)["total"] / accum`` through the flax model, in f32."""
    jmodel, params, model, batch = _setup(kind, activation=activation)
    ref_losses, ref_kl, ref_grads = _jax_autodiff(jmodel, params, batch, kind, ec, dual)
    losses, kl, grads = _port_grads(model, batch, kind, ec, dual)
    for k in ("entropy", "policy", "vf", "total"):
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL, err_msg=k)
    np.testing.assert_allclose(float(kl), float(ref_kl), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL)
    _assert_grads(grads, ref_grads, F32_GRAD_REL)


def test_clamp_gate_matches_jax_autodiff() -> None:
    """Rows whose squashed actions sit at +-1 with a small std have base
    log-probs below -100: the clamp cuts their mean and log-std gradients
    (both packages), and the rest still match ``jax.grad``."""
    jmodel, params, model, batch = _setup("squashed", seed=1, clip_rows=20, log_std_bias=-2.0)
    feats, _ = jmodel.apply({"params": params}, {"obs": jnp.asarray(batch[DataKeys.VIEWS][DataKeys.OBS])})
    t = {k: torch.from_numpy(np.array(v)) for k, v in feats.items()}
    _, _, gate = squashed_normal_logp(
        torch.from_numpy(batch[DataKeys.ACTIONS]), t["mean"], t["log_std"], torch.exp(-2.0 * t["log_std"])
    )
    cut_rows = (gate == 0).all(dim=1)
    assert int(cut_rows.sum()) >= 15  # most of the clipped rows are cut in every dim
    ref_losses, ref_kl, ref_grads = _jax_autodiff(jmodel, params, batch, "squashed", 0.0, None)
    losses, kl, grads = _port_grads(model, batch, "squashed", 0.0, None)
    for k in ("policy", "vf", "total"):
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL, err_msg=k)
    _assert_grads(grads, ref_grads, F32_GRAD_REL)
    # Cut rows contribute nothing to the policy heads: dropping them from
    # the batch (and rescaling the mean) leaves those gradients unchanged.
    keep = ~cut_rows.numpy()
    n_keep = int(keep.sum())
    cut_batch = jax.tree_util.tree_map(lambda x: x[keep], batch)
    params_t = pack_act_params(model, squashed=True)
    packed, unpack = pack_rows(_torch_tree(cut_batch))
    cfg = PPOLossConfig(clip_param=0.2, vf_clip_param=1.5, vf_coeff=0.9, dual_clip_param=None,
                        n_rows=n_keep, accum=ACCUM, use_entropy=False, squashed=True)
    _, _, cut = ppo_grads_plain(params_t, packed, unpack, torch.tensor(0.0), cfg)
    full = pack_act_params(model, squashed=True)
    _, _, whole = ppo_grads_plain(full, *pack_rows(_torch_tree(batch)), torch.tensor(0.0), _cfg("squashed", 0.0, None))
    for got, want in zip(full.__class__(**{**full.__dict__, "flat": cut * (n_keep / N)}).chains()[0][1],
                         full.__class__(**{**full.__dict__, "flat": whole}).chains()[0][1]):
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("kind,ec,dual", CASES, ids=IDS)
def test_plain_matches_pallas_kernel_interpret(kind: str, ec: float, dual) -> None:
    """Against ``rl8_tpu``'s ``_continuous_kernel`` run in interpret mode:
    it multiplies the hidden layers in bf16, hence bf16 tolerances."""
    jmodel, params, model, batch = _setup(kind)
    jpacked, junpack = jax_pack_rows(jax.tree_util.tree_map(jnp.asarray, batch))
    jcfg = JPPOLossConfig(
        clip_param=0.2, vf_clip_param=1.5, vf_coeff=0.9, dual_clip_param=dual,
        n_rows=N, accum=ACCUM, use_entropy=ec != 0.0, squashed=kind == "squashed",
    )
    ref_losses, ref_kl, ref_grads = jax_fused_ppo_grads(jmodel, params, jpacked, junpack, ec, jcfg, interpret=True)
    losses, kl, grads = _port_grads(model, batch, kind, ec, dual)
    for k in ("entropy", "policy", "vf", "total"):
        a, b = float(ref_losses[k]), float(losses[k])
        assert abs(a - b) < BF16_LOSS_REL * (abs(a) + 1e-2), (k, a, b)
    assert abs(float(ref_kl) - float(kl)) < BF16_LOSS_REL * (abs(float(ref_kl)) + 1e-2)
    _assert_grads(grads, ref_grads, BF16_GRAD_REL)


@pytest.mark.parametrize("kind,ec,dual", CASES, ids=IDS)
def test_plain_matches_torch_autograd(kind: str, ec: float, dual) -> None:
    """The hand-derived backward against ``torch.autograd`` through the
    port's own distributions and ``ppo_losses`` (f32, the same ATen
    products)."""
    _, _, model, batch = _setup(kind, seed=2)
    losses, kl, grads = _port_grads(model, batch, kind, ec, dual)
    tbatch = _torch_tree(batch)
    features, values = model(tbatch[DataKeys.VIEWS])
    dist = (SquashedNormal if kind == "squashed" else Normal)(features)
    ref = ppo_losses(tbatch, values, dist, entropy_coeff=ec, **_loss_kw(dual))
    (ref["total"] / ACCUM).backward()
    for k in ref:
        np.testing.assert_allclose(float(losses[k]), float(ref[k].detach()), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL, err_msg=k)
    ref_grads = {
        name: {"kernel": linear.weight.grad.t().numpy(), "bias": linear.bias.grad.numpy()}
        for name, linear in (("action_mean", model.action_mean), ("action_log_std", model.action_log_std),
                             ("vf_head", model.vf_head))
    }
    for torso in ("latent_model", "vf_model"):
        for i, layer in enumerate(getattr(model, torso).layers):
            ref_grads.setdefault(torso, {})[f"Dense_{i}"] = {
                "kernel": layer.weight.grad.t().numpy(), "bias": layer.bias.grad.numpy()
            }
    _assert_grads(grads, ref_grads, F32_GRAD_REL)


def test_wrapper_on_cpu_runs_plain_and_validates() -> None:
    _, _, model, batch = _setup("squashed")
    params = pack_act_params(model, squashed=True)
    packed, unpack = pack_rows(_torch_tree(batch))
    cfg = _cfg("squashed", 0.0, None)
    ec = torch.tensor(0.0)
    before = (fused_ppo_grads.launches, fused_ppo_grads.continuous_launches)
    got = fused_ppo_grads(params, packed, unpack, ec, cfg)
    want = ppo_grads_plain(params, packed, unpack, ec, cfg)
    assert (fused_ppo_grads.launches, fused_ppo_grads.continuous_launches) == before
    assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="no defined entropy"):
        fused_ppo_grads(params, packed, unpack, torch.tensor(0.01), _cfg("squashed", 0.01, None))
    with pytest.raises(ValueError, match="squashed"):
        fused_ppo_grads(pack_act_params(model), packed, unpack, ec, cfg)
    with pytest.raises(ValueError, match="actions"):
        narrow = params.__class__(**{**params.__dict__, "action_dim": 3})
        fused_ppo_grads(narrow, packed, unpack, ec, cfg)


def test_supports_fused_update_gating_matches_jax() -> None:
    """The port's gating is the JAX package's (tests/test_ops.py)."""
    pairs = [
        (DefaultDiscreteModel(Unbounded(3), Discrete(4, shape=(1,))), JDiscreteModel(JUnbounded(3), JDiscrete(4, shape=(1,)))),
        (DefaultContinuousModel(Unbounded(3), Unbounded(2)), JModel(JUnbounded(3), JUnbounded(2))),
    ]
    dists = [(Categorical, JCategorical), (Normal, JNormal), (SquashedNormal, JSquashedNormal)]
    for model, jmodel in pairs:
        for (dist, jdist) in dists:
            for zero in (False, True):
                assert supports_fused_update(model, dist, zero_entropy=zero) == jax_supports_fused_update(
                    jmodel, jdist, zero_entropy=zero
                ), (type(model).__name__, dist.__name__, zero)
    cont = pairs[1][0]
    assert supports_fused_update(cont, Normal)
    assert not supports_fused_update(cont, SquashedNormal)
    assert supports_fused_update(cont, SquashedNormal, zero_entropy=True)


@pytest.mark.parametrize(
    "env,kw",
    [
        (ContinuousDummyEnv, {"distribution_cls": SquashedNormal, "entropy_coeff": 0.01}),
        (ContinuousDummyEnv, {"distribution_cls": SquashedNormal, "entropy_coeff_schedule": [(0, 0.0)]}),
        (DiscreteDummyEnv, {"distribution_cls": Normal}),
        (ContinuousDummyEnv, {"distribution_cls": Categorical}),
    ],
    ids=["squashed-entropy", "squashed-schedule", "normal-on-discrete", "categorical-on-continuous"],
)
def test_unsupported_pairs_raise(env, kw: dict) -> None:
    with pytest.raises(NotImplementedError):
        AlgorithmConfig(num_envs=4, horizon=2, model_config={"hiddens": (8,)}, device="cpu", **kw).build(env)


@pytest.mark.parametrize("dist", [None, Normal, SquashedNormal])
def test_supported_continuous_pairs_build(dist) -> None:
    algo = AlgorithmConfig(num_envs=4, horizon=2, model_config={"hiddens": (8,)}, device="cpu",
                           distribution_cls=dist).build(ContinuousDummyEnv)
    assert algo.policy.distribution_cls is (dist or Normal)
    assert algo._squashed_dist == (dist is SquashedNormal)
    assert algo.state.buffer[DataKeys.ACTIONS].dtype == torch.float32
