"""The recurrent update kernel's plain version
(``rl8_tpu_torch.ops.fused_rnn_ppo``) held against ``rl8_tpu`` on the CPU:
against ``jax.grad`` of ``rl8_tpu.nn.ppo_losses`` through the flax
recurrent model, against ``rl8_tpu``'s Pallas kernel in interpret mode,
and in its gating, its column layout and its wrapper's checks. The CUDA
kernel itself is held against this plain version on the card by
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
from rl8_tpu.models import DefaultContinuousRecurrentModel as JContinuous
from rl8_tpu.models import DefaultDiscreteRecurrentModel as JDiscreteModel
from rl8_tpu.nn import ppo_losses as jax_ppo_losses
from rl8_tpu.ops import pack_rows as jax_pack_rows
from rl8_tpu.ops.fused_ppo import PPOLossConfig as JPPOLossConfig
from rl8_tpu.ops.fused_rnn_ppo import fused_rnn_ppo_grads as jax_fused_rnn_ppo_grads
from rl8_tpu.ops.fused_rnn_ppo import supports_fused_rnn_update as jax_supports
from rl8_tpu.specs import Discrete as JDiscrete
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.distributions import Categorical, Normal, SquashedNormal
from rl8_tpu_torch.models import (
    DefaultContinuousRecurrentModel,
    DefaultDiscreteRecurrentModel,
    load_jax_params,
    to_jax_params,
)
from rl8_tpu_torch.ops import (
    PPOLossConfig,
    fused_rnn_ppo_grads,
    load_rnn_params,
    pack_rnn_params,
    pack_rows,
    rnn_ppo_grads_plain,
    supports_fused_rnn_update,
)
from rl8_tpu_torch.ops.fused_rnn_ppo import RnnPackedColumns
from rl8_tpu_torch.specs import Discrete, Unbounded

#: f32 on both sides, sums in another order over N * L samples and
#: through four steps of the backward: each gradient tensor by a
#: norm-relative error, the losses to f32 rounding of their means.
F32_GRAD_REL, F32_LOSS_RTOL, F32_LOSS_ATOL = 1e-5, 1e-5, 1e-6
#: Against the Pallas kernel, which multiplies in bf16: the JAX package's
#: own fused-vs-autodiff tolerances (tests/test_ops.py).
BF16_LOSS_REL, BF16_GRAD_REL = 3e-2, 0.1

N, L, D, H, ACCUM = 37, 4, 3, 12, 2
#: (entropy bonus, dual clip); SquashedNormal has no entropy.
CASES = [(False, None), (True, 3.0), (False, 3.0)]
DISTS = {"categorical": (JCategorical, Categorical), "normal": (JNormal, Normal), "squashed": (JSquashedNormal, SquashedNormal)}


def _norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _setup(kind: str, layers: int, seed: int = 0):
    """The same default recurrent model in both packages (flax-initialized,
    perturbed) and one minibatch of N ragged sequences in numpy: obs,
    stored initial states, actions (categories; normal draws; squashed
    actions in (-0.9, 0.9) with a tenth at exactly +-1), old log-probs,
    advantages and returns."""
    config = {"hidden_size": H, "num_layers": layers}
    if kind == "categorical":
        jmodel = JDiscreteModel(JUnbounded(D), JDiscrete(3, shape=(2,)), **config)
        model = DefaultDiscreteRecurrentModel(Unbounded(D), Discrete(3, shape=(2,)), **config)
    else:
        jmodel = JContinuous(JUnbounded(D), JUnbounded(2), **config)
        model = DefaultContinuousRecurrentModel(Unbounded(D), Unbounded(2), **config)
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(N, L, D)).astype(np.float32)
    states = {
        DataKeys.CELL_STATES: rng.normal(size=(N, layers, H)).astype(np.float32),
        DataKeys.HIDDEN_STATES: (0.5 * rng.normal(size=(N, layers, H))).astype(np.float32),
    }
    params = jax.device_get(
        jmodel.init(jax.random.key(seed), {DataKeys.OBS: jnp.asarray(obs)}, jax.tree_util.tree_map(jnp.asarray, states))["params"]
    )
    params = jax.tree_util.tree_map(lambda p: p + 0.2 * rng.normal(size=p.shape).astype(np.float32), params)
    load_jax_params(model, params)
    if kind == "categorical":
        actions = rng.integers(0, 3, size=(N, L, 2)).astype(np.int32)
    elif kind == "normal":
        actions = rng.normal(size=(N, L, 2)).astype(np.float32)
    else:
        actions = rng.uniform(-0.9, 0.9, size=(N, L, 2)).astype(np.float32)
        edge = rng.uniform(size=(N, L, 2)) < 0.1
        actions = np.where(edge, np.sign(actions), actions).astype(np.float32)
    batch = {
        DataKeys.ACTIONS: actions,
        DataKeys.ADVANTAGES: rng.normal(size=(N, L, 1)).astype(np.float32),
        DataKeys.LOGP: (0.1 * rng.normal(size=(N, L, 1)) - 1.5).astype(np.float32),
        DataKeys.OBS: obs,
        DataKeys.RETURNS: rng.normal(size=(N, L, 1)).astype(np.float32),
        DataKeys.STATES: states,
    }
    return jmodel, jax.tree_util.tree_map(jnp.asarray, params), model, batch


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}


def _cfg(kind: str, use_entropy: bool, dual, cls=PPOLossConfig):
    return cls(
        clip_param=0.2, vf_clip_param=1.5, vf_coeff=0.9, dual_clip_param=dual, n_rows=N, accum=ACCUM,
        use_entropy=use_entropy, squashed=kind == "squashed",
    )


def _port_grads(model, batch, kind: str, use_entropy: bool, dual):
    """The plain version's losses, KL and gradients, the gradients in the
    flax tree's layout."""
    params = pack_rnn_params(model, squashed=kind == "squashed")
    packed, unpack = pack_rows(_torch_tree(batch))
    ec = torch.tensor(0.013 if use_entropy else 0.0)
    losses, kl, flat = rnn_ppo_grads_plain(params, packed, unpack, ec, _cfg(kind, use_entropy, dual))
    grad_model = type(model)(model.observation_spec, model.action_spec, hidden_size=H, num_layers=model.num_layers)
    load_rnn_params(grad_model, flat)
    return losses, kl, to_jax_params(grad_model)


def _cases():
    for kind in DISTS:
        for use_entropy, dual in CASES:
            if kind == "squashed" and use_entropy:
                continue
            yield pytest.param(kind, use_entropy, dual, id=f"{kind}-{'ent' if use_entropy else 'noent'}-{'dual' if dual else 'nodual'}")


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("kind,use_entropy,dual", list(_cases()))
def test_plain_matches_jax_autodiff(kind: str, use_entropy: bool, dual, layers: int) -> None:
    """Losses, KL and every gradient against ``jax.grad`` of
    ``ppo_losses(...)["total"] / accum`` through the flax recurrent model
    over the N * L samples (``rl8_tpu``'s CPU path), in f32."""
    jmodel, params, model, batch = _setup(kind, layers, seed=layers)
    ec = 0.013 if use_entropy else 0.0
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jdist_cls = DISTS[kind][0]

    def loss_fn(p):
        (f, v), _ = jmodel.apply({"params": p}, {DataKeys.OBS: jbatch[DataKeys.OBS]}, jbatch[DataKeys.STATES])
        dist = jdist_cls(f, jmodel)
        flat = {
            k: jbatch[k].reshape(-1, *jbatch[k].shape[2:])
            for k in (DataKeys.ACTIONS, DataKeys.LOGP, DataKeys.ADVANTAGES, DataKeys.RETURNS)
        }
        losses = jax_ppo_losses(
            flat, v, dist, clip_param=0.2, dual_clip_param=dual, entropy_coeff=ec, vf_clip_param=1.5, vf_coeff=0.9
        )
        lr = dist.logp(flat[DataKeys.ACTIONS]) - flat[DataKeys.LOGP]
        return losses["total"] / ACCUM, (losses, jnp.mean((jnp.exp(lr) - 1) - lr))

    (_, (ref_losses, ref_kl)), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    losses, kl, grads = _port_grads(model, batch, kind, use_entropy, dual)
    for k in ("entropy", "policy", "vf", "total"):
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL, err_msg=k)
    np.testing.assert_allclose(float(kl), float(ref_kl), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL)
    for path, ref in jax.tree_util.tree_leaves_with_path(ref_grads):
        got = grads
        for key in path:
            got = got[key.key]
        assert _norm_rel(got, ref) < F32_GRAD_REL, (jax.tree_util.keystr(path), _norm_rel(got, ref))


@pytest.mark.parametrize("kind,use_entropy,dual", [("categorical", True, 3.0), ("normal", False, None), ("squashed", False, 3.0)])
def test_plain_matches_pallas_kernel_interpret(kind: str, use_entropy: bool, dual) -> None:
    """Against ``rl8_tpu``'s recurrent update kernel in interpret mode
    (two layers): it multiplies in bf16, hence bf16 tolerances."""
    jmodel, params, model, batch = _setup(kind, layers=2, seed=5)
    ec = 0.013 if use_entropy else 0.0
    jpacked, junpack = jax_pack_rows(jax.tree_util.tree_map(jnp.asarray, batch))
    ref_losses, ref_kl, ref_grads = jax_fused_rnn_ppo_grads(
        jmodel, params, jpacked, junpack, ec, _cfg(kind, use_entropy, dual, JPPOLossConfig), interpret=True
    )
    losses, kl, grads = _port_grads(model, batch, kind, use_entropy, dual)
    for k in ("entropy", "policy", "vf", "total"):
        a, b = float(ref_losses[k]), float(losses[k])
        assert abs(a - b) < BF16_LOSS_REL * (abs(a) + 1e-2), (k, a, b)
    assert abs(float(ref_kl) - float(kl)) < BF16_LOSS_REL * (abs(float(ref_kl)) + 1e-2)
    for path, ref in jax.tree_util.tree_leaves_with_path(ref_grads):
        got = grads
        for key in path:
            got = got[key.key]
        assert _norm_rel(got, ref) < BF16_GRAD_REL, (jax.tree_util.keystr(path), _norm_rel(got, ref))


def test_columns_match_jax() -> None:
    """The packed sequence batch has the same columns in both packages,
    and the kernel reads each leaf's span from the unpacker."""
    _, _, model, batch = _setup("categorical", layers=2)
    jpacked, junpack = jax_pack_rows(jax.tree_util.tree_map(jnp.asarray, batch))
    packed, unpack = pack_rows(_torch_tree(batch))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    cols = RnnPackedColumns.from_unpacker(unpack)
    idx = junpack.leaf_index_tree()
    span = lambda i: (junpack.metas[i].start, junpack.metas[i].stop)  # noqa: E731
    assert cols.obs == span(idx[DataKeys.OBS]) and cols.actions == span(idx[DataKeys.ACTIONS])
    assert cols.hidden == span(idx[DataKeys.STATES][DataKeys.HIDDEN_STATES])
    assert cols.cell == span(idx[DataKeys.STATES][DataKeys.CELL_STATES])
    assert (cols.logp, cols.advantages, cols.returns) == tuple(
        span(idx[k]) for k in (DataKeys.LOGP, DataKeys.ADVANTAGES, DataKeys.RETURNS)
    )
    assert cols.seq_len == L and packed.shape[1] == L * 2 + 3 * L + L * D + 2 * 2 * H


def test_gating_matches_jax() -> None:
    """``supports_fused_rnn_update`` agrees with ``rl8_tpu``'s on the
    family, distribution, entropy, depth and observation-dtype gates, and
    on its VMEM residency term (H up to 1617 at these shapes, or a
    narrower head), which the port takes as its route; the card kernels'
    own limits are asked of them by ``card_takes_rnn_update`` and
    ``card_takes_rnn_act``."""
    from rl8_tpu.distributions import Categorical as JCat

    def pair(continuous: bool, obs_dtype=(jnp.float32, torch.float32), n: int = 3, **config):
        if continuous:
            return (
                JContinuous(JUnbounded(3, dtype=obs_dtype[0]), JUnbounded(2), **config),
                DefaultContinuousRecurrentModel(Unbounded(3, dtype=obs_dtype[1]), Unbounded(2), **config),
            )
        return (
            JDiscreteModel(JUnbounded(3, dtype=obs_dtype[0]), JDiscrete(n, shape=(1,)), **config),
            DefaultDiscreteRecurrentModel(Unbounded(3, dtype=obs_dtype[1]), Discrete(n, shape=(1,)), **config),
        )

    cases = [
        (pair(False), "categorical", False),
        (pair(False), "normal", False),
        (pair(True), "normal", False),
        (pair(True), "squashed", False),
        (pair(True), "squashed", True),
        (pair(True), "categorical", False),
        (pair(False, num_layers=2), "categorical", False),
        (pair(False, num_layers=8), "categorical", False),
        (pair(False, num_layers=9), "categorical", False),
        (pair(False, obs_dtype=(jnp.int32, torch.int32)), "categorical", False),
        (pair(False, n=1000), "categorical", False),
        (pair(False, hidden_size=384), "categorical", False),
        (pair(False, hidden_size=1024), "categorical", False),
    ]
    for (jmodel, model), kind, zero_entropy in cases:
        jdist, dist = DISTS[kind]
        want = jax_supports(jmodel, jdist, zero_entropy=zero_entropy)
        assert supports_fused_rnn_update(model, dist, zero_entropy=zero_entropy) == want, (type(model).__name__, kind)
    for jmodel, model in (pair(False, hidden_size=2048), pair(False, n=40000)):
        assert not jax_supports(jmodel, JCat) and not supports_fused_rnn_update(model, Categorical)
    no_bias = DefaultDiscreteRecurrentModel(Unbounded(3), Discrete(3), bias=False)
    assert not supports_fused_rnn_update(no_bias, Categorical)

    class Custom(DefaultDiscreteRecurrentModel):
        pass

    assert not supports_fused_rnn_update(Custom(Unbounded(3), Discrete(3)), Categorical)


def test_wrapper_on_cpu_runs_plain_and_validates() -> None:
    _, _, model, batch = _setup("normal", layers=2, seed=9)
    params = pack_rnn_params(model)
    packed, unpack = pack_rows(_torch_tree(batch))
    cfg = _cfg("normal", True, 3.0)
    ec = torch.tensor(0.013)
    before = (fused_rnn_ppo_grads.launches, fused_rnn_ppo_grads.continuous_launches)
    got = fused_rnn_ppo_grads(params, packed, unpack, ec, cfg)
    want = rnn_ppo_grads_plain(params, packed, unpack, ec, cfg)
    assert (fused_rnn_ppo_grads.launches, fused_rnn_ppo_grads.continuous_launches) == before  # no kernel on the CPU
    assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
    assert all(torch.equal(got[0][k], want[0][k]) for k in want[0])
    assert got[2].shape == params.flat.shape
    with pytest.raises(ValueError, match="n_rows"):
        fused_rnn_ppo_grads(params, packed[:10], unpack, ec, cfg)
    with pytest.raises(ValueError, match="int32"):
        fused_rnn_ppo_grads(params, packed.float(), unpack, ec, cfg)
    with pytest.raises(ValueError, match="0-d"):
        fused_rnn_ppo_grads(params, packed, unpack, torch.tensor([0.013]), cfg)
    with pytest.raises(ValueError, match="obs"):
        fused_rnn_ppo_grads(type(params)(**{**params.__dict__, "d_in": 2}), packed, unpack, ec, cfg)
    with pytest.raises(ValueError, match="hidden states"):
        fused_rnn_ppo_grads(type(params)(**{**params.__dict__, "hidden": 8}), packed, unpack, ec, cfg)
    with pytest.raises(ValueError, match="squashed"):
        fused_rnn_ppo_grads(params, packed, unpack, ec, _cfg("squashed", False, None))
    with pytest.raises(ValueError, match="no defined entropy"):
        fused_rnn_ppo_grads(type(params)(**{**params.__dict__, "kind": "squashed"}), packed, unpack, ec,
                            _cfg("squashed", True, None))
    with pytest.raises(ValueError, match="one device"):
        fused_rnn_ppo_grads(params, packed.to("meta"), unpack, ec, cfg)
