"""The port's model, distribution and policy held against ``rl8_tpu`` on
the CPU, with the JAX parameters carried across by ``load_jax_params``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl8_tpu.distributions import Categorical as JCategorical
from rl8_tpu.models import DefaultDiscreteModel as JModel
from rl8_tpu.policies import Policy as JPolicy
from rl8_tpu.specs import Discrete as JDiscrete
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu_torch.distributions import Categorical
from rl8_tpu_torch.models import DefaultDiscreteModel, load_jax_params
from rl8_tpu_torch.policies import Policy
from rl8_tpu_torch.specs import Discrete, Unbounded

#: f32 on both sides; the products of a 32-wide layer are summed in
#: another order by XLA and ATen, a few ulps of values of order 1-10.
ATOL = 1e-5


def _jax_model_and_params(A: int, n: int, d: int = 3, hiddens=(32, 16), seed: int = 0):
    model = JModel(JUnbounded(d), JDiscrete(n, shape=(A,)), hiddens=hiddens)
    obs = jnp.zeros((1, d))
    params = model.init(jax.random.key(seed), {"obs": obs})["params"]
    # Perturb every parameter so the small-init heads give logits far
    # from uniform.
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [
        np.asarray(p) + 0.3 * rng.normal(size=p.shape).astype(np.float32) for p in leaves
    ]
    params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(p) for p in leaves])
    return model, params


def _port_model(A: int, n: int, params, d: int = 3, hiddens=(32, 16)) -> DefaultDiscreteModel:
    model = DefaultDiscreteModel(Unbounded(d), Discrete(n, shape=(A,)), hiddens=hiddens)
    return load_jax_params(model, jax.device_get(params))


@pytest.mark.parametrize("A,n", [(1, 2), (2, 3)])
def test_forward_matches_flax(A: int, n: int) -> None:
    jmodel, params = _jax_model_and_params(A, n)
    model = _port_model(A, n, params)
    obs = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32) * 5
    jfeat, jval = jmodel.apply({"params": params}, {"obs": jnp.asarray(obs)})
    with torch.no_grad():
        feat, val = model({"obs": torch.from_numpy(obs)})
    assert feat["logits"].shape == (64, A, n)
    np.testing.assert_allclose(feat["logits"].numpy(), np.asarray(jfeat["logits"]), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-5, atol=ATOL)


def test_load_jax_params_rejects_mismatched_trees() -> None:
    _, params = _jax_model_and_params(1, 2)
    with pytest.raises(ValueError):
        _port_model(1, 2, params, hiddens=(32, 16, 8))
    with pytest.raises(ValueError):
        _port_model(1, 2, params, d=4)


def test_init_matches_flax_scales() -> None:
    """lecun-normal torsos (std 1/sqrt(fan_in), truncated at 2 stds),
    small-uniform logits head, zero biases, as flax initializes them."""
    model = DefaultDiscreteModel(Unbounded(64), Discrete(2, shape=(1,)), hiddens=(256, 256))
    model.reset_parameters(torch.Generator().manual_seed(0))
    w = model.feature_model.layers[1].weight.detach()
    assert abs(float(w.std()) - 256**-0.5) < 0.05 * 256**-0.5
    assert float(w.abs().max()) <= 2 * 256**-0.5 / 0.8796256610342398 + 1e-6
    assert float(model.feature_head.weight.detach().abs().max()) <= 1e-3
    assert all(float(m.bias.detach().abs().max()) == 0 for m in (model.feature_head, model.vf_head))
    jmodel = JModel(JUnbounded(64), JDiscrete(2, shape=(1,)), hiddens=(256, 256))
    jw = jmodel.init(jax.random.key(0), {"obs": jnp.zeros((1, 64))})["params"]["feature_model"]["Dense_1"]["kernel"]
    assert abs(float(w.std()) - float(jnp.std(jw))) < 0.05 * 256**-0.5


@pytest.mark.parametrize("A,n", [(1, 2), (3, 4)])
def test_categorical_matches_jax(A: int, n: int) -> None:
    rng = np.random.default_rng(A * n)
    logits = (rng.normal(size=(32, A, n)) * 3).astype(np.float32)
    samples = rng.integers(0, n, size=(32, A)).astype(np.int32)
    jdist = JCategorical({"logits": jnp.asarray(logits)})
    dist = Categorical({"logits": torch.from_numpy(logits)})
    np.testing.assert_array_equal(dist.deterministic_sample().numpy(), np.asarray(jdist.deterministic_sample()))
    np.testing.assert_allclose(
        dist.logp(torch.from_numpy(samples)).numpy(), np.asarray(jdist.logp(jnp.asarray(samples))),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(dist.entropy().numpy(), np.asarray(jdist.entropy()), rtol=1e-5, atol=1e-5)


def test_categorical_sample_frequencies() -> None:
    logits = torch.log(torch.tensor([[[0.2, 0.3, 0.5]]])).expand(20000, 1, 3)
    draws = Categorical({"logits": logits}).sample(torch.Generator().manual_seed(0))
    freq = torch.bincount(draws.flatten().long(), minlength=3).double() / draws.numel()
    # 5 binomial standard deviations at p <= 0.5 over 20000 draws.
    assert torch.allclose(freq, torch.tensor([0.2, 0.3, 0.5], dtype=torch.float64), atol=5 * 0.0036)


def test_policy_sample_matches_jax() -> None:
    jmodel, params = _jax_model_and_params(2, 3)
    jpolicy = JPolicy(JUnbounded(3), JDiscrete(3, shape=(2,)), model=jmodel)
    policy = Policy(Unbounded(3), Discrete(3, shape=(2,)), model_config={"hiddens": (32, 16)})
    load_jax_params(policy.model, jax.device_get(params))
    obs = np.random.default_rng(2).normal(size=(16, 4, 3)).astype(np.float32)
    for kind in ("last", "all"):
        kw = dict(kind=kind, deterministic=True, return_logp=True, return_values=True)
        jout = jpolicy.sample(params, {"obs": jnp.asarray(obs)}, **kw)
        out = policy.sample({"obs": torch.from_numpy(obs)}, **kw)
        np.testing.assert_array_equal(out["actions"].numpy(), np.asarray(jout["actions"]))
        for key in ("logp", "values"):
            np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), rtol=1e-5, atol=ATOL)
    with pytest.raises(ValueError, match="generator"):
        policy.sample({"obs": torch.from_numpy(obs)})
