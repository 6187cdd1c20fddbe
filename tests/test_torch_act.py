"""The act kernel's plain version (``rl8_tpu_torch.ops.fused_act``) held
against ``rl8_tpu``'s fused act kernel (Pallas, interpret mode) and
against flax + ``Categorical``, on the CPU. The CUDA kernel itself is held
against this plain version on the card by ``chip_smoke.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rl8_tpu.distributions import Categorical as JCategorical
from rl8_tpu.models import DefaultDiscreteModel as JModel
from rl8_tpu.ops.fused_act import fused_act as jax_fused_act
from rl8_tpu.specs import Discrete as JDiscrete
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu_torch.models import DefaultDiscreteModel, load_jax_params
from rl8_tpu_torch.ops import act_plain, fused_act, pack_act_params
from rl8_tpu_torch.ops.distmath import philox4x32, philox_uniform
from rl8_tpu_torch.specs import Discrete, Unbounded

#: Against flax: f32 both sides, different summation order.
F32_ATOL = 1e-5
#: Against the Pallas kernel: it multiplies the hidden layers in bf16
#: (``fused_mlp._dot``), as the repo's own fused-act test allows.
BF16_RTOL, BF16_ATOL = 2e-2, 3e-2


def _setup(A: int, n: int, B: int = 64, seed: int = 0):
    jmodel = JModel(JUnbounded(3), JDiscrete(n, shape=(A,)), hiddens=(32, 16))
    params = jmodel.init(jax.random.key(seed), {"obs": jnp.zeros((1, 3))})["params"]
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(
        treedef,
        [jnp.asarray(np.asarray(p) + 0.3 * rng.normal(size=p.shape).astype(np.float32)) for p in leaves],
    )
    model = DefaultDiscreteModel(Unbounded(3), Discrete(n, shape=(A,)), hiddens=(32, 16))
    load_jax_params(model, jax.device_get(params))
    obs = rng.normal(size=(B, 3)).astype(np.float32)
    return jmodel, params, pack_act_params(model), obs


def _gap(z: np.ndarray) -> np.ndarray:
    """Per-row smallest gap between the top two scores of any group."""
    top2 = -np.sort(-z, axis=-1)[..., :2]
    return (top2[..., 0] - top2[..., 1]).min(axis=1)


@pytest.mark.parametrize("A,n", [(1, 2), (2, 3)])
def test_deterministic_matches_flax_categorical(A: int, n: int) -> None:
    jmodel, params, packed, obs = _setup(A, n)
    feats, jvalues = jmodel.apply({"params": params}, {"obs": jnp.asarray(obs)})
    jdist = JCategorical(feats)
    jactions = np.asarray(jdist.deterministic_sample())
    actions, logp, values = act_plain(packed, torch.from_numpy(obs), (0, 0), deterministic=True)
    keep = _gap(np.asarray(feats["logits"])) > 1e-5
    np.testing.assert_array_equal(actions.numpy()[keep], jactions[keep])
    np.testing.assert_allclose(logp.numpy(), np.asarray(jdist.logp(jnp.asarray(actions.numpy()))), atol=F32_ATOL)
    np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), atol=F32_ATOL)


@pytest.mark.parametrize("A,n", [(1, 2), (2, 3)])
def test_deterministic_matches_pallas_act_kernel(A: int, n: int) -> None:
    jmodel, params, packed, obs = _setup(A, n)
    with pltpu.force_tpu_interpret_mode():
        ja, jl, jv = jax_fused_act(
            jmodel, params, {"obs": jnp.asarray(obs)}, jax.random.key(5), deterministic=True
        )
    actions, logp, values = act_plain(packed, torch.from_numpy(obs), (0, 0), deterministic=True)
    feats, _ = jmodel.apply({"params": params}, {"obs": jnp.asarray(obs)})
    # Rows whose top-2 logits are within the bf16 error may flip.
    keep = _gap(np.asarray(feats["logits"])) > 0.1
    assert keep.mean() > 0.5
    np.testing.assert_array_equal(actions.numpy()[keep], np.asarray(ja)[keep])
    np.testing.assert_allclose(logp.numpy()[keep], np.asarray(jl)[keep], rtol=BF16_RTOL, atol=BF16_ATOL)
    np.testing.assert_allclose(values.numpy(), np.asarray(jv), rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("A,n", [(1, 2), (2, 3)])
def test_stochastic_with_injected_noise_matches_numpy(A: int, n: int) -> None:
    jmodel, params, packed, obs = _setup(A, n, seed=3)
    feats, _ = jmodel.apply({"params": params}, {"obs": jnp.asarray(obs)})
    logits = np.asarray(feats["logits"], dtype=np.float64)  # [B, A, n]
    u = np.random.default_rng(4).uniform(1e-7, 1.0, size=(obs.shape[0], A * n)).astype(np.float32)
    z = logits - logits.max(-1, keepdims=True)
    z = z - np.log(np.exp(z).sum(-1, keepdims=True))
    scores = z - np.log(-np.log(u.astype(np.float64).reshape(-1, A, n)))
    expected = scores.argmax(-1)
    expected_logp = np.take_along_axis(z, expected[..., None], -1).sum(axis=(1, 2))
    actions, logp, _ = act_plain(
        packed, torch.from_numpy(obs), (0, 0), deterministic=False, noise=torch.from_numpy(u)
    )
    keep = _gap(scores) > 1e-4
    np.testing.assert_array_equal(actions.numpy()[keep], expected[keep])
    np.testing.assert_allclose(logp.numpy()[keep, 0], expected_logp[keep], atol=1e-4)


@pytest.mark.parametrize("A,n", [(1, 2), (2, 3)])
def test_sampling_frequencies_with_generator(A: int, n: int) -> None:
    """Per-category counts over draws keyed from a ``torch.Generator``
    match the softmax probabilities within 5 standard deviations."""
    jmodel, params, packed, obs = _setup(A, n, B=32, seed=5)
    feats, _ = jmodel.apply({"params": params}, {"obs": jnp.asarray(obs)})
    probs = np.asarray(jax.nn.softmax(feats["logits"], axis=-1), dtype=np.float64)
    gen = torch.Generator().manual_seed(0)
    draws = 400
    counts = np.zeros_like(probs)
    obs_t = torch.from_numpy(obs)
    for _ in range(draws):
        key = tuple(torch.randint(0, 2**32, (2,), generator=gen).tolist())
        actions, _, _ = fused_act(packed, obs_t, key)
        counts += np.eye(n)[actions.numpy()]
    expected = draws * probs.sum(axis=0)
    sigma = np.sqrt(draws * (probs * (1 - probs)).sum(axis=0))
    assert np.all(np.abs(counts.sum(axis=0) - expected) <= 5 * sigma + 1e-9)


def test_philox_known_answers() -> None:
    """Philox4x32-10 known-answer vectors of the Random123 suite."""
    def run(ctr, key):
        words = philox4x32(tuple(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
        return [int(w) for w in words]

    assert run((0, 0, 0, 0), (0, 0)) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = 0xFFFFFFFF
    assert run((f, f, f, f), (f, f)) == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1,
    ]


def test_philox_uniform_layout() -> None:
    """Draws are indexed by (row, group, category), so a row's draws do
    not depend on how many rows are drawn, and lie in [1e-7, 1)."""
    u = philox_uniform(7, 11, 1000, 2, 3)
    assert u.shape == (1000, 6)
    assert torch.equal(philox_uniform(7, 11, 10, 2, 3), u[:10])
    assert float(u.min()) >= 1e-7 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert not torch.equal(philox_uniform(7, 12, 10, 2, 3), u[:10])
    # The kernel's construction: word 0 of Philox at counter (row, group,
    # category, 0), its top 23 bits times 2^-23.
    for (r, g, c), got in zip(np.ndindex(2, 2, 3), u[:2].flatten().tolist()):
        ctr = tuple(torch.tensor([x], dtype=torch.int64) for x in (r, g, c, 0))
        assert got == max((int(philox4x32(ctr, (7, 11))[0]) >> 9) / 2**23, np.float32(1e-7))


def test_fused_act_cpu_takes_the_plain_version_and_validates() -> None:
    _, _, packed, obs = _setup(2, 3)
    obs_t = torch.from_numpy(obs)
    before = fused_act.launches
    for det in (True, False):
        got = fused_act(packed, obs_t, (3, 4), deterministic=det)
        want = act_plain(packed, obs_t, (3, 4), deterministic=det)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert fused_act.launches == before  # the CPU path launches no kernel
    # Non-f32 observations are widened first.
    assert torch.equal(fused_act(packed, obs_t.double(), (3, 4))[0], fused_act(packed, obs_t, (3, 4))[0])
    with pytest.raises(ValueError):
        fused_act(packed, obs_t[:, :2], (0, 0))
    with pytest.raises(ValueError):
        fused_act(packed, obs_t, (2**32, 0))
    with pytest.raises(ValueError):
        fused_act(packed, obs_t.to("meta"), (0, 0))
    model = DefaultDiscreteModel(Unbounded(3), Discrete(2), hiddens=(8,), activation_fn="gelu")
    with pytest.raises(ValueError, match="activations"):
        pack_act_params(model)
