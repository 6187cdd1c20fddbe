"""The GAE kernel's plain version (``rl8_tpu_torch.ops.gae``) and the
port's ``generalized_advantage_estimate`` held against ``rl8_tpu``'s
Pallas GAE kernel (interpret mode) and scan, on the CPU. The CUDA kernel
itself is held against the plain version on the card by
``chip_smoke.py``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl8_tpu.nn.functional import generalized_advantage_estimate as jax_gae
from rl8_tpu.ops import pallas_gae
from rl8_tpu_torch.nn.functional import generalized_advantage_estimate
from rl8_tpu_torch.ops import fused_gae, gae_plain

#: f32 on both sides; the scan divides by the scale where the kernels
#: multiply by its inverse, a relative difference of a few ulps.
RTOL, ATOL = 1e-5, 1e-5

_PARAMS = [(0.95, 0.95, 1.0), (0.99, 0.9, 3.7), (1.0, 1.0, 1.0)]


def _inputs(T: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(T, B, 1)).astype(np.float32)
    values = rng.normal(size=(T + 1, B, 1)).astype(np.float32)
    return rewards, values


@pytest.mark.parametrize("T", [1, 7, 32])
@pytest.mark.parametrize("B", [3, 512, 1000])
@pytest.mark.parametrize("gamma,lam,scale", _PARAMS)
def test_plain_gae_matches_pallas_and_scan(T: int, B: int, gamma: float, lam: float, scale: float) -> None:
    """At one step, at a T that is no multiple of the CUDA kernel's chunk of
    time steps, and at the main path's horizon (``chip_smoke.py`` holds the
    kernel against this plain version at T = 1, 32, 33 and 512)."""
    rewards, values = _inputs(T, B, seed=B)
    adv, ret = gae_plain(
        torch.from_numpy(rewards), torch.from_numpy(values), torch.tensor(scale),
        gamma=gamma, gae_lambda=lam,
    )
    p_adv, p_ret = pallas_gae(
        jnp.asarray(rewards), jnp.asarray(values), scale, gamma=gamma, gae_lambda=lam, interpret=True
    )
    s_adv, s_ret = jax_gae(
        jnp.asarray(rewards), jnp.asarray(values), gamma=gamma, gae_lambda=lam,
        normalize_advantages=False, reward_scale=scale,
    )
    for ref_adv, ref_ret in ((p_adv, p_ret), (s_adv, s_ret)):
        np.testing.assert_allclose(adv.numpy(), np.asarray(ref_adv), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ret.numpy(), np.asarray(ref_ret), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("gamma,lam,scale", _PARAMS)
def test_functional_gae_matches_jax(normalize: bool, gamma: float, lam: float, scale: float) -> None:
    rewards, values = _inputs(16, 37, seed=1)
    kw = dict(gamma=gamma, gae_lambda=lam, normalize_advantages=normalize, reward_scale=scale)
    adv, ret = generalized_advantage_estimate(torch.from_numpy(rewards), torch.from_numpy(values), **kw)
    j_adv, j_ret = jax_gae(jnp.asarray(rewards), jnp.asarray(values), **kw)
    np.testing.assert_allclose(adv.numpy(), np.asarray(j_adv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ret.numpy(), np.asarray(j_ret), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B", [3, 600])
def test_gamma_lambda_one_golden(B: int) -> None:
    """With gamma = lambda = 1, unit rewards and zero values, the
    advantage at t is the number of remaining steps, T - t."""
    T = 5
    adv, ret = fused_gae(
        torch.ones((T, B, 1)), torch.zeros((T + 1, B, 1)), torch.tensor(1.0), gamma=1.0, gae_lambda=1.0
    )
    expected = torch.arange(T, 0, -1, dtype=torch.float32).view(T, 1, 1).expand(T, B, 1) / (1 + 1e-8)
    torch.testing.assert_close(adv, expected, rtol=1e-6, atol=0)
    torch.testing.assert_close(ret, expected, rtol=1e-6, atol=0)


def test_fused_gae_cpu_takes_the_plain_version_and_validates() -> None:
    rewards, values = (torch.from_numpy(x) for x in _inputs(4, 9, seed=2))
    scale = torch.tensor(2.0)
    before = fused_gae.launches
    got = fused_gae(rewards, values, scale, gamma=0.9, gae_lambda=0.8)
    want = gae_plain(rewards, values, scale, gamma=0.9, gae_lambda=0.8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fused_gae.launches == before  # the CPU path launches no kernel
    kw = dict(gamma=0.9, gae_lambda=0.8)
    with pytest.raises(ValueError):
        fused_gae(rewards, values[:-1], scale, **kw)
    with pytest.raises(ValueError):
        fused_gae(rewards, values, scale.view(1), **kw)
    with pytest.raises(ValueError):
        fused_gae(rewards.double(), values.double(), scale.double(), **kw)
    with pytest.raises(ValueError):
        fused_gae(rewards.to("meta"), values.to("meta"), scale.to("meta"), **kw)
