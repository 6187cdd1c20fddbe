"""The update's optimizer (``rl8_tpu_torch.utils.optim``) against optax's
``chain(clip_by_global_norm, adam)`` over a flat vector, and the
schedulers (``rl8_tpu_torch.schedulers``) against ``rl8_tpu``'s, on the
CPU."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rl8_tpu.schedulers as jsched
import rl8_tpu_torch.schedulers as tsched
from rl8_tpu_torch.utils.optim import Adam, AdamState, adam_step

#: f32 on both sides; the global norm and the moments are summed and
#: rounded in another order, a few ulps of parameters of order 1.
RTOL, ATOL = 1e-6, 1e-7


@pytest.mark.parametrize(
    "adam,max_norm",
    [(Adam(), 1.0), (Adam(b1=0.8, b2=0.99, eps=1e-6, eps_root=1e-10), 1e3)],
)
def test_adam_matches_optax_clip_then_adam(adam: Adam, max_norm: float) -> None:
    """Five steps with a learning rate set per step (as
    ``optax.inject_hyperparams`` does); the first case clips every step."""
    rng = np.random.default_rng(0)
    params = rng.normal(size=(300,)).astype(np.float32)
    grads = [(3.0 * rng.normal(size=(300,))).astype(np.float32) for _ in range(5)]
    lrs = [1e-2, 1e-2, 5e-3, 5e-3, 1e-3]

    opt = optax.inject_hyperparams(
        lambda learning_rate: optax.chain(
            optax.clip_by_global_norm(max_norm),
            optax.adam(learning_rate, b1=adam.b1, b2=adam.b2, eps=adam.eps, eps_root=adam.eps_root),
        )
    )(learning_rate=lrs[0])
    jp = jnp.asarray(params)
    js = opt.init(jp)
    tp = torch.from_numpy(params)
    ts = AdamState.zeros_like(tp)
    for g, lr in zip(grads, lrs):
        js.hyperparams["learning_rate"] = jnp.asarray(lr, dtype=jnp.float32)
        updates, js = opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, updates)
        tp, ts = adam_step(tp, torch.from_numpy(g), ts, lr=lr, max_grad_norm=max_norm, adam=adam)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)
    assert int(ts.count) == 5
    inner = js.inner_state[1][0]
    np.testing.assert_allclose(ts.m.numpy(), np.asarray(inner.mu), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(inner.nu), rtol=1e-5, atol=1e-7)


def test_clip_has_no_epsilon() -> None:
    """A gradient of norm exactly 2 clipped to 1 is halved exactly;
    ``torch.nn.utils.clip_grad_norm_`` would divide by 2 + 1e-6."""
    g = torch.tensor([1.2, -1.6])
    p, s = adam_step(torch.zeros(2), g, AdamState.zeros_like(g), lr=0.0, max_grad_norm=1.0, adam=Adam())
    assert torch.equal(s.m, 0.1 * torch.tensor([0.6, -0.8]))


def test_apply_flag_gates_the_update() -> None:
    p0 = torch.ones(4)
    g = torch.full((4,), 0.5)
    s0 = AdamState.zeros_like(p0)
    p, s = adam_step(p0, g, s0, lr=0.1, max_grad_norm=10.0, adam=Adam(), apply=torch.tensor(False))
    assert torch.equal(p, p0) and torch.equal(s.m, s0.m) and torch.equal(s.v, s0.v) and int(s.count) == 0
    p, s = adam_step(p0, g, s0, lr=0.1, max_grad_norm=10.0, adam=Adam(), apply=torch.tensor(True))
    assert int(s.count) == 1 and torch.allclose(p, p0 - 0.1)


# ----------------------------------------------------------------------
# Schedulers: the port's copy behaves as rl8_tpu's (tests/test_schedulers.py)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("pkg", [jsched, tsched], ids=["rl8_tpu", "port"])
def test_constant_and_step_schedulers(pkg) -> None:
    s = pkg.ConstantScheduler(0.5)
    assert s.step(0) == 0.5 and s.step(10**9) == 0.5
    s = pkg.StepScheduler([(0, 1.0), (100, 0.5), (200, 0.1)])
    assert [s.step(c) for c in (0, 99, 100, 150, 200, 10**9)] == [1.0, 1.0, 0.5, 0.5, 0.1, 0.1]


@pytest.mark.parametrize("pkg", [jsched, tsched], ids=["rl8_tpu", "port"])
def test_interp_scheduler(pkg) -> None:
    s = pkg.InterpScheduler([(0, 0.0), (100, 1.0)])
    assert [s.step(c) for c in (0, 50, 100, 200)] == [0.0, 0.5, 1.0, 1.0]


def test_schedule_must_start_at_zero() -> None:
    for cls in (tsched.StepScheduler, tsched.InterpScheduler):
        with pytest.raises(ValueError):
            cls([(10, 1.0)])


def test_entropy_and_lr_schedulers_match_rl8_tpu() -> None:
    counts = [0, 37, 50, 100, 10**6]
    for kind in ("step", "interp"):
        schedule = [(0, 0.1), (100, 0.0)]
        for make in (
            lambda pkg: pkg.EntropyScheduler(0.3, schedule=schedule, kind=kind),
            lambda pkg: pkg.LRScheduler(1e-3, schedule=schedule, kind=kind),
            lambda pkg: pkg.EntropyScheduler(0.3),
            lambda pkg: pkg.LRScheduler(1e-3),
        ):
            j, t = make(jsched), make(tsched)
            assert t.coeff == j.coeff
            for c in counts:
                assert t.step(c) == j.step(c) and t.coeff == j.coeff
    with pytest.raises(ValueError, match="kinds"):
        tsched.LRScheduler(1e-3, schedule=[(0, 1.0)], kind="cosine")
