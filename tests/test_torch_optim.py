"""The update's optimizer (``rl8_tpu_torch.utils.optim``) against optax's
``chain(clip_by_global_norm, adam)`` over a flat vector; the
``torch.optim`` optimizers behind ``optimizer_cls`` against their optax
counterparts in a whole ``step()``, flat and per leaf; their state under
the KL early stop and the LR schedule; and the schedulers
(``rl8_tpu_torch.schedulers``) against ``rl8_tpu``'s, on the CPU."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rl8_tpu.env as jenv
import rl8_tpu.schedulers as jsched
import rl8_tpu_torch.env as tenv
import rl8_tpu_torch.schedulers as tsched
from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
from rl8_tpu import RecurrentAlgorithmConfig as JRecurrentAlgorithmConfig
from rl8_tpu_torch import AlgorithmConfig, RecurrentAlgorithmConfig
from rl8_tpu_torch.models import load_jax_params, to_jax_params
from rl8_tpu_torch.utils.optim import Adam, AdamState, TorchOptimizer, adam_step

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
# torch.optim behind optimizer_cls
# ----------------------------------------------------------------------

#: optax factories and the ``torch.optim`` classes of the same math, with
#: every hyperparameter given on both sides under each package's names
#: (optax's and torch's defaults differ, e.g. AdamW's weight decay).
PAIRS = {
    "sgd": (optax.sgd, {"lr": 0.05}, torch.optim.SGD, {"lr": 0.05}),
    "sgd-momentum": (optax.sgd, {"lr": 0.05, "momentum": 0.9}, torch.optim.SGD, {"lr": 0.05, "momentum": 0.9}),
    "sgd-nesterov": (
        optax.sgd, {"lr": 0.05, "momentum": 0.9, "nesterov": True},
        torch.optim.SGD, {"lr": 0.05, "momentum": 0.9, "nesterov": True},
    ),
    "adam": (
        optax.adam, {"lr": 2e-3, "b1": 0.8, "b2": 0.99, "eps": 1e-6},
        torch.optim.Adam, {"lr": 2e-3, "betas": (0.8, 0.99), "eps": 1e-6},
    ),
    "adamw": (
        optax.adamw, {"lr": 2e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 0.05},
        torch.optim.AdamW, {"lr": 2e-3, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0.05},
    ),
}
NUM_ENVS, HORIZON, HIDDENS = 64, 8, (32, 32)
STAT_KEYS = ("losses/entropy", "losses/policy", "losses/vf", "losses/total", "monitors/kl_div")
#: As ``tests/test_torch_step.py`` holds a step: f32 on both sides, the
#: losses to ~1e-6 relative, the parameters by a norm-relative error of
#: their change (Adam divides each gradient by its own magnitude, so a
#: parameter whose gradient is rounding noise may move by up to lr).
STAT_RTOL, STAT_ATOL, DELTA_REL = 1e-4, 1e-6, 1e-3


def _flat_tree(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def _step_pair(jconfig, tconfig, jenv_cls, tenv_cls, *, recurrent: bool = False):
    """One ``step()`` in each package from ``rl8_tpu``'s initial parameters
    and collected buffer: the port's and ``rl8_tpu``'s algorithms, the
    initial parameters, and both steps' stats."""
    jcls, tcls = (JRecurrentAlgorithmConfig, RecurrentAlgorithmConfig) if recurrent else (JAlgorithmConfig, AlgorithmConfig)
    jalgo = jcls(**jconfig).build(jenv_cls)
    params0 = jax.device_get(jalgo.state.params)
    talgo = tcls(**tconfig, device="cpu").build(tenv_cls)
    load_jax_params(talgo.policy.model, params0)
    jalgo.collect()
    jbuf = jax.device_get(jalgo.state.buffer)
    talgo.state.buffer = {
        k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()} if isinstance(v, dict) else torch.from_numpy(np.array(v))
        for k, v in jbuf.items()
    }
    talgo.state.reward_scale = torch.tensor(float(jalgo.state.reward_scale))
    talgo.state.horizons = int(jalgo.state.horizons)
    talgo.state.buffered = True
    return jalgo, talgo, params0, jalgo.step(), talgo.step()


def _assert_step_matches(jalgo, talgo, params0, jstats, tstats) -> None:
    for key in STAT_KEYS:
        assert math.isclose(tstats[key], jstats[key], rel_tol=STAT_RTOL, abs_tol=STAT_ATOL), (key, tstats[key], jstats[key])
    start = _flat_tree(params0)
    jdelta = _flat_tree(jax.device_get(jalgo.state.params)) - start
    tdelta = _flat_tree(to_jax_params(talgo.policy.model)) - start
    assert np.linalg.norm(jdelta) > 0
    assert np.linalg.norm(tdelta - jdelta) <= DELTA_REL * np.linalg.norm(jdelta)


@pytest.mark.parametrize("flatten", [True, False], ids=["flat", "per-leaf"])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_torch_optimizers_match_optax_in_a_step(pair: str, flatten: bool) -> None:
    """One whole-buffer ``step()`` (four updates, no shuffle) with each
    optax optimizer and its ``torch.optim`` class, from the same weights
    and buffer: the losses, and the parameters afterwards. Per leaf, the
    optimizer holds one state entry per model leaf."""
    jopt, jkw, topt, tkw = PAIRS[pair]
    common = dict(num_envs=NUM_ENVS, horizon=HORIZON, model_config={"hiddens": HIDDENS}, seed=3,
                  entropy_coeff=0.01, flatten_optimizer=flatten)
    jalgo, talgo, params0, jstats, tstats = _step_pair(
        {**common, "optimizer_cls": jopt, "optimizer_config": jkw},
        {**common, "optimizer_cls": topt, "optimizer_config": tkw},
        jenv.DiscreteDummyEnv, tenv.DiscreteDummyEnv,
    )
    _assert_step_matches(jalgo, talgo, params0, jstats, tstats)
    opt = talgo._torch_optimizer
    assert isinstance(opt.optimizer, topt)
    assert len(opt.params) == (1 if flatten else len(list(talgo.policy.model.parameters())))
    if pair in ("adam", "adamw"):
        jcount = int(jax.tree_util.tree_leaves(jalgo.state.opt_state.inner_state)[0])
        assert all(int(s["step"]) == jcount == 4 for s in talgo.state.opt_state.per_param.values())


@pytest.mark.parametrize(
    "extra",
    [
        {"fused_update": True, "target_kl_div": 1e-8, "dual_clip_param": 3.0},
        {"fused_update": False, "accumulate_grads": True, "sgd_minibatch_size": NUM_ENVS * HORIZON // 2 // 4},
    ],
    ids=["kernel-kl-stop", "autodiff-accumulate"],
)
def test_recurrent_adamw_per_leaf_matches_optax(extra: dict) -> None:
    """The recurrent algorithm with ``optax.adamw``/``torch.optim.AdamW``
    per leaf: through the update kernel with a KL early stop, and through
    the autodiff update with accumulated gradients."""
    jopt, jkw, topt, tkw = PAIRS["adamw"]
    common = dict(num_envs=32, horizon=HORIZON, seq_len=2, seqs_per_state_reset=2, seed=3,
                  model_config={"hidden_size": 16}, flatten_optimizer=False, entropy_coeff=0.01, **extra)
    jalgo, talgo, params0, jstats, tstats = _step_pair(
        {**common, "optimizer_cls": jopt, "optimizer_config": jkw},
        {**common, "optimizer_cls": topt, "optimizer_config": tkw},
        jenv.DiscreteDummyEnv, tenv.DiscreteDummyEnv, recurrent=True,
    )
    _assert_step_matches(jalgo, talgo, params0, jstats, tstats)
    assert talgo._fused_update is extra["fused_update"]
    jcount = int(jax.tree_util.tree_leaves(jalgo.state.opt_state.inner_state)[0])
    assert {int(s["step"]) for s in talgo.state.opt_state.per_param.values()} == {jcount}


def test_torch_adam_agrees_with_adam_step() -> None:
    """``torch.optim.Adam`` behind the same clip is the hand-written Adam
    (eps_root 0) up to rounding: five steps at per-step learning rates."""
    rng = np.random.default_rng(0)
    params = rng.normal(size=(300,)).astype(np.float32)
    grads = [(3.0 * rng.normal(size=(300,))).astype(np.float32) for _ in range(5)]
    lrs = [1e-2, 1e-2, 5e-3, 5e-3, 1e-3]
    adam = Adam(b1=0.8, b2=0.99, eps=1e-6)
    tp, ts = torch.from_numpy(params), AdamState.zeros_like(torch.from_numpy(params))
    opt = TorchOptimizer(torch.optim.Adam, torch.from_numpy(params), lr=lrs[0], shapes=[(100,), (20, 10)],
                         betas=(adam.b1, adam.b2), eps=adam.eps)
    for g, lr in zip(grads, lrs):
        tp, ts = adam_step(tp, torch.from_numpy(g), ts, lr=lr, max_grad_norm=10.0, adam=adam)
        opt.step(torch.from_numpy(g), lr=lr, max_grad_norm=10.0)
        np.testing.assert_allclose(opt.flat.numpy(), tp.numpy(), rtol=1e-6, atol=1e-6)
    state = opt.export().per_param
    np.testing.assert_allclose(torch.cat([state[k]["exp_avg"].reshape(-1) for k in ("0", "1")]).numpy(),
                               ts.m.numpy(), rtol=1e-6, atol=1e-7)
    assert {int(state[k]["step"]) for k in ("0", "1")} == {int(ts.count)} == {5}


@pytest.mark.parametrize("cls,kw", [(torch.optim.AdamW, {}), (torch.optim.SGD, {"momentum": 0.9}),
                                    (torch.optim.Adagrad, {})], ids=["adamw", "sgd-momentum", "adagrad"])
def test_kl_stop_leaves_parameters_and_state_unchanged(cls, kw) -> None:
    """A false ``apply`` leaves the parameters and every state tensor as
    they were, bit for bit, and the step count where it was, before the
    first step (the state does not exist yet) and after it; a true one
    updates them."""
    rng = np.random.default_rng(1)
    flat = torch.from_numpy(rng.normal(size=(50,)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(50,)).astype(np.float32))
    opt = TorchOptimizer(cls, flat, lr=0.1, shapes=[(5, 6), (20,)], **kw)
    # Adagrad builds its state with the optimizer; the others at the first step.
    built = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in opt.export().per_param.items()}
    opt.step(g, lr=0.1, max_grad_norm=1.0, apply=torch.tensor(False))
    assert torch.equal(opt.flat, flat) and not opt.export().stepped
    assert opt.export().per_param.keys() == built.keys()
    for k, v in opt.export().per_param.items():
        assert all(torch.equal(vv, built[k][kk]) for kk, vv in v.items()), k
    opt.step(g, lr=0.1, max_grad_norm=1.0, apply=torch.tensor(True))
    before = opt.flat.clone(), {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in opt.export().per_param.items()}
    assert not torch.equal(before[0], flat) and len(before[1]) == 2
    opt.step(2.0 * g, lr=0.1, max_grad_norm=1.0, apply=torch.tensor(False))
    assert torch.equal(opt.flat, before[0])
    for k, v in opt.export().per_param.items():
        assert all(torch.equal(vv, before[1][k][kk]) for kk, vv in v.items()), k
    opt.step(2.0 * g, lr=0.1, max_grad_norm=1.0, apply=torch.tensor(True))
    assert not torch.equal(opt.flat, before[0])


def test_lr_schedule_reaches_the_torch_optimizer() -> None:
    """The learning rate of each update is the scheduler's, set in every
    param group before the update (``optax.inject_hyperparams``'s
    counterpart): a step schedule drops it after the first step (the
    schedulers count ``num_envs`` per collect, as ``rl8_tpu``'s do)."""
    n = 16
    algo = AlgorithmConfig(num_envs=16, horizon=8, model_config={"hiddens": (8,)}, device="cpu",
                           optimizer_cls=torch.optim.SGD, optimizer_config={"lr": 0.1},
                           lr_schedule=[(0, 0.1), (n, 0.01)], flatten_optimizer=False).build(tenv.DiscreteDummyEnv)
    seen = []
    for _ in range(2):
        algo.collect()
        algo.step()
        seen.append({g["lr"] for g in algo._torch_optimizer.optimizer.param_groups})
    assert seen == [{0.1}, {0.01}]


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
