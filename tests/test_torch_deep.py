"""Deep models against ``rl8_tpu`` on the CPU: default models deeper than
8 layers and chain structures of more than 4 chains, 8 layers or 4
heads, which ``rl8_tpu``'s gates send to its kernels and which the port's
kernels now take too. The plain versions of the act and update kernels at
9 and 12 layers (against flax, ``jax.grad`` and the Pallas kernels in
interpret mode), ``step()`` at 9 and 16 layers, the route flags at 9 and
16 layers and at the first depth ``rl8_tpu``'s gate refuses, the chain
kernels' plain versions at 5 chains of 12 LayerNorm layers and 6 ragged
heads, and a custom model of 5 chains that collects and steps as
``rl8_tpu``'s. The CUDA kernels are held against these plain versions on
the card by ``chip_smoke.py`` (``deep_sweep``, ``chains_count_sweep``)."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import flax.linen as fnn
import rl8_tpu.env as jenv
import rl8_tpu_torch.env as tenv
from rl8_tpu import AlgorithmConfig as JAlgorithmConfig
from rl8_tpu.algorithms._feedforward import Algorithm as JAlgorithm
from rl8_tpu.data import DataKeys as JDataKeys
from rl8_tpu.distributions import Categorical as JCategorical
from rl8_tpu.models import DefaultDiscreteModel as JDiscreteModel
from rl8_tpu.models import GenericModel as JGenericModel
from rl8_tpu.nn import MLP as JMLP
from rl8_tpu.ops import pack_rows as jax_pack_rows
from rl8_tpu.ops.fused_act import fused_act as jax_fused_act
from rl8_tpu.ops.fused_mlp import FusedApplySpec as JFusedApplySpec
from rl8_tpu.ops.fused_ppo import PPOLossConfig as JPPOLossConfig
from rl8_tpu.ops.fused_ppo import fused_ppo_grads as jax_fused_ppo_grads
from rl8_tpu.specs import Discrete as JDiscrete
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu.views import ViewRequirement as JViewRequirement
from rl8_tpu_torch import AlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.models import DefaultDiscreteModel, GenericModel, lecun_normal_, load_jax_params, to_jax_params
from rl8_tpu_torch.nn import MLP
from rl8_tpu_torch.ops import act_plain, model_fits_vmem, supports_fused_update
from rl8_tpu_torch.ops.fused_mlp import FusedApplySpec
from rl8_tpu_torch.specs import Discrete, Unbounded
from rl8_tpu_torch.views import ViewRequirement
from tests import test_torch_continuous_update as cont
from tests import test_torch_update as disc
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_act import _gap
from tests.test_torch_chains import _leaves, _random_chains, _to, _torch_loss_and_grads
from tests.test_torch_chains_wide import F32_GRAD_NORM, F32_OUT_REL, _jax_loss_and_grads, _pallas_forward, _plain_jnp_forward
from tests.test_torch_recurrent_route import _jax_flags
from tests.test_torch_step import DELTA_REL, STAT_ATOL, STAT_KEYS, STAT_RTOL, _copy_rollout, _flat, _jax_params

#: Depths past the kernels' former limit of 8 layers, at 16 wide.
DEPTHS = (9, 12)
WIDTH = 16


def _deep(hiddens_len: int) -> tuple[int, ...]:
    return (WIDTH,) * hiddens_len


# ----------------------------------------------------------------------
# The act kernel's plain version
# ----------------------------------------------------------------------


def _discrete_pair(layers: int, seed: int = 0, B: int = 64):
    """The same discrete model in both packages (flax-initialized, each
    parameter perturbed by 0.3 standard normals, as tests/test_torch_act.py
    does, and the logits head scaled by 4, so that at depth the logits keep
    gaps of order 1 between their top two) and numpy observations."""
    hiddens = _deep(layers)
    jmodel = JDiscreteModel(JUnbounded(3), JDiscrete(3, shape=(2,)), hiddens=hiddens)
    params = jmodel.init(jax.random.key(seed), {"obs": jnp.zeros((1, 3))})["params"]
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(np.asarray(p) + 0.3 * rng.normal(size=p.shape).astype(np.float32)) for p in leaves]
    )
    params["feature_head"]["kernel"] = 4.0 * params["feature_head"]["kernel"]
    model = DefaultDiscreteModel(Unbounded(3), Discrete(3, shape=(2,)), hiddens=hiddens)
    load_jax_params(model, jax.device_get(params))
    return jmodel, params, model, rng.normal(size=(B, 3)).astype(np.float32)


@pytest.mark.parametrize("layers", DEPTHS)
def test_discrete_act_plain_matches_flax_and_pallas(layers: int) -> None:
    """``act_plain`` deterministic at 9 and 12 layers: actions, log-probs
    and values against flax + ``Categorical`` in f32, and against
    ``rl8_tpu``'s fused act kernel in interpret mode at its bf16
    tolerances (tests/test_torch_act.py's)."""
    from rl8_tpu_torch.ops import pack_act_params
    from rl8_tpu_torch.ops.fused_act import ActParams
    from tests.test_torch_act import F32_ATOL

    jmodel, params, model, obs = _discrete_pair(layers)
    packed = pack_act_params(model)
    assert packed.hiddens == _deep(layers)
    actions, logp, values = act_plain(packed, torch.from_numpy(obs), (0, 0), deterministic=True)
    feats, jvalues = jmodel.apply({"params": params}, {"obs": jnp.asarray(obs)})
    jdist = JCategorical(feats)
    keep = _gap(np.asarray(feats["logits"])) > 1e-5
    np.testing.assert_array_equal(actions.numpy()[keep], np.asarray(jdist.deterministic_sample())[keep])
    np.testing.assert_allclose(logp.numpy(), np.asarray(jdist.logp(jnp.asarray(actions.numpy()))), atol=F32_ATOL)
    np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), rtol=1e-5, atol=F32_ATOL)
    with pltpu.force_tpu_interpret_mode():
        ja, jl, jv = jax_fused_act(jmodel, params, {"obs": jnp.asarray(obs)}, jax.random.key(5), deterministic=True)
    keep = _gap(np.asarray(feats["logits"])) > 0.1
    assert keep.mean() > 0.5
    np.testing.assert_array_equal(actions.numpy()[keep], np.asarray(ja)[keep])
    # The Pallas kernel's bf16 products drift with depth past the bf16
    # tolerances that tests/test_torch_act.py sets for two layers, so the
    # log-probs and values are held to float64 (the plain version on
    # float64 parameters), each within F64_K = 4 times the kernel's error
    # off it, plus the f32 tolerance.
    f64 = ActParams(**{**packed.__dict__, "flat": packed.flat.double()})
    _, f_logp, f_values = act_plain(f64, torch.from_numpy(obs).double(), (0, 0), deterministic=True)
    for got, pallas, want in ((logp[keep], jl[keep], f_logp[keep]), (values, jv, f_values)):
        want = want.numpy()
        err, pallas_err = np.linalg.norm(got.numpy() - want), np.linalg.norm(np.asarray(pallas, np.float64) - want)
        assert err <= 4.0 * pallas_err + F32_ATOL * np.sqrt(want.size), (err, pallas_err)


@pytest.mark.parametrize("layers", DEPTHS)
@pytest.mark.parametrize("kind", ["normal", "squashed"])
def test_continuous_act_plain_matches_flax(kind: str, layers: int) -> None:
    """``act_plain`` deterministic for the continuous kinds at 9 and 12
    layers against flax + ``Normal``/``SquashedNormal`` (f32; squashed
    log-probs where every mean's |x| < 2, as tests/test_torch_continuous.py
    compares them)."""
    from rl8_tpu_torch.ops import pack_act_params
    from tests.test_torch_continuous import ATOL, LOGP_ATOL, RTOL, SQUASH_LIMIT, _flax_dist
    from tests.test_torch_continuous import _setup as continuous_setup

    jmodel, params, model, rng = continuous_setup(A=2, hiddens=_deep(layers), scale=0.1)
    obs = rng.normal(size=(64, 3)).astype(np.float32)
    packed = pack_act_params(model, squashed=kind == "squashed")
    actions, logp, values = act_plain(packed, torch.from_numpy(obs), (0, 0), deterministic=True)
    jdist, jvalues = _flax_dist(jmodel, params, obs, cont._jdist(kind))
    np.testing.assert_allclose(actions.numpy(), np.asarray(jdist.deterministic_sample()), rtol=RTOL, atol=ATOL)
    keep = np.abs(np.asarray(jdist.features["mean"])).max(1) < SQUASH_LIMIT
    assert keep.mean() > 0.25
    np.testing.assert_allclose(logp.numpy()[keep], np.asarray(jdist.logp(jnp.asarray(actions.numpy())))[keep],
                               rtol=RTOL, atol=LOGP_ATOL)
    np.testing.assert_allclose(values.numpy(), jvalues, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# The update kernel's plain version
# ----------------------------------------------------------------------


@pytest.mark.parametrize("layers", DEPTHS)
@pytest.mark.parametrize("use_entropy,dual", disc.CASES, ids=["plain", "entropy-dual"])
def test_discrete_update_plain_matches_jax_grad_and_pallas(use_entropy: bool, dual, layers: int) -> None:
    """``ppo_grads_plain`` for the discrete model at 9 and 12 layers:
    losses, KL and every gradient against ``jax.grad`` of ``ppo_losses``
    through the flax model (f32 tolerances, as tests/test_torch_update.py
    holds them at two layers) and against ``rl8_tpu``'s
    ``_discrete_kernel`` in interpret mode: the losses at its bf16
    tolerances, the gradients through float64 (``_assert_f64_rule``)."""
    jmodel, params, model, batch = disc._setup(hiddens=_deep(layers), seed=layers)
    ec = 0.013 if use_entropy else 0.0
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        f, v = jmodel.apply({"params": p}, jbatch[DataKeys.VIEWS])
        dist = JCategorical(f, jmodel)
        losses = disc.jax_ppo_losses(jbatch, v, dist, entropy_coeff=ec, **disc._loss_kw(dual))
        lr = dist.logp(jbatch[DataKeys.ACTIONS]) - jbatch[DataKeys.LOGP]
        return losses["total"] / disc.ACCUM, (losses, jnp.mean((jnp.exp(lr) - 1) - lr))

    (_, (ref_losses, ref_kl)), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    losses, kl, grads = disc._port_grads(model, batch, use_entropy, dual)
    for k in ("entropy", "policy", "vf", "total"):
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]), rtol=disc.F32_LOSS_RTOL,
                                   atol=disc.F32_LOSS_ATOL, err_msg=k)
    np.testing.assert_allclose(float(kl), float(ref_kl), rtol=disc.F32_LOSS_RTOL, atol=disc.F32_LOSS_ATOL)
    cont._assert_grads(grads, ref_grads, disc.F32_GRAD_REL)

    jpacked, junpack = jax_pack_rows(jbatch)
    jcfg = JPPOLossConfig(clip_param=0.2, vf_clip_param=1.5, vf_coeff=0.9, dual_clip_param=dual, n_rows=disc.N,
                          accum=disc.ACCUM, use_entropy=use_entropy)
    p_losses, p_kl, p_grads = jax_fused_ppo_grads(jmodel, params, jpacked, junpack, ec, jcfg, interpret=True)
    for k in ("entropy", "policy", "vf", "total"):
        a, b = float(p_losses[k]), float(losses[k])
        assert abs(a - b) < disc.BF16_LOSS_REL * (abs(a) + 1e-2), (k, a, b)
    assert abs(float(p_kl) - float(kl)) < disc.BF16_LOSS_REL * (abs(float(p_kl)) + 1e-2)
    _, f64_grads = _f64_update(model, batch, disc._cfg(use_entropy, dual), ec)
    _assert_f64_rule(grads, f64_grads, p_grads, disc.F32_GRAD_REL)


@pytest.mark.parametrize("layers", DEPTHS)
@pytest.mark.parametrize("kind,ec,dual", [cont.CASES[1], cont.CASES[3]], ids=["normal-entropy-dual", "squashed-dual"])
def test_continuous_update_plain_matches_jax_grad_and_pallas(kind: str, ec: float, dual, layers: int) -> None:
    """``ppo_grads_plain`` for the continuous model (Normal with an entropy
    bonus, SquashedNormal) at 9 and 12 layers against ``jax.grad`` (f32, as
    tests/test_torch_continuous_update.py holds them at two layers) and
    ``rl8_tpu``'s ``_continuous_kernel`` in interpret mode (the losses at
    its bf16 tolerances, the gradients through float64)."""
    jmodel, params, model, batch = cont._setup(kind, hiddens=_deep(layers), seed=layers)
    ref_losses, ref_kl, ref_grads = cont._jax_autodiff(jmodel, params, batch, kind, ec, dual)
    losses, kl, grads = cont._port_grads(model, batch, kind, ec, dual)
    for k in ("entropy", "policy", "vf", "total"):
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]), rtol=cont.F32_LOSS_RTOL,
                                   atol=cont.F32_LOSS_ATOL, err_msg=k)
    np.testing.assert_allclose(float(kl), float(ref_kl), rtol=cont.F32_LOSS_RTOL, atol=cont.F32_LOSS_ATOL)
    cont._assert_grads(grads, ref_grads, cont.F32_GRAD_REL)

    jpacked, junpack = jax_pack_rows(jax.tree_util.tree_map(jnp.asarray, batch))
    jcfg = JPPOLossConfig(clip_param=0.2, vf_clip_param=1.5, vf_coeff=0.9, dual_clip_param=dual, n_rows=cont.N,
                          accum=cont.ACCUM, use_entropy=ec != 0.0, squashed=kind == "squashed")
    p_losses, p_kl, p_grads = jax_fused_ppo_grads(jmodel, params, jpacked, junpack, ec, jcfg, interpret=True)
    for k in ("entropy", "policy", "vf", "total"):
        a, b = float(p_losses[k]), float(losses[k])
        assert abs(a - b) < cont.BF16_LOSS_REL * (abs(a) + 1e-2), (k, a, b)
    _, f64_grads = _f64_update(model, batch, cont._cfg(kind, ec, dual), ec, squashed=kind == "squashed")
    _assert_f64_rule(grads, f64_grads, p_grads, cont.F32_GRAD_REL)


def _assert_f64_rule(grads, f64_grads, pallas_grads, tol: float) -> None:
    """Each gradient of ``grads`` within F64_K = 4 times the Pallas kernel's
    error off float64, plus ``tol`` of its norm (chip_smoke.py's
    compare_ppo_f64 rule): at depth the kernel's bf16 products drift past
    the bf16 tolerances the two-layer tests set."""
    for path, want in jax.tree_util.tree_leaves_with_path(f64_grads):
        got, pallas = grads, pallas_grads
        for key in path:
            got, pallas = got[key.key], pallas[key.key]
        want = np.asarray(want, np.float64)
        err, pallas_err = np.linalg.norm(got - want), np.linalg.norm(np.asarray(pallas, np.float64) - want)
        assert err <= 4.0 * pallas_err + tol * np.linalg.norm(want), jax.tree_util.keystr(path)


def _f64_update(model, batch, cfg, ec: float, squashed: bool = False):
    """The plain update on float64 parameters (returned rounded to f32) as
    a flax tree, and its losses."""
    from rl8_tpu_torch.ops import pack_act_params, pack_rows, ppo_grads_plain
    from rl8_tpu_torch.ops.fused_act import ActParams
    from rl8_tpu_torch.ops.fused_mlp import load_flat_params

    params = pack_act_params(model, squashed=squashed)
    params = ActParams(**{**params.__dict__, "flat": params.flat.double()})
    packed, unpack = pack_rows(disc._torch_tree(batch))
    losses, _, flat = ppo_grads_plain(params, packed, unpack, torch.tensor(ec), cfg)
    grad_model = type(model)(model.observation_spec, model.action_spec, hiddens=model.hiddens,
                             activation_fn=model.activation_fn)
    load_flat_params(grad_model, flat.float())
    return losses, to_jax_params(grad_model)


def test_supports_fused_update_takes_any_depth_as_rl8_tpu() -> None:
    """The update gate is ``rl8_tpu``'s: no depth term, at 9, 16 and 100
    layers, for both default models."""
    from rl8_tpu.ops.fused_ppo import supports_fused_update as jax_supports_fused_update
    from rl8_tpu_torch.distributions import Categorical, Normal
    from rl8_tpu_torch.models import DefaultContinuousModel

    for layers in (9, 16, 100):
        hiddens = (4,) * layers
        with torch.device("meta"):
            discrete = DefaultDiscreteModel(Unbounded(3), Discrete(2, shape=(1,)), hiddens=hiddens)
            continuous = DefaultContinuousModel(Unbounded(3), Unbounded(2), hiddens=hiddens)
        assert supports_fused_update(discrete, Categorical)
        assert supports_fused_update(continuous, Normal)
        jmodel = JDiscreteModel(JUnbounded(3), JDiscrete(2, shape=(1,)), hiddens=hiddens)
        assert jax_supports_fused_update(jmodel, JCategorical)


# ----------------------------------------------------------------------
# step() and the route flags
# ----------------------------------------------------------------------


#: ``(layers, optimizer)``: Adam at 9 layers; SGD at 16, where many
#: gradient entries of the deep narrow torso are rounding noise near 0
#: (dead relu units above them), which Adam scales up to steps of lr in
#: either package alike (tests/test_torch_step.py's note), so that the
#: parameters' change holds the gradients themselves.
STEP_CASES = [(9, "adam"), (16, "sgd")]


@pytest.mark.parametrize("layers,optimizer", STEP_CASES, ids=["9-adam", "16-sgd"])
def test_step_matches_jax_at_depth(layers: int, optimizer: str) -> None:
    """A whole-buffer ``step()`` of the discrete model at 9 and 16 layers of
    8, from the same numpy weights and buffer as ``rl8_tpu``'s: the port
    takes the act and update kernels' routes (their plain versions here),
    as ``rl8_tpu`` takes its kernels, and the losses and parameters agree
    (tests/test_torch_step.py's tolerances)."""
    import optax

    config = dict(num_envs=64, horizon=8, model_config={"hiddens": (8,) * layers}, seed=3, entropy_coeff=0.01)
    jconfig, tconfig = dict(config), dict(config)
    if optimizer == "sgd":
        jconfig.update(optimizer_cls=optax.sgd, optimizer_config={"lr": 0.05})
        tconfig.update(optimizer_cls=torch.optim.SGD, optimizer_config={"lr": 0.05})
    jalgo = JAlgorithmConfig(**jconfig).build(jenv.DiscreteDummyEnv)
    params0 = _jax_params(jalgo)
    talgo = AlgorithmConfig(**tconfig, device="cpu").build(tenv.DiscreteDummyEnv)
    assert (talgo._fused_act, talgo._fused_update) == (True, True)
    load_jax_params(talgo.policy.model, params0)
    jalgo.collect()
    _copy_rollout(jalgo, talgo)
    jstats, tstats = jalgo.step(), talgo.step()
    for key in STAT_KEYS:
        assert math.isclose(tstats[key], jstats[key], rel_tol=STAT_RTOL, abs_tol=STAT_ATOL), (key, tstats[key], jstats[key])
    start = _flat(params0)
    jdelta = _flat(jax.device_get(jalgo.state.params)) - start
    tdelta = _flat(to_jax_params(talgo.policy.model)) - start
    assert np.linalg.norm(jdelta) > 0
    assert np.linalg.norm(tdelta - jdelta) <= DELTA_REL * np.linalg.norm(jdelta)


#: ``(hiddens, fused_forward)``: 9 and 16 narrow layers, and at 512 wide the
#: gate's deepest admitted model (22 layers) and the first it refuses (23).
ROUTE_CASES = [((8,) * 9, False), ((8,) * 16, False), ((8,) * 16, True), ((512,) * 22, False), ((512,) * 23, True)]


@pytest.mark.parametrize("hiddens,fused_forward", ROUTE_CASES, ids=["9", "16", "16-fused-forward", "512x22", "512x23"])
def test_route_flags_match_jax_at_depth(hiddens: tuple, fused_forward: bool, monkeypatch) -> None:
    """The port's ``_fused_act``, ``_fused_update`` and ``_fused_forward``
    equal ``rl8_tpu``'s at 9 and 16 layers, at the deepest 512-wide model
    its residency gate admits and at the first it refuses (the module
    routes)."""
    config = dict(num_envs=4, horizon=8, model_config={"hiddens": hiddens}, fused_forward=fused_forward)
    want = _jax_flags(JAlgorithm, jenv.DiscreteDummyEnv, JAlgorithmConfig(**config), monkeypatch)
    talgo = AlgorithmConfig(**config, device="cpu").build(tenv.DiscreteDummyEnv)
    assert (talgo._fused_act, talgo._fused_update, talgo._fused_forward) == want
    assert want[:2] == ((True, True) if len(hiddens) != 23 else (False, False))
    assert model_fits_vmem(talgo.policy.model) == (len(hiddens) != 23)


# ----------------------------------------------------------------------
# The chain kernels' plain versions
# ----------------------------------------------------------------------


def _five_chains(width: int) -> tuple:
    """5 chains of 12 layers (LayerNorm on every other layer of chains 0, 2
    and 4, on every layer of chain 1, none on chain 3) and 6 heads over
    them, ragged: 2 and 1 on chain 0, 1 each on chains 1 to 3, and a 9-wide
    one on chain 4 (heads 1 to 9 wide)."""
    lns = [[l % 2 == 0 for l in range(12)], [True] * 12, [l % 2 == 1 for l in range(12)], [False] * 12,
           [l % 2 == 0 for l in range(12)]]
    heads = [[2, 1], [3], [1], [4], [9]]
    return tuple(([(width - c % 2, ln) for ln in lns[c]], heads[c]) for c in range(5))


def test_five_deep_chains_match_pallas_f32_path() -> None:
    """5 chains of 12 layers and 6 ragged heads at widths 6 and 5 (below
    8, where ``rl8_tpu``'s Pallas kernels compute in f32): head outputs, dx
    and every gradient of sum(sin(outs)) through the port's
    ``fused_chains`` (the plain versions and autograd) against
    ``rl8_tpu``'s in interpret mode, at tests/test_torch_chains.py's f32
    tolerances."""
    from tests.test_torch_chains import F32_FWD_ATOL, F32_GRAD_ATOL

    chains = _random_chains(31, 7, _five_chains(6))
    x = np.random.default_rng(2).normal(size=(21, 7)).astype(np.float32)
    j_outs, j_dx, j_grads = _jax_loss_and_grads(_pallas_forward, x, chains)
    t_outs, t_dx, t_grads = _torch_loss_and_grads("relu", x, chains)
    assert len(t_outs) == len(j_outs) == 6
    for j, t in zip(j_outs, t_outs):
        np.testing.assert_allclose(t, j, atol=F32_FWD_ATOL)
    np.testing.assert_allclose(t_dx, j_dx, atol=F32_GRAD_ATOL)
    assert len(t_grads) == len(j_grads)
    for j, t in zip(j_grads, t_grads):
        np.testing.assert_allclose(t, j, atol=F32_GRAD_ATOL)


def _f64_loss_and_grads(x, chains):
    """The float64 reference: outputs, dx and every gradient of
    sum(sin(outs)) through the plain forward (``forward_chains``) and
    autograd, in float64."""
    from rl8_tpu_torch.ops import forward_chains

    tx = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    tchains = _to(chains, lambda p: torch.tensor(p, dtype=torch.float64, requires_grad=True))
    outs, _ = forward_chains(tx, tchains, "relu")
    sum(torch.sin(o).sum() for chain in outs for o in chain).backward()
    return ([o.detach().numpy() for chain in outs for o in chain], tx.grad.numpy(),
            [p.grad.numpy() for p in _leaves(tchains)])


def test_five_deep_chains_match_pallas_bf16_path_and_jax_grad() -> None:
    """The same structure at widths 16 and 15, against ``jax.grad`` of a
    plain ``jnp`` forward in f32 and against ``rl8_tpu``'s Pallas kernels in
    interpret mode (they multiply in bf16 from 8 wide). Down 12 LayerNorm
    layers rounding grows past the tolerances that
    tests/test_torch_chains_wide.py sets for one to three layers: f32's in
    both packages alike (the first layer's gradient lands ~2e-5 of its norm
    off the other f32 sum), bf16's in the Pallas kernels (outputs up to 0.6
    relative off the f32 ones on rows near 0). So, as chip_smoke.py's
    compare_ppo_f64 holds an update, the port's outputs, dx and gradients
    are held to a float64 reference: each one's error off float64 within
    F64_K = 4 times the other package's, plus F32_GRAD_NORM of its norm;
    outputs and dx also keep the f32 tolerance against ``jax.grad``'s."""
    chains = _random_chains(32, 7, _five_chains(16))
    x = np.random.default_rng(3).normal(size=(19, 7)).astype(np.float32)
    t_all = _torch_loss_and_grads("relu", x, chains)
    f_all = _f64_loss_and_grads(x, chains)
    for forward in (_plain_jnp_forward, _pallas_forward):
        j_all = _jax_loss_and_grads(forward, x, chains)
        if forward is _plain_jnp_forward:
            for j, t in [*zip(j_all[0], t_all[0]), (j_all[1], t_all[1])]:
                np.testing.assert_allclose(t, j, rtol=0, atol=F32_OUT_REL * np.max(np.abs(j)))
        t_flat = [*t_all[0], t_all[1], *t_all[2]]
        j_flat = [*j_all[0], j_all[1], *j_all[2]]
        f_flat = [*f_all[0], f_all[1], *f_all[2]]
        assert len(t_flat) == len(j_flat) == len(f_flat)
        for j, t, f in zip(j_flat, t_flat, f_flat):
            err, ref = np.linalg.norm(t - f), np.linalg.norm(f)
            assert err <= 4.0 * np.linalg.norm(np.asarray(j, np.float64) - f) + F32_GRAD_NORM * ref, (forward, t.shape)


# ----------------------------------------------------------------------
# A custom model of five chains
# ----------------------------------------------------------------------

#: The five chains' torsos (their LayerNorm) and heads (name, width).
QUINTET = (
    ("torso_0", True, (("head_0a", 2), ("head_0b", 2))),
    ("torso_1", False, (("head_1", 1),)),
    ("torso_2", True, (("head_2", 2),)),
    ("torso_3", False, (("head_3", 1),)),
    ("torso_4", True, (("head_4a", 1), ("head_4b", 2))),
)
#: The heads summed into the logits (``[B, 1, 2]``) and into the value.
LOGIT_HEADS = ("head_0a", "head_0b", "head_2", "head_4b")
VALUE_HEADS = ("head_1", "head_3", "head_4a")


def _quintet_outputs(outs: dict) -> tuple:
    logits = sum(outs[name] for name in LOGIT_HEADS).reshape(-1, 1, 2)
    return {"logits": logits}, sum(outs[name] for name in VALUE_HEADS)


class JQuintet(JGenericModel):
    """``rl8_tpu``'s side: five relu MLP torsos (alternating LayerNorm) on
    the observations, seven linear heads; the logits and the value are
    sums of heads. Declares a ``FusedApplySpec``."""

    hiddens: tuple = (8, 8)
    activation_fn: str = "relu"

    @property
    def view_requirements(self) -> dict:
        return {JDataKeys.OBS: JViewRequirement(shift=0)}

    @fnn.compact
    def __call__(self, batch):
        x = batch[JDataKeys.OBS]
        outs = {}
        for torso, ln, heads in QUINTET:
            h = jax.nn.relu(JMLP(self.hiddens, activation_fn="relu", layer_norm=ln, name=torso)(x))
            for name, width in heads:
                outs[name] = fnn.Dense(width, name=name)(h)
        return _quintet_outputs(outs)

    def fused_apply_spec(self):
        def finalize(batch, chain_outs):
            flat = [o for chain in chain_outs for o in chain]
            names = [name for _, _, heads in QUINTET for name, _ in heads]
            return _quintet_outputs(dict(zip(names, flat)))

        return JFusedApplySpec(
            assemble=lambda params, batch: batch[JDataKeys.OBS],
            finalize=finalize,
            chain_names=tuple((torso, tuple(name for name, _ in heads)) for torso, _, heads in QUINTET),
        )


class Quintet(GenericModel):
    """The port's side of :class:`JQuintet`."""

    def __init__(self, observation_spec, action_spec, /, *, hiddens=(8, 8)) -> None:
        super().__init__(observation_spec, action_spec)
        self.hiddens = tuple(hiddens)
        self.activation_fn = "relu"
        d_in = observation_spec.shape[0]
        for torso, ln, heads in QUINTET:
            setattr(self, torso, MLP(d_in, self.hiddens, activation_fn="relu", layer_norm=ln))
            for name, width in heads:
                setattr(self, name, torch.nn.Linear(self.hiddens[-1], width))

    @property
    def view_requirements(self) -> dict:
        return {DataKeys.OBS: ViewRequirement(shift=0)}

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, torch.nn.Linear):
                    lecun_normal_(module.weight, generator)
                    module.bias.zero_()
                elif isinstance(module, torch.nn.LayerNorm):
                    module.reset_parameters()

    def forward(self, batch):
        x = batch[DataKeys.OBS]
        outs = {}
        for torso, _, heads in QUINTET:
            h = torch.relu(getattr(self, torso)(x))
            for name, _ in heads:
                outs[name] = getattr(self, name)(h)
        return _quintet_outputs(outs)

    def fused_apply_spec(self) -> FusedApplySpec:
        def finalize(batch, chain_outs):
            flat = [o for chain in chain_outs for o in chain]
            names = [name for _, _, heads in QUINTET for name, _ in heads]
            return _quintet_outputs(dict(zip(names, flat)))

        return FusedApplySpec(
            assemble=lambda batch: batch[DataKeys.OBS],
            finalize=finalize,
            chain_names=tuple((torso, tuple(name for name, _ in heads)) for torso, _, heads in QUINTET),
        )


def test_five_chain_custom_model_collects_and_steps_as_jax(monkeypatch) -> None:
    """A custom model of 5 chains (7 heads) with ``fused_forward``, built in
    both packages from the same weights: both route it to their chain
    kernels (the port's plain versions here), the rollout's log-probs and
    values agree with ``rl8_tpu``'s forward of the same observations, and
    one whole-buffer ``step()`` from the same buffer gives the same losses
    and parameters (tests/test_torch_step.py's tolerances)."""
    config = dict(num_envs=32, horizon=8, model_config={"hiddens": (8, 8)}, seed=3, fused_forward=True)
    assert _jax_flags(JAlgorithm, jenv.DiscreteDummyEnv, JAlgorithmConfig(model_cls=JQuintet, **config), monkeypatch)[2]
    jalgo = JAlgorithmConfig(model_cls=JQuintet, **config).build(jenv.DiscreteDummyEnv)
    params0 = jax.device_get(jalgo.state.params)
    talgo = AlgorithmConfig(model_cls=Quintet, device="cpu", **config).build(tenv.DiscreteDummyEnv)
    assert talgo._fused_forward
    load_jax_params(talgo.policy.model, params0)
    # The rollout through the chain kernels' plain forward.
    talgo.collect()
    buf = talgo.state.buffer
    obs = buf[DataKeys.OBS][: config["horizon"]].reshape(-1, 1).numpy()
    feats, values = jalgo.policy.model.apply({"params": params0}, {JDataKeys.OBS: jnp.asarray(obs)})
    jdist = JCategorical(feats)
    actions = buf[DataKeys.ACTIONS][: config["horizon"]].reshape(-1, 1).numpy()
    np.testing.assert_allclose(buf[DataKeys.LOGP][: config["horizon"]].reshape(-1, 1).numpy(),
                               np.asarray(jdist.logp(jnp.asarray(actions))).reshape(-1, 1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(buf[DataKeys.VALUES][: config["horizon"]].reshape(-1, 1).numpy(),
                               np.asarray(values).reshape(-1, 1), rtol=1e-5, atol=1e-5)
    # One step from rl8_tpu's buffer.
    jalgo.collect()
    _copy_rollout(jalgo, talgo)
    jstats, tstats = jalgo.step(), talgo.step()
    for key in STAT_KEYS:
        assert math.isclose(tstats[key], jstats[key], rel_tol=STAT_RTOL, abs_tol=STAT_ATOL), (key, tstats[key], jstats[key])
    start = _flat(params0)
    jdelta = _flat(jax.device_get(jalgo.state.params)) - start
    tdelta = _flat(to_jax_params(talgo.policy.model)) - start
    assert np.linalg.norm(jdelta) > 0
    assert np.linalg.norm(tdelta - jdelta) <= DELTA_REL * np.linalg.norm(jdelta)
