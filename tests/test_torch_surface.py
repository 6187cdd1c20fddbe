"""The names of ``rl8_tpu``'s public surface that the port gained, held
against ``rl8_tpu`` on the CPU from numpy inputs of a seed: ``MLP``'s
dropout, ``OneHotEmbed``'s and ``one_hot_embed``'s ``dtype``, the MLflow
serving aliases, ``RecurrentModel.fused_apply_spec``, the abstract
``forward``/``init_params`` signatures and ``AlgorithmState.replace``;
then the slice as a whole: ``chip_smoke.py``'s surface model (a bf16
``OneHotEmbed`` in its input assembly, ``MLP(dropout=0.1)`` torsos called
deterministically, a ``FusedApplySpec`` over two narrow chains) against
its flax twin built from ``rl8_tpu``'s modules, through the module
forward and the chain kernels' plain versions, under the port's bf16 rule
(``tests/test_torch_amp.py``)."""

from __future__ import annotations

import doctest
import importlib
import math
from typing import Any, Sequence

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl8_tpu.data as jdata
import rl8_tpu.policies.serving as jserving
import rl8_tpu_torch.data as tdata
import rl8_tpu_torch.policies.serving as tserving
from chip_smoke import surface_model_cls
from examples.algotrading.env import AlgoTrading as JAlgoTrading
from examples.algotrading.models._common import action_mask_logits as jaction_mask_logits
from rl8_tpu.models import DefaultContinuousRecurrentModel as JContinuousRecurrent
from rl8_tpu.models import DefaultDiscreteRecurrentModel as JDiscreteRecurrent
from rl8_tpu.models import GenericModel as JGenericModel
from rl8_tpu.nn import MLP as JMLP
from rl8_tpu.nn import OneHotEmbed as JOneHotEmbed
from rl8_tpu.nn.modules.embeddings import one_hot_embed as jone_hot_embed
from rl8_tpu.specs import Discrete as JDiscreteSpec
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu.views import ViewRequirement as JViewRequirement
from rl8_tpu_torch import AlgorithmConfig
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.examples.algotrading import AlgoTrading
from rl8_tpu_torch.models import (
    DefaultContinuousRecurrentModel,
    DefaultDiscreteRecurrentModel,
    Model,
    RecurrentModel,
    load_jax_params,
    to_jax_params,
)
from rl8_tpu_torch.nn import MLP, OneHotEmbed
from rl8_tpu_torch.nn.modules.embeddings import one_hot_embed
from rl8_tpu_torch.ops import fused_custom_apply, supports_fused_apply, supports_fused_recurrent_apply
from rl8_tpu_torch.policies import Policy, RecurrentPolicy
from rl8_tpu_torch.policies._base import GenericPolicyBase
from rl8_tpu_torch.specs import Discrete, Unbounded
from rl8_tpu_torch.views import tree_map
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_algotrading import _mule_batch
from tests.test_torch_amp import BF16_REL, FLOOR, _hold, _unmasked

#: f32 MLP against flax's: the same products summed in other orders.
MLP_RTOL, MLP_ATOL = 1e-6, 1e-6
#: Dropout statistics: the allowed deviation of a zero share from the
#: rate, in standard deviations of a share of independent draws.
SIGMAS = 5.0
#: A survivor against the deterministic output times 1 / (1 - rate):
#: ``x / (1 - p)`` and ``x * (1 / (1 - p))`` round apart by an ulp.
SURVIVOR_RTOL = 1e-6


def _mlps(dropout: float, seed: int = 0):
    """``rl8_tpu``'s and the port's ``MLP((16, 16, 8), layer_norm=True,
    dropout=dropout)`` with the same perturbed flax parameters, and an
    input ``[32, 7]``."""
    x = np.random.default_rng(seed).normal(size=(32, 7)).astype(np.float32)
    jmlp = JMLP((16, 16, 8), layer_norm=True, dropout=dropout)
    params = jmlp.init(jax.random.key(seed), jnp.asarray(x))["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(seed + 1), len(leaves))
    params = jax.tree_util.tree_unflatten(treedef, [p + 0.2 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])
    tmlp = MLP(7, (16, 16, 8), layer_norm=True, dropout=dropout)
    load_jax_params(tmlp, jax.device_get(params))
    return jmlp, params, tmlp, x


@pytest.mark.parametrize("call", ["explicit", "default"])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_mlp_deterministic_matches_flax(dropout: float, call: str) -> None:
    """``MLP(dropout=...)`` called deterministically (``deterministic=True``
    or by default, ``True`` in both packages) computes ``rl8_tpu``'s
    output; with ``dropout=0.0`` a non-deterministic call computes the
    same, and any rate's deterministic output is bit for bit the one
    without dropout."""
    jmlp, params, tmlp, x = _mlps(dropout)
    kw = {"deterministic": True} if call == "explicit" else {}
    want = np.asarray(jmlp.apply({"params": params}, jnp.asarray(x), **kw))
    with torch.no_grad():
        got = tmlp(torch.from_numpy(x), **kw)
        plain = MLP(7, (16, 16, 8), layer_norm=True)
        plain.load_state_dict(tmlp.state_dict())
        assert torch.equal(got, plain(torch.from_numpy(x)))
        if not dropout:
            assert torch.equal(got, tmlp(torch.from_numpy(x), deterministic=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=MLP_RTOL, atol=MLP_ATOL)


def _zero_share(dropped: np.ndarray, det: np.ndarray, p: float) -> None:
    """Among the units ``det`` leaves nonzero, the share that ``dropped``
    zeroes lies within SIGMAS of ``p``; the rest are ``det / (1 - p)``."""
    live = det != 0
    n = int(live.sum())
    share = float(((dropped == 0) & live).sum()) / n
    assert abs(share - p) <= SIGMAS * math.sqrt(p * (1 - p) / n), (share, p, n)
    kept = dropped != 0
    assert not (kept & ~live).any()
    np.testing.assert_allclose(dropped[kept], det[kept] * (1.0 / (1.0 - p)), rtol=SURVIVOR_RTOL, atol=0.0)


@pytest.mark.parametrize("source", ["generator", "global"])
def test_mlp_dropout_statistics(source: str) -> None:
    """With ``deterministic=False`` the masks of the two packages differ by
    design, so both are held to the same statistics: an MLP whose last
    layer is the identity outputs its dropped-out hidden activation, whose
    zero share (among units relu leaves alive) is within 5 sigma of ``p``
    and whose survivors are the deterministic output times 1 / (1 - p).
    A seeded ``generator`` repeats its mask and another seed draws another;
    without one the draw comes from the global stream."""
    p, H = 0.3, 256
    x = np.random.default_rng(1).normal(size=(512, 7)).astype(np.float32)
    jmlp = JMLP((H, H), layer_norm=True, dropout=p)
    params = jax.device_get(jmlp.init(jax.random.key(0), jnp.asarray(x))["params"])
    params["Dense_1"] = {"kernel": np.eye(H, dtype=np.float32), "bias": np.zeros(H, np.float32)}
    jdet = np.asarray(jmlp.apply({"params": params}, jnp.asarray(x)))
    jdrop = np.asarray(jmlp.apply({"params": params}, jnp.asarray(x), deterministic=False,
                                  rngs={"dropout": jax.random.key(2)}))
    _zero_share(jdrop, jdet, p)

    tmlp = MLP(7, (H, H), layer_norm=True, dropout=p)
    load_jax_params(tmlp, params)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        det = tmlp(tx)
        if source == "generator":
            draw = lambda seed: tmlp(tx, deterministic=False, generator=torch.Generator().manual_seed(seed))  # noqa: E731
            a, b, c = draw(3), draw(3), draw(4)
            assert torch.equal(a, b) and not torch.equal(a, c)
        else:
            torch.manual_seed(3)
            a = tmlp(tx, deterministic=False)
    np.testing.assert_allclose(det.numpy(), jdet, rtol=MLP_RTOL, atol=MLP_ATOL)
    _zero_share(a.numpy(), det.numpy(), p)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_one_hot_embed_dtype_matches_flax(dtype: None | str) -> None:
    """``OneHotEmbed(..., dtype=...)`` and ``one_hot_embed(..., dtype)``
    against ``rl8_tpu``'s from one table: the same dtype out (f32 for
    ``None``, bf16 for bf16), the table an f32 parameter, and equal
    values: each output is one table entry rounded to ``dtype`` (the other
    products are zeros), so bf16 is exact too, tighter than the bf16 rule
    asks. The table's gradient is f32."""
    jdtype, tdtype = (None, None) if dtype is None else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(2)
    table = rng.normal(size=(3, 5)).astype(np.float32)
    idx = rng.integers(0, 3, size=(17,)).astype(np.int32)
    want = JOneHotEmbed(3, 5, dtype=jdtype).apply({"params": {"embedding": jnp.asarray(table)}}, jnp.asarray(idx))
    want_fn = jone_hot_embed(jnp.asarray(table), jnp.asarray(idx), dtype=jdtype)
    embed = OneHotEmbed(3, 5, dtype=tdtype)
    with torch.no_grad():
        embed.embedding.copy_(torch.from_numpy(table))
    got = embed(torch.from_numpy(idx))
    got_fn = one_hot_embed(torch.from_numpy(table), torch.from_numpy(idx), tdtype)
    assert embed.embedding.dtype == torch.float32
    for g, w in ((got, want), (got_fn, want_fn)):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(g.detach().float().numpy(), np.asarray(w, dtype=np.float32))
    got.float().sum().backward()
    assert embed.embedding.grad.dtype == torch.float32
    np.testing.assert_array_equal(embed.embedding.grad.numpy()[:, 0], np.bincount(idx, minlength=3))


def test_serving_aliases() -> None:
    """``MLflowPolicyModel`` and ``MLflowRecurrentPolicyModel`` are the
    serving classes under ``rl8_tpu``'s names, exported as there, and an
    alias serves a batch exactly as the class does."""
    assert tserving.MLflowPolicyModel is tserving.PolicyModel
    assert tserving.MLflowRecurrentPolicyModel is tserving.RecurrentPolicyModel
    assert jserving.MLflowPolicyModel is jserving.PolicyModel
    assert {"MLflowPolicyModel", "MLflowRecurrentPolicyModel"} <= set(tserving.__all__)
    obs = {DataKeys.OBS: np.random.default_rng(3).normal(size=(9, 2, 3)).astype(np.float32)}
    policy = Policy(Unbounded(3), Discrete(2, shape=(1,)), model_config={"hiddens": (8,)})
    policy.init_params(torch.Generator().manual_seed(0))
    got, want = tserving.MLflowPolicyModel(policy)._predict_arrays(obs), tserving.PolicyModel(policy)._predict_arrays(obs)
    rpolicy = RecurrentPolicy(Unbounded(3), Discrete(2, shape=(1,)), model_config={"hidden_size": 8})
    rpolicy.init_params(torch.Generator().manual_seed(1))
    rgot = tserving.MLflowRecurrentPolicyModel(rpolicy)._predict_arrays(obs)
    rwant = tserving.RecurrentPolicyModel(rpolicy)._predict_arrays(obs)
    for g, w in ((got, want), (rgot[0], rwant[0]), (rgot[1], rwant[1])):
        assert sorted(g) == sorted(w) and all(np.array_equal(g[k], w[k]) for k in w)
    assert len(got[DataKeys.ACTIONS]) == len(rgot[0][DataKeys.ACTIONS]) == 18


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_recurrent_fused_apply_spec_is_none(kind: str) -> None:
    """A default recurrent model's ``fused_apply_spec()`` is ``None`` in
    both packages, and the port's gates read it as before: no fused
    recurrent apply, and ``to_jax_params``/``load_jax_params`` round trip
    the model's tree."""
    jcls, tcls, action = {
        "discrete": (JDiscreteRecurrent, DefaultDiscreteRecurrentModel, (JDiscreteSpec(3, shape=(1,)), Discrete(3, shape=(1,)))),
        "continuous": (JContinuousRecurrent, DefaultContinuousRecurrentModel, (JUnbounded(2), Unbounded(2))),
    }[kind]
    jmodel = jcls(JUnbounded(4), action[0], hidden_size=8)
    tmodel = tcls(Unbounded(4), action[1], hidden_size=8)
    tmodel.reset_parameters(torch.Generator().manual_seed(0))
    assert jmodel.fused_apply_spec() is None and tmodel.fused_apply_spec() is None
    assert RecurrentModel.fused_apply_spec(tmodel) is None
    assert not supports_fused_recurrent_apply(tmodel)
    tree = to_jax_params(tmodel)
    twin = tcls(Unbounded(4), action[1], hidden_size=8)
    load_jax_params(twin, tree)
    for (name, a), b in zip(tmodel.state_dict().items(), twin.state_dict().values()):
        assert torch.equal(a, b), name


def test_abstract_signatures_match_reference() -> None:
    """The bases' abstract calls take ``rl8_tpu``'s parameters and raise
    ``NotImplementedError``: ``Model.forward(batch)``,
    ``RecurrentModel.forward(batch, states)`` and
    ``GenericPolicyBase.init_params(generator)``."""
    for call in (lambda: Model.forward(None, {}), lambda: RecurrentModel.forward(None, {}, {}),
                 lambda: GenericPolicyBase.init_params(None, torch.Generator())):
        with pytest.raises(NotImplementedError):
            call()


@pytest.mark.parametrize("recurrent", [False, True], ids=["feedforward", "recurrent"])
def test_state_replace_matches_flax(recurrent: bool) -> None:
    """``state.replace(horizons=3)`` returns a new state of the same class
    with that field changed and the others shared, and leaves the original
    as it was, as flax's ``PyTreeNode.replace`` does for ``rl8_tpu``'s."""
    buffer = {"obs": np.zeros(2)}
    extra = {"seqs": 5} if recurrent else {}
    jcls = jdata.RecurrentAlgorithmState if recurrent else jdata.AlgorithmState
    tcls = tdata.RecurrentAlgorithmState if recurrent else tdata.AlgorithmState
    jstate = jcls(params={}, opt_state=None, env_state={}, rng=jax.random.key(0), buffer=buffer, horizons=0,
                  buffered=False, reward_scale=1.0, **extra)
    tstate = tcls(env_state={}, buffer=buffer, **extra)
    for state in (jstate, tstate):
        new = state.replace(horizons=3)
        assert type(new) is type(state) and new is not state
        assert (new.horizons, state.horizons) == (3, 0)
        assert new.buffer is state.buffer and (not recurrent or new.seqs == state.seqs == 5)


@pytest.mark.parametrize("module_name", ["rl8_tpu_torch.nn.modules.mlp", "rl8_tpu_torch.nn.modules.embeddings"])
def test_repaired_module_doctests(module_name: str) -> None:
    results = doctest.testmod(importlib.import_module(module_name), optionflags=doctest.ELLIPSIS)
    assert results.failed == 0 and results.attempted > 0


# ----------------------------------------------------------------------
# The slice as a whole: chip_smoke.py's surface model against its flax twin
# ----------------------------------------------------------------------


class JSurfaceModel(JGenericModel):
    """The flax twin of ``chip_smoke.surface_model_cls``'s model, written
    with ``rl8_tpu``'s modules: ``OneHotEmbed(2, 2, dtype=dtype)``, twin
    ``MLP(hiddens, layer_norm=True, dropout=dropout)`` torsos called with
    ``deterministic=True``, heads of 3 and 1."""

    hiddens: Sequence[int] = (128, 128)
    dropout: float = 0.1
    seq_len: int = 4
    activation_fn: str = "relu"
    dtype: Any = jnp.bfloat16

    @property
    def view_requirements(self) -> dict:
        return {DataKeys.OBS: JViewRequirement(shift=0),
                (DataKeys.OBS, "LOG_CHANGE(price)"): JViewRequirement(shift=self.seq_len)}

    @fnn.compact
    def __call__(self, batch: Any) -> tuple[dict[str, jax.Array], jax.Array]:
        obs, L = batch[DataKeys.OBS], self.seq_len
        price = obs["LOG_CHANGE(price)"][DataKeys.INPUTS]
        sums = [price[:, : L // 4], price[:, : L // 2], price[:, -(L // 2):], price[:, -(L // 4):]]
        x = jnp.concatenate(
            [JOneHotEmbed(2, 2, dtype=self.dtype, name="invested_embedding")(obs["invested"].reshape(-1)),
             obs["LOG_CHANGE(price, position)"], *(jnp.sum(w, axis=1) for w in sums)],
            axis=-1,
        )
        if self.dtype is not None:
            x = x.astype(self.dtype)

        def chain(name: str, head: str, width: int) -> jax.Array:
            torso = JMLP(self.hiddens, layer_norm=True, dropout=self.dropout, dtype=self.dtype, name=name)
            return fnn.Dense(width, dtype=self.dtype, name=head)(jax.nn.relu(torso(x, deterministic=True)))

        logits = chain("feature_model", "feature_head", 3).reshape(-1, 1, 3).astype(jnp.float32)
        values = chain("vf_model", "vf_head", 1).astype(jnp.float32)
        return {"logits": logits + jaction_mask_logits(obs)}, values

    def fused_apply_spec(self) -> Any:
        """The same assembly on the raw tree through ``one_hot_embed(...,
        dtype=...)``, the twin chains through ``rl8_tpu``'s kernels."""
        from rl8_tpu.ops.fused_mlp import FusedApplySpec

        def assemble(params: Any, batch: Any) -> jax.Array:
            obs, L = batch[DataKeys.OBS], self.seq_len
            price = obs["LOG_CHANGE(price)"][DataKeys.INPUTS]
            sums = [price[:, : L // 4], price[:, : L // 2], price[:, -(L // 2):], price[:, -(L // 4):]]
            embed = jone_hot_embed(params["invested_embedding"]["embedding"], obs["invested"].reshape(-1), self.dtype)
            x = jnp.concatenate([embed, obs["LOG_CHANGE(price, position)"], *(jnp.sum(w, axis=1) for w in sums)], -1)
            return x if self.dtype is None else x.astype(self.dtype)

        def finalize(batch: Any, outs: Any) -> tuple[dict, jax.Array]:
            (logits,), (values,) = outs
            return {"logits": logits.reshape(-1, 1, 3) + jaction_mask_logits(batch[DataKeys.OBS])}, values

        return FusedApplySpec(assemble=assemble, finalize=finalize,
                              chain_names=(("feature_model", ("feature_head",)), ("vf_model", ("vf_head",))))


def _surface_models(hiddens=(32, 32), seed: int = 5):
    """rl8_tpu's twin in f32 and bf16 with the same perturbed parameters,
    the port's bf16 surface model with them, and a views batch."""
    jenv = JAlgoTrading(1)
    j32 = JSurfaceModel(jenv.observation_spec, jenv.action_spec, hiddens=hiddens, dtype=None)
    j16 = JSurfaceModel(jenv.observation_spec, jenv.action_spec, hiddens=hiddens)
    batch = _mule_batch(B=64, seed=seed)
    params = j16.init(jax.random.key(seed), jax.tree_util.tree_map(jnp.asarray, batch))["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(seed + 1), len(leaves))
    params = jax.tree_util.tree_unflatten(treedef, [p + 0.2 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])
    tenv = AlgoTrading(1, device="cpu")
    tmodel = surface_model_cls(torch)(tenv.observation_spec, tenv.action_spec, hiddens=hiddens)
    load_jax_params(tmodel, jax.device_get(params))
    return j32, j16, params, tmodel, batch


@pytest.mark.parametrize("route", ["module", "chains"])
def test_surface_model_matches_flax_twin(route: str) -> None:
    """The surface model from its flax twin's parameters (``load_jax_params``)
    against the twin under the bf16 rule, the twin's f32 apply the
    reference: the bf16 module forward against the twin's bf16 apply, and
    the chain kernels' plain versions (``fused_custom_apply``: the
    bf16-assembled input upcast to f32) against ``rl8_tpu``'s
    ``fused_custom_apply`` of the twin (its Pallas kernel in interpret
    mode on bf16 operands). The plain chain path computes in f32, where
    ``rl8_tpu``'s kernel multiplies bf16 operands, so it is held to the
    first half of the rule (at most twice ``rl8_tpu``'s error off the f32
    reference) and, in place of the second, to BF16_REL of the reference
    itself: ``rl8_tpu``'s bf16 chains land ~2.5% of the values' scale off
    it here, more than BF16_REL, while the port's f32 chains stay within
    ~0.6%. Outputs are f32; the tree comes back whole through
    ``to_jax_params``."""
    from rl8_tpu.ops.fused_mlp import fused_custom_apply as jfused_custom_apply

    j32, j16, params, tmodel, batch = _surface_models()
    assert tmodel.dtype is torch.bfloat16 and tmodel.feature_model.dropout == 0.1
    assert tmodel.invested_embedding.dtype is torch.bfloat16
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    ref = j32.apply({"params": params}, jbatch)
    tbatch = tree_map(torch.from_numpy, batch)
    if route == "module":
        want = j16.apply({"params": params}, jbatch)
        with torch.no_grad():
            got = tmodel(tbatch)
    else:
        assert supports_fused_apply(tmodel)
        want = jfused_custom_apply(j16, params, jbatch, interpret=True)
        got = fused_custom_apply(tmodel, tbatch)
    assert got[0]["logits"].dtype == got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[0]["logits"].detach().numpy() < -1e37, np.asarray(want[0]["logits"]) < -1e37)
    for g, w, r in zip(_unmasked(got), _unmasked(want), _unmasked(ref)):
        if route == "module":
            _hold(g, w, r, route)
        else:
            scale = max(np.abs(r).max(), 1e-3)
            assert np.abs(g - r).max() <= 2.0 * np.abs(w - r).max() + FLOOR * scale, route
            assert np.abs(g - r).max() <= BF16_REL * scale, (route, np.abs(g - r).max(), scale)
    back = to_jax_params(tmodel)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jax.device_get(params)), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(path))


def test_surface_model_trains_on_the_chains() -> None:
    """The surface model trains with ``fused_forward=True`` on the CPU
    (the chain kernels' plain versions), as chip_smoke.py's surface phase
    drives it on the card at full size: finite stats and parameters."""
    algo = AlgorithmConfig(model_cls=surface_model_cls(torch), fused_forward=True, num_envs=32, horizon=8,
                           sgd_minibatch_size=64, model_config={"hiddens": (16, 16)}, device="cpu").build(AlgoTrading)
    assert algo._fused_forward and not (algo._fused_act or algo._fused_update)
    for _ in range(2):
        algo.collect()
        stats = algo.step()
    assert all(math.isfinite(v) for v in stats.values())
    assert all(bool(torch.isfinite(p).all()) for p in algo.policy.model.parameters())
