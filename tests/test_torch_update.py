"""The update kernel's plain version (``rl8_tpu_torch.ops.fused_ppo``) and
the row packing that feeds it, held against ``rl8_tpu`` on the CPU: against
``jax.grad`` of ``rl8_tpu.nn.ppo_losses`` through the flax model, against
``rl8_tpu``'s Pallas kernel in interpret mode, and against
``torch.autograd`` through the port's own ``ppo_losses``. The CUDA kernel
itself is held against this plain version on the card by
``chip_smoke.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl8_tpu.distributions import Categorical as JCategorical
from rl8_tpu.models import DefaultDiscreteModel as JModel
from rl8_tpu.nn import ppo_losses as jax_ppo_losses
from rl8_tpu.ops import pack_rows as jax_pack_rows
from rl8_tpu.ops.fused_ppo import PPOLossConfig as JPPOLossConfig
from rl8_tpu.ops.fused_ppo import fused_ppo_grads as jax_fused_ppo_grads
from rl8_tpu.specs import Discrete as JDiscrete
from rl8_tpu.specs import Unbounded as JUnbounded
from rl8_tpu_torch.data import DataKeys
from rl8_tpu_torch.distributions import Categorical
from rl8_tpu_torch.models import DefaultDiscreteModel, load_jax_params, to_jax_params
from rl8_tpu_torch.nn import ppo_losses
from rl8_tpu_torch.ops import (
    PPOLossConfig,
    block_shuffle,
    fused_ppo_grads,
    pack_act_params,
    pack_rows,
    ppo_grads_plain,
    supports_fused_update,
)
from rl8_tpu_torch.ops.fused_act import ActParams
from rl8_tpu_torch.ops.fused_mlp import load_flat_params
from rl8_tpu_torch.specs import Discrete, Unbounded

#: f32 on both sides, sums in another order (XLA's vs ATen's reductions
#: and products over N rows): a few ulps of each gradient tensor's norm.
F32_GRAD_REL, F32_LOSS_RTOL, F32_LOSS_ATOL = 1e-5, 1e-5, 1e-6
#: Against the Pallas kernel, which multiplies the hidden layers in bf16:
#: the JAX package's own fused-vs-autodiff tolerances (tests/test_ops.py).
BF16_LOSS_REL, BF16_GRAD_REL = 2e-2, 8e-2

N, ACCUM = 53, 3
CASES = [(False, None), (True, 3.0)]  # (entropy bonus, dual clip)


def _norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _setup(A: int = 2, n: int = 4, d: int = 3, hiddens=(32, 16), activation: str = "relu", seed: int = 0):
    """The same model in both packages, flax-initialized and perturbed,
    and one minibatch of numpy inputs (ragged N, both packages' layout)."""
    jmodel = JModel(JUnbounded(d), JDiscrete(n, shape=(A,)), hiddens=hiddens, activation_fn=activation)
    params = jmodel.init(jax.random.key(seed), {"obs": jnp.zeros((1, d))})["params"]
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32)) for p in leaves]
    )
    model = DefaultDiscreteModel(Unbounded(d), Discrete(n, shape=(A,)), hiddens=hiddens, activation_fn=activation)
    load_jax_params(model, jax.device_get(params))
    batch = {
        DataKeys.ACTIONS: rng.integers(0, n, size=(N, A)).astype(np.int32),
        DataKeys.LOGP: (0.1 * rng.normal(size=(N, 1))).astype(np.float32),
        DataKeys.ADVANTAGES: rng.normal(size=(N, 1)).astype(np.float32),
        DataKeys.RETURNS: rng.normal(size=(N, 1)).astype(np.float32),
        DataKeys.VIEWS: {DataKeys.OBS: rng.normal(size=(N, d)).astype(np.float32)},
    }
    return jmodel, params, model, batch


def _torch_tree(batch):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in batch.items()}


def _loss_kw(dual):
    return dict(clip_param=0.2, dual_clip_param=dual, vf_clip_param=1.5, vf_coeff=0.9)


def _cfg(use_entropy: bool, dual) -> PPOLossConfig:
    return PPOLossConfig(
        clip_param=0.2, vf_clip_param=1.5, vf_coeff=0.9, dual_clip_param=dual,
        n_rows=N, accum=ACCUM, use_entropy=use_entropy,
    )


def _port_grads(model, batch, use_entropy: bool, dual):
    params = pack_act_params(model)
    packed, unpack = pack_rows(_torch_tree(batch))
    ec = torch.tensor(0.013 if use_entropy else 0.0)
    losses, kl, flat = ppo_grads_plain(params, packed, unpack, ec, _cfg(use_entropy, dual))
    # The flat gradient in the flax tree's layout.
    grad_model = DefaultDiscreteModel(
        model.observation_spec, model.action_spec, hiddens=model.hiddens, activation_fn=model.activation_fn
    )
    load_flat_params(grad_model, flat)
    return losses, kl, to_jax_params(grad_model)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
@pytest.mark.parametrize("use_entropy,dual", CASES)
def test_plain_matches_jax_autodiff(use_entropy: bool, dual, activation: str) -> None:
    """Losses, KL and every gradient against ``jax.grad`` of
    ``ppo_losses(...)["total"] / accum`` through the flax model (the JAX
    package's CPU path), in f32."""
    jmodel, params, model, batch = _setup(activation=activation)
    ec = 0.013 if use_entropy else 0.0
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        f, v = jmodel.apply({"params": p}, jbatch[DataKeys.VIEWS])
        dist = JCategorical(f, jmodel)
        losses = jax_ppo_losses(jbatch, v, dist, entropy_coeff=ec, **_loss_kw(dual))
        lr = dist.logp(jbatch[DataKeys.ACTIONS]) - jbatch[DataKeys.LOGP]
        return losses["total"] / ACCUM, (losses, jnp.mean((jnp.exp(lr) - 1) - lr))

    (_, (ref_losses, ref_kl)), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    losses, kl, grads = _port_grads(model, batch, use_entropy, dual)
    for k in ("entropy", "policy", "vf", "total"):
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL, err_msg=k)
    np.testing.assert_allclose(float(kl), float(ref_kl), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL)
    for path, ref in jax.tree_util.tree_leaves_with_path(ref_grads):
        got = grads
        for key in path:
            got = got[key.key]
        assert _norm_rel(got, ref) < F32_GRAD_REL, jax.tree_util.keystr(path)


@pytest.mark.parametrize("use_entropy,dual", CASES)
def test_plain_matches_pallas_kernel_interpret(use_entropy: bool, dual) -> None:
    """Against ``rl8_tpu``'s fused update kernel run in interpret mode:
    it multiplies the hidden layers in bf16, hence bf16 tolerances."""
    jmodel, params, model, batch = _setup()
    ec = 0.013 if use_entropy else 0.0
    jpacked, junpack = jax_pack_rows(jax.tree_util.tree_map(jnp.asarray, batch))
    jcfg = JPPOLossConfig(
        clip_param=0.2, vf_clip_param=1.5, vf_coeff=0.9, dual_clip_param=dual,
        n_rows=N, accum=ACCUM, use_entropy=use_entropy,
    )
    ref_losses, ref_kl, ref_grads = jax_fused_ppo_grads(jmodel, params, jpacked, junpack, ec, jcfg, interpret=True)
    losses, kl, grads = _port_grads(model, batch, use_entropy, dual)
    for k in ("entropy", "policy", "vf", "total"):
        a, b = float(ref_losses[k]), float(losses[k])
        assert abs(a - b) < BF16_LOSS_REL * (abs(a) + 1e-2), (k, a, b)
    assert abs(float(ref_kl) - float(kl)) < BF16_LOSS_REL * (abs(float(ref_kl)) + 1e-2)
    for path, ref in jax.tree_util.tree_leaves_with_path(ref_grads):
        got = grads
        for key in path:
            got = got[key.key]
        assert _norm_rel(got, ref) < BF16_GRAD_REL, jax.tree_util.keystr(path)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
@pytest.mark.parametrize("use_entropy,dual", CASES)
def test_plain_matches_torch_autograd(use_entropy: bool, dual, activation: str) -> None:
    """The hand-derived backward against ``torch.autograd`` through the
    port's own ``ppo_losses`` (f32, the same ATen products)."""
    _, _, model, batch = _setup(activation=activation, seed=1)
    losses, kl, grads = _port_grads(model, batch, use_entropy, dual)
    tbatch = _torch_tree(batch)
    features, values = model(tbatch[DataKeys.VIEWS])
    dist = Categorical(features)
    ref = ppo_losses(tbatch, values, dist, entropy_coeff=0.013 if use_entropy else 0.0, **_loss_kw(dual))
    (ref["total"] / ACCUM).backward()
    for k in ref:
        np.testing.assert_allclose(float(losses[k]), float(ref[k].detach()), rtol=F32_LOSS_RTOL, atol=F32_LOSS_ATOL, err_msg=k)
    ref_grads = {
        name: {"kernel": linear.weight.grad.t().numpy(), "bias": linear.bias.grad.numpy()}
        for name, linear in (("feature_head", model.feature_head), ("vf_head", model.vf_head))
    }
    for torso in ("feature_model", "vf_model"):
        for i, layer in enumerate(getattr(model, torso).layers):
            ref_grads.setdefault(torso, {})[f"Dense_{i}"] = {
                "kernel": layer.weight.grad.t().numpy(), "bias": layer.bias.grad.numpy()
            }
    for path, want in jax.tree_util.tree_leaves_with_path(ref_grads):
        got = grads
        for key in path:
            got = got[key.key]
        assert _norm_rel(got, want) < F32_GRAD_REL, jax.tree_util.keystr(path)


def test_wrapper_on_cpu_runs_plain_and_validates() -> None:
    _, _, model, batch = _setup()
    params = pack_act_params(model)
    packed, unpack = pack_rows(_torch_tree(batch))
    cfg = _cfg(True, 3.0)
    ec = torch.tensor(0.013)
    before = fused_ppo_grads.launches
    got = fused_ppo_grads(params, packed, unpack, ec, cfg)
    want = ppo_grads_plain(params, packed, unpack, ec, cfg)
    assert fused_ppo_grads.launches == before  # the CPU path launches no kernel
    assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
    assert all(torch.equal(got[0][k], want[0][k]) for k in want[0])
    with pytest.raises(ValueError, match="n_rows"):
        fused_ppo_grads(params, packed[:10], unpack, ec, cfg)
    with pytest.raises(ValueError, match="int32"):
        fused_ppo_grads(params, packed.float(), unpack, ec, cfg)
    with pytest.raises(ValueError, match="0-d"):
        fused_ppo_grads(params, packed, unpack, torch.tensor([0.013]), cfg)
    with pytest.raises(ValueError, match="obs"):
        narrow = ActParams(**{**params.__dict__, "d_in": 2})
        fused_ppo_grads(narrow, packed, unpack, ec, cfg)
    with pytest.raises(ValueError, match="one device"):
        fused_ppo_grads(params, packed.to("meta"), unpack, ec, cfg)


def test_supports_fused_update_gating() -> None:
    spec_o, spec_a = Unbounded(3), Discrete(4, shape=(1,))
    assert supports_fused_update(DefaultDiscreteModel(spec_o, spec_a), Categorical)
    assert supports_fused_update(DefaultDiscreteModel(spec_o, spec_a, activation_fn="tanh"), Categorical)
    assert not supports_fused_update(DefaultDiscreteModel(spec_o, spec_a, activation_fn="gelu"), Categorical)
    assert not supports_fused_update(DefaultDiscreteModel(spec_o, spec_a, bias=False), Categorical)
    assert not supports_fused_update(DefaultDiscreteModel(spec_o, spec_a, hiddens=(8,) * 9), Categorical)

    class Custom(DefaultDiscreteModel):
        pass

    assert not supports_fused_update(Custom(spec_o, spec_a), Categorical)


# ----------------------------------------------------------------------
# Row packing
# ----------------------------------------------------------------------


def _numpy_tree(rows: int = 10):
    rng = np.random.default_rng(0)
    return {
        "f": rng.normal(size=(rows, 3)).astype(np.float32),
        "i": np.arange(rows, dtype=np.int32).reshape(rows, 1),
        "b": np.arange(rows) % 2 == 0,
        "nested": {"x": rng.normal(size=(rows, 2, 4)).astype(np.float32)},
        "scalar_rows": np.arange(rows, dtype=np.float32),
        "u8": (np.arange(rows) * 25).astype(np.uint8).reshape(rows, 1),
        "neg": np.array([-0.0, np.inf, -np.inf, np.nan, 1e-40, -1.5, 0, 0, 0, 0], np.float32)[:rows],
    }


def test_pack_rows_bit_exact_round_trip() -> None:
    """pack/unpack restores every leaf bit-exactly across dtypes (bf16
    and f16 widen to f32, bool and small ints to int32)."""
    tree = _torch_tree(_numpy_tree())
    tree["h"] = torch.randn(10, 2).to(torch.bfloat16)
    tree["g"] = torch.randn(10).to(torch.float16)
    packed, unpack = pack_rows(tree)
    assert packed.shape == (10, 3 + 1 + 1 + 8 + 1 + 1 + 1 + 2 + 1) and packed.dtype == torch.int32
    def bits(t: torch.Tensor) -> torch.Tensor:
        return t if t.dtype == torch.bool else t.contiguous().view(torch.uint8)

    for sel in (slice(None), slice(2, 5)):
        out = unpack(packed[sel])
        for key in tree:
            a = tree[key] if key != "nested" else tree[key]["x"]
            b = out[key] if key != "nested" else out[key]["x"]
            assert b.dtype == a.dtype and torch.equal(bits(a[sel]), bits(b)), key


def test_pack_rows_matches_jax_layout() -> None:
    """The same tree packs into the same int32 matrix in both packages:
    the leaf order (pytree order) and the bits agree, so a column range
    means the same leaf to both update kernels."""
    tree = _numpy_tree()
    jpacked, junpack = jax_pack_rows(jax.tree_util.tree_map(jnp.asarray, tree))
    packed, unpack = pack_rows(_torch_tree(tree))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert [(m.start, m.stop) for m in unpack.metas] == [(m.start, m.stop) for m in junpack.metas]
    assert unpack.leaf_index_tree() == junpack.leaf_index_tree()


def test_pack_rows_rejects_wide_dtypes() -> None:
    with pytest.raises(TypeError):
        pack_rows({"x": torch.zeros((4, 2), dtype=torch.float64)})


@pytest.mark.parametrize("blk", [1, 4])
def test_block_shuffle_permutes_whole_blocks(blk: int) -> None:
    rows = 32
    packed = torch.arange(rows * 3, dtype=torch.int32).view(rows, 3)
    gen = torch.Generator().manual_seed(0)
    out = block_shuffle(packed, gen, blk)
    assert out.shape == packed.shape and out.is_contiguous()
    # A permutation of the rows...
    assert sorted(out[:, 0].tolist()) == packed[:, 0].tolist()
    # ...that moves blocks of blk consecutive rows, in order inside each.
    first = out[:, 0].view(rows // blk, blk) // 3  # source row of each output row
    assert bool((first[:, 0] % blk == 0).all())
    assert torch.equal(first - first[:, :1], torch.arange(blk).expand(rows // blk, blk))
    assert not torch.equal(out, packed)
    # Seeded: the same generator state gives the same permutation.
    assert torch.equal(block_shuffle(packed, torch.Generator().manual_seed(0), blk), out)
    with pytest.raises(ValueError):
        block_shuffle(packed, gen, 5)
