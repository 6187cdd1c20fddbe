"""The chain kernels' plain versions (``rl8_tpu_torch/ops/fused_mlp.py``)
held against ``rl8_tpu``'s ``fused_chains`` (the Pallas kernels in
interpret mode) and a flax ``MLP(layer_norm=True)`` on the CPU, plus the
autograd op, the zero-variance LayerNorm, the layout helpers, the
wrappers' refusals and the fused-apply gating."""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl8_tpu.nn import MLP as JMLP
from rl8_tpu.ops.fused_mlp import _call_fwd as jax_call_fwd
from rl8_tpu.ops.fused_mlp import fused_chains as jax_fused_chains
from rl8_tpu_torch.nn import MLP
from rl8_tpu_torch.ops import chains_vjp_plain, forward_chains, fused_chains, fused_chains_bwd, fused_chains_fwd
from rl8_tpu_torch.ops.fused_mlp import (
    FusedApplySpec,
    chain_structure,
    flatten_chains,
    named_chains,
    supports_fused_apply,
    unflatten_chains,
)

#: Widths below 8 take the Pallas kernels' exact f32 VPU loops: the
#: tolerances of ``tests/test_ops.py``'s LayerNorm chain test.
F32_FWD_ATOL, F32_GRAD_ATOL = 5e-6, 2e-5
#: Wider products run on the MXU in bf16 in the Pallas kernels: its
#: ``_rel_close`` and ``_norm_close`` tolerances.
BF16_REL, BF16_NORM = 2e-2, 8e-2


def _random_chains(seed: int, d_in: int, layout) -> tuple:
    """numpy chains of ``layout`` (per chain ``[(width, layer_norm), ...]``
    and the head widths): lecun-scale weights, small biases, LayerNorm
    scales around 1."""
    rng = np.random.default_rng(seed)
    chains = []
    for layers, heads in layout:
        k, built = d_in, []
        for width, has_ln in layers:
            layer = [rng.normal(size=(k, width)) / np.sqrt(k), 0.1 * rng.normal(size=width)]
            if has_ln:
                layer += [0.5 + rng.uniform(size=width), 0.1 * rng.normal(size=width)]
            built.append(tuple(np.asarray(p, np.float32) for p in layer))
            k = width
        head = tuple(
            (np.asarray(rng.normal(size=(k, w)) / np.sqrt(k), np.float32), np.asarray(0.1 * rng.normal(size=w), np.float32))
            for w in heads
        )
        chains.append((tuple(built), head))
    return tuple(chains)


def _to(chains, fn):
    return tuple((tuple(tuple(fn(p) for p in layer) for layer in layers), tuple(tuple(fn(p) for p in h) for h in heads))
                 for layers, heads in chains)


def _leaves(chains) -> list:
    return [p for layers, heads in chains for tensors in (*layers, *heads) for p in tensors]


def _jax_loss_and_grads(activation, x, chains):
    """Head outputs, and the gradients of sum(sin(outs)) in x and every
    parameter, through ``rl8_tpu``'s ``fused_chains`` in interpret mode."""
    jx, jchains = jnp.asarray(x), _to(chains, jnp.asarray)

    def loss(c, xx):
        return sum(jnp.sum(jnp.sin(o)) for outs in jax_fused_chains(activation, True, xx, c) for o in outs)

    outs = jax_fused_chains(activation, True, jx, jchains)
    g_chains, g_x = jax.grad(loss, argnums=(0, 1))(jchains, jx)
    return [np.asarray(o) for chain in outs for o in chain], np.asarray(g_x), [np.asarray(g) for g in _leaves(g_chains)]


def _torch_loss_and_grads(activation, x, chains):
    """The same through the port's ``fused_chains`` (the plain versions on
    the CPU) and autograd."""
    tx = torch.tensor(x, requires_grad=True)
    tchains = _to(chains, lambda p: torch.tensor(p, requires_grad=True))
    outs = fused_chains(activation, tx, tchains)
    sum(torch.sin(o).sum() for chain in outs for o in chain).backward()
    return ([o.detach().numpy() for chain in outs for o in chain], tx.grad.numpy(),
            [p.grad.numpy() for p in _leaves(tchains)])


_F32_CASES = {
    # ids: layer norms, activation, heads, d_in, ragged N
    "ln-relu-2heads-din7": (7, 37, "relu", (([(5, True), (6, False)], [3, 1]), ([(4, True)], [2]))),
    "noln-tanh-din1": (1, 21, "tanh", (([(6, False), (5, False)], [2]), ([(3, False)], [1]))),
    "ln-tanh-3chains-din7": (7, 16, "tanh", (([(7, True), (7, True)], [1]), ([(5, False)], [4]), ([(3, True)], [1]))),
    "ln-relu-din1": (1, 9, "relu", (([(4, True), (6, True), (5, False)], [2, 2]),)),
}


@pytest.mark.parametrize("case", list(_F32_CASES), ids=list(_F32_CASES))
def test_plain_chains_match_pallas_f32_path(case: str) -> None:
    """Widths below 8, where the Pallas kernels compute in f32: forward,
    dx and every parameter gradient."""
    d_in, N, act, layout = _F32_CASES[case]
    chains = _random_chains(list(_F32_CASES).index(case), d_in, layout)
    x = np.random.default_rng(1).normal(size=(N, d_in)).astype(np.float32)
    j_outs, j_dx, j_grads = _jax_loss_and_grads(act, x, chains)
    t_outs, t_dx, t_grads = _torch_loss_and_grads(act, x, chains)
    for j, t in zip(j_outs, t_outs):
        np.testing.assert_allclose(t, j, atol=F32_FWD_ATOL)
    np.testing.assert_allclose(t_dx, j_dx, atol=F32_GRAD_ATOL)
    assert len(t_grads) == len(j_grads)
    for j, t in zip(j_grads, t_grads):
        np.testing.assert_allclose(t, j, atol=F32_GRAD_ATOL)


def test_plain_chains_match_pallas_bf16_path() -> None:
    """Widths of 8 and more (MischievousMule's layout at 32 wide), where
    the Pallas kernels multiply in bf16: their own tolerances."""
    layout = (([(32, True), (32, False)], [3]), ([(32, True), (32, False)], [1]))
    chains = _random_chains(3, 7, layout)
    x = np.random.default_rng(2).normal(size=(40, 7)).astype(np.float32)
    j_outs, j_dx, j_grads = _jax_loss_and_grads("relu", x, chains)
    t_outs, t_dx, t_grads = _torch_loss_and_grads("relu", x, chains)

    def rel_close(a, b):
        np.testing.assert_allclose(b, a, atol=BF16_REL * (np.max(np.abs(a)) + 1e-6), rtol=BF16_REL)

    def norm_close(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-9) < BF16_NORM

    for j, t in zip(j_outs, t_outs):
        rel_close(j, t)
    norm_close(j_dx, t_dx)
    for j, t in zip(j_grads, t_grads):
        norm_close(j, t)


def test_plain_forward_matches_pallas_fwd_at_mule_widths() -> None:
    """``forward_chains`` at MischievousMule's chains (d_in 7 -> 128 with
    LayerNorm -> 128, heads of 3 and 1, relu), the widths the card's tiled
    forward runs, against the Pallas forward ``_call_fwd`` in interpret
    mode, at the bf16 path's tolerance."""
    layout = (([(128, True), (128, False)], [3]), ([(128, True), (128, False)], [1]))
    chains = _random_chains(4, 7, layout)
    x = np.random.default_rng(3).normal(size=(300, 7)).astype(np.float32)
    j_outs = [np.asarray(o) for outs in jax_call_fwd("relu", True, jnp.asarray(x), _to(chains, jnp.asarray)) for o in outs]
    t_outs, _ = forward_chains(torch.from_numpy(x), _to(chains, torch.from_numpy), "relu")
    t_outs = [o.numpy() for outs in t_outs for o in outs]
    assert [o.shape for o in t_outs] == [(300, 3), (300, 1)] == [o.shape for o in j_outs]
    for j, t in zip(j_outs, t_outs):
        np.testing.assert_allclose(t, j, atol=BF16_REL * (np.max(np.abs(j)) + 1e-6), rtol=BF16_REL)


def test_layer_norm_mlp_matches_flax() -> None:
    """The port's ``MLP(layer_norm=True)`` + trailing relu + head, as a
    module and through ``fused_chains``, against flax's in f32."""

    class Ref(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = jax.nn.relu(JMLP((24, 16, 12), layer_norm=True, name="torso")(x))
            return nn.Dense(3, name="head")(h)

    x = np.random.default_rng(0).normal(loc=3.0, size=(50, 7)).astype(np.float32)
    ref = Ref()
    params = ref.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(lambda p: p + 0.1 * jax.random.normal(jax.random.key(1), p.shape), params)
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(x)))

    torso = MLP(7, (24, 16, 12), layer_norm=True)
    head = torch.nn.Linear(12, 3)
    with torch.no_grad():
        for i, layer in enumerate(torso.layers):
            layer.weight.copy_(torch.tensor(np.asarray(params["torso"][f"Dense_{i}"]["kernel"]).T))
            layer.bias.copy_(torch.tensor(np.asarray(params["torso"][f"Dense_{i}"]["bias"])))
        for i, norm in enumerate(torso.norms):
            norm.scale.copy_(torch.tensor(np.asarray(params["torso"][f"LayerNorm_{i}"]["scale"])))
            norm.bias.copy_(torch.tensor(np.asarray(params["torso"][f"LayerNorm_{i}"]["bias"])))
        head.weight.copy_(torch.tensor(np.asarray(params["head"]["kernel"]).T))
        head.bias.copy_(torch.tensor(np.asarray(params["head"]["bias"])))
    assert len(torso.norms) == 2

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.torso, self.head = torso, head

    with torch.no_grad():
        module_out = head(torch.relu(torso(torch.tensor(x)))).numpy()
        ((fused_out,),) = fused_chains("relu", torch.tensor(x), named_chains(Holder(), (("torso", ("head",)),)))
    np.testing.assert_allclose(module_out, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fused_out.numpy(), want, rtol=1e-5, atol=1e-6)


def test_autograd_op_matches_autograd_through_plain_forward() -> None:
    """``fused_chains``'s backward (the recompute-based plain VJP) against
    autograd through the plain forward itself, LayerNorm and dx included."""
    layout = (([(16, True), (12, False), (10, True)], [3, 2]), ([(9, False)], [1]))
    chains = _random_chains(4, 7, layout)
    x = np.random.default_rng(3).normal(size=(33, 7)).astype(np.float32)
    douts = [torch.tensor(np.random.default_rng(10 + i).normal(size=(33, w)).astype(np.float32))
             for i, w in enumerate((3, 2, 1))]

    def grads(use_op: bool):
        tx = torch.tensor(x, requires_grad=True)
        tchains = _to(chains, lambda p: torch.tensor(p, requires_grad=True))
        outs = fused_chains("tanh", tx, tchains) if use_op else forward_chains(tx, tchains, "tanh")[0]
        flat_outs = [o for chain in outs for o in chain]
        sum((o * d).sum() for o, d in zip(flat_outs, douts)).backward()
        return [tx.grad] + [p.grad for p in _leaves(tchains)]

    for got, want in zip(grads(True), grads(False)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_zero_variance_rows_give_no_nan() -> None:
    """Rows whose pre-LayerNorm values are constant (zero rows of x meet a
    constant first-layer bias: variance exactly 0) stay finite in the
    forward and the backward, the clamp at 0 keeping rsqrt finite."""
    chains = _to(_random_chains(5, 7, (([(16, True), (8, False)], [3]),)), torch.tensor)
    (w0, b0, s0, be0), rest = chains[0][0][0], chains[0][0][1:]
    chains = ((((w0, torch.full_like(b0, 0.5), s0, be0), *rest), chains[0][1]),)
    x = torch.randn(12, 7, generator=torch.Generator().manual_seed(0))
    x[::2] = 0.0
    flat, structure = flatten_chains(chains), chain_structure(chains)
    (out,) = fused_chains_fwd(x, flat, structure, "relu")
    dx, dflat = fused_chains_bwd(x, flat, structure, "relu", [torch.ones_like(out)])
    assert bool(torch.isfinite(out).all() and torch.isfinite(dx).all() and torch.isfinite(dflat).all())
    # The zero rows' LayerNorm output is exactly its bias.
    h_ln = torch.relu(be0.expand(6, -1))
    torch.testing.assert_close(out[::2], torch.relu(h_ln @ rest[0][0] + rest[0][1]) @ chains[0][1][0][0] + chains[0][1][0][1])


def test_layout_round_trip_and_structure() -> None:
    chains = _to(_random_chains(6, 3, (([(4, True), (5, False)], [2, 1]), ([(6, False)], [3]))), torch.tensor)
    structure = chain_structure(chains)
    assert structure == (3, ((((4, True), (5, False)), (2, 1)), (((6, False),), (3,))))
    flat = flatten_chains(chains)
    assert flat.numel() == sum(p.numel() for p in _leaves(chains))
    for got, want in zip(_leaves(unflatten_chains(flat, structure)), _leaves(chains)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="values"):
        unflatten_chains(flat[:-1], structure)


def test_wrappers_launch_or_raise_off_the_cpu() -> None:
    """Tensors on any device but the CPU go to the kernels or raise: a
    device without them raises, and the plain version never runs there."""
    chains = _to(_random_chains(7, 3, (([(4, True)], [2]),)), torch.tensor)
    structure = chain_structure(chains)
    x = torch.zeros((5, 3), device="meta")
    flat = flatten_chains(chains).to("meta")
    with pytest.raises(ValueError, match="No chain kernel for device meta"):
        fused_chains_fwd(x, flat, structure, "relu")
    with pytest.raises(ValueError, match="No chain kernel for device meta"):
        fused_chains_bwd(x, flat, structure, "relu", [torch.zeros((5, 2), device="meta")])
    x, flat = torch.zeros((5, 3)), flatten_chains(chains)
    with pytest.raises(ValueError, match="activations"):
        fused_chains_fwd(x, flat, structure, "gelu")
    with pytest.raises(ValueError, match="douts"):
        fused_chains_bwd(x, flat, structure, "relu", [torch.zeros((5, 3))])


def test_plain_vjp_matches_chains_backward_without_layer_norm() -> None:
    """Without LayerNorm, the chain backward's parameter gradients are the
    PPO update kernels' plain backward's, bit for bit."""
    from rl8_tpu_torch.ops.fused_mlp import chains_backward_plain

    chains = _to(_random_chains(8, 2, (([(6, False), (5, False)], [2]), ([(4, False)], [1]))), torch.tensor)
    x = torch.randn(10, 2, generator=torch.Generator().manual_seed(1))
    douts = [[torch.randn(10, 2, generator=torch.Generator().manual_seed(2))],
             [torch.randn(10, 1, generator=torch.Generator().manual_seed(3))]]
    _, hs = forward_chains(x, chains, "relu")
    _, grads = chains_vjp_plain(x, chains, "relu", douts)
    assert torch.equal(flatten_chains(grads), flatten_chains(chains_backward_plain(chains, "relu", hs, douts)))


def _mule(**kw):
    from rl8_tpu_torch.examples.algotrading import AlgoTrading, MischievousMule

    env = AlgoTrading(1, device="cpu")
    return MischievousMule(env.observation_spec, env.action_spec, hiddens=(32, 32), **kw)


def test_supports_fused_apply_classification() -> None:
    """As ``tests/test_ops.py::test_supports_fused_apply_classification``:
    spec-declaring custom models with a kernel activation are supported,
    models without a spec or an activation are not; a bf16 compute dtype
    is accepted and any other refused, as ``rl8_tpu`` classifies them."""
    from rl8_tpu_torch.models import GenericModel, Model
    from rl8_tpu_torch.specs import Discrete, Unbounded

    mule = _mule()
    assert supports_fused_apply(mule)
    assert supports_fused_apply(_mule(dtype=torch.bfloat16))
    for dtype in (torch.float16, torch.float64):
        mule.dtype = dtype
        assert not supports_fused_apply(mule)

    class NoSpec(GenericModel):
        def forward(self, batch):
            raise NotImplementedError

    obs, act = Unbounded(3), Discrete(2, shape=(1,))
    assert not supports_fused_apply(NoSpec(obs, act))
    spec = FusedApplySpec(
        assemble=lambda batch: batch,
        finalize=lambda batch, outs: outs,
        chain_names=(("feature_model", ("feature_head",)),),
    )

    class BareSpecModel(Model):
        def fused_apply_spec(self):
            return spec

    class ReluSpecModel(BareSpecModel):
        activation_fn = "relu"

    class GeluSpecModel(BareSpecModel):
        activation_fn = "gelu"

    assert not supports_fused_apply(BareSpecModel(obs, act))
    assert supports_fused_apply(ReluSpecModel(obs, act))
    assert not supports_fused_apply(GeluSpecModel(obs, act))


def test_default_models_fused_apply_matches_module() -> None:
    """``fused_default_apply`` equals the default models' module forward
    (the plain chains on the CPU), and the gating refuses non-float
    observations and unsupported activations as ``rl8_tpu``'s does."""
    from rl8_tpu_torch.models import DefaultContinuousModel, DefaultDiscreteModel
    from rl8_tpu_torch.ops import fused_default_apply
    from rl8_tpu_torch.specs import Discrete, Unbounded

    obs = {"obs": torch.randn(6, 3, generator=torch.Generator().manual_seed(0))}
    for model in (DefaultDiscreteModel(Unbounded(3), Discrete(3, shape=(2,)), hiddens=(8, 8)),
                  DefaultContinuousModel(Unbounded(3), Unbounded(2), hiddens=(8,), activation_fn="tanh")):
        model.reset_parameters(torch.Generator().manual_seed(1))
        assert supports_fused_apply(model)
        with torch.no_grad():
            (f_mod, v_mod), (f_fused, v_fused) = model(obs), fused_default_apply(model, obs)
        torch.testing.assert_close(v_fused, v_mod)
        for key in f_mod:
            torch.testing.assert_close(f_fused[key], f_mod[key])
    assert not supports_fused_apply(DefaultDiscreteModel(Unbounded(3, dtype=torch.int32), Discrete(2)))
    assert not supports_fused_apply(DefaultDiscreteModel(Unbounded(3), Discrete(2), activation_fn="gelu"))
