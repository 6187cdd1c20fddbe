"""The port's ``nn`` additions against ``rl8_tpu``'s on the CPU: the
masked functional ops and ``skip_connection``, ``SequentialSkipConnection``,
the attention modules (``SelfAttention``, ``SelfAttentionStack`` shared
and unshared, ``CrossAttention``, ``PointerNetwork``), ``PositionalEmbedding``
and both Perceiver layers, from the same numpy inputs and the flax
modules' parameters (carried across with ``models/convert.py``).

``rl8_tpu`` computes attention in one of two layouts (a batch-last one
for windows of at most 16 and embeddings of at most 64, flax's
``MultiHeadDotProductAttention`` otherwise); the port's one layout is
held against both, with padding masks, attention masks and a fully
masked row. Tolerances: rtol = atol = 1e-5 on f32 forwards (other
summation orders); the parameter gradients (all of them, as one vector)
and each input's gradient by a norm-relative error, ``||port - jax|| <=
1e-4 ||jax|| + 1e-6``. (Per leaf, some gradients are rounding noise: a
key bias shifts every score of a query alike, so its exact gradient is
0.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rl8_tpu.nn as jnn
import rl8_tpu_torch.nn as tnn
from rl8_tpu_torch.models import load_jax_params, to_jax_params
from rl8_tpu_torch.models.convert import _leaf_value
from rl8_tpu_torch.nn.modules.mlp import JaxLeaf

RTOL = ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def _close(got, want, rtol: float = RTOL, atol: float = ATOL, what: str = "") -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=atol,
                               err_msg=what)


def _grad_close(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, ref = np.linalg.norm(got - want), np.linalg.norm(want)
    assert err <= GRAD_RTOL * ref + GRAD_ATOL, (what, err, ref)


def _grad_tree(module: torch.nn.Module) -> dict:
    """The module's parameter gradients in the flax tree's layout."""
    tree: dict = {}
    for path, leaf in module.jax_leaves().items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _leaf_value(JaxLeaf(leaf.param.grad, leaf.shape, leaf.kernel))
    return tree


def _tree_grads_close(got: dict, want: dict) -> None:
    """All parameter gradients, in the flax tree's leaf order, as one vector."""
    want = jax.device_get(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    flat = lambda tree: np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(tree)])  # noqa: E731
    _grad_close(flat(got), flat(want), "parameter gradients")


# ----------------------------------------------------------------------
# Masked ops
# ----------------------------------------------------------------------


def test_mask_conversions_and_lengths() -> None:
    mask = _rng().integers(0, 2, size=(3, 5)).astype(np.float32)
    np.testing.assert_array_equal(tnn.binary_mask_to_float_mask(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jnn.binary_mask_to_float_mask(jnp.asarray(mask))))
    fmask = np.where(mask > 0, 0.0, -np.inf).astype(np.float32)
    np.testing.assert_array_equal(tnn.float_mask_to_binary_mask(torch.from_numpy(fmask)).numpy(),
                                  np.asarray(jnn.float_mask_to_binary_mask(jnp.asarray(fmask))))
    x, lengths = np.zeros((4, 6, 2), np.float32), np.array([0, 2, 6, 3])
    np.testing.assert_array_equal(tnn.mask_from_lengths(torch.from_numpy(x), torch.from_numpy(lengths)).numpy(),
                                  np.asarray(jnn.mask_from_lengths(jnp.asarray(x), jnp.asarray(lengths))))


def _masked_inputs(dtype=np.float32):
    rng = _rng(1)
    x = (3.0 * rng.normal(size=(4, 5, 3))).astype(dtype)
    mask = rng.integers(0, 2, size=(4, 5)).astype(bool)
    mask[0] = False  # a fully masked row
    mask[1] = True
    return x, mask


@pytest.mark.parametrize("keepdim", [False, True])
@pytest.mark.parametrize("masked", [True, False])
def test_masked_avg_matches_jax(masked: bool, keepdim: bool) -> None:
    """Masked averages over ``dim=1``, a fully masked row giving 0."""
    x, mask = _masked_inputs()
    kw = lambda m: {"mask": m if masked else None, "dim": 1, "keepdim": keepdim}  # noqa: E731
    got = tnn.masked_avg(torch.from_numpy(x), **kw(torch.from_numpy(mask)))
    want = jnn.masked_avg(jnp.asarray(x), **kw(jnp.asarray(mask)))
    _close(got, want)
    if masked:
        assert float(got[0].abs().max()) == 0.0


def test_masked_max_matches_jax() -> None:
    x, mask = _masked_inputs()
    got, idx = tnn.masked_max(torch.from_numpy(x), mask=torch.from_numpy(mask), dim=1)
    want, jidx = jnn.masked_max(jnp.asarray(x), mask=jnp.asarray(mask), dim=1)
    _close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_log_softmax_matches_jax(dtype: str) -> None:
    """Masked entries sit at f32's finite minimum (in bf16 the clip
    bounds round to infinities, as in ``rl8_tpu``); a fully masked row is
    uniform, never NaN."""
    x, mask = _masked_inputs()
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    last = _rng(11).integers(0, 2, size=x.shape).astype(bool)
    last[0, 0] = False
    for dim, m in ((1, mask), (-1, last)):
        got = tnn.masked_log_softmax(tx, mask=torch.from_numpy(m), dim=dim)
        want = jnn.masked_log_softmax(jx, mask=jnp.asarray(m), dim=dim)
        got, want = got.to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32))
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        tol = 1e-5 if dtype == "float32" else 2e-2
        _close(got[finite], want[finite], rtol=tol, atol=tol)
        if dtype == "float32":
            assert np.isfinite(got).all()


def test_masked_categorical_sample_respects_the_mask() -> None:
    """Sampled indices never fall on masked entries (a fully masked row
    samples uniformly), the returned logits are the masked logits at those
    indices, and the draw follows the softmax: the frequencies of 4,000
    draws against ``rl8_tpu``'s probabilities within 5 sigma."""
    x, mask = _masked_inputs()
    x, draws = x[..., 0], 4000
    tx, tm = torch.from_numpy(np.tile(x, (draws, 1))), torch.from_numpy(np.tile(mask, (draws, 1)))
    logits, idx = tnn.masked_categorical_sample(tx, generator=torch.Generator().manual_seed(0), mask=tm, dim=1)
    assert idx.shape == (4 * draws, 1)
    rows = np.tile(np.arange(4), draws)
    assert mask[rows, idx[:, 0].numpy()][rows > 0].all()
    torch.testing.assert_close(logits, torch.gather(tx + torch.where(tm, 0.0, tnn.functional.FMIN), 1, idx))
    counts = np.zeros(x.shape)
    np.add.at(counts, (rows, idx[:, 0].numpy()), 1)
    probs = np.exp(np.asarray(jnn.masked_log_softmax(jnp.asarray(x), mask=jnp.asarray(mask), dim=1)))
    probs[0] = 1.0 / x.shape[1]
    sigma = np.sqrt(4000 * probs * (1 - probs)) + 1e-9
    assert (np.abs(counts - 4000 * probs) <= 5 * sigma + 1).all()
    jlogits, jidx = jnn.masked_categorical_sample(jnp.asarray(x), key=jax.random.key(0), mask=jnp.asarray(mask))
    assert jlogits.shape == jidx.shape == (4, 1)


@pytest.mark.parametrize("kind", ["residual", "cat", None, "bad"])
def test_skip_connection_matches_jax(kind) -> None:
    rng = _rng(2)
    x, y = rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(3, 4)).astype(np.float32)
    if kind == "bad":
        for fn, asarray in ((tnn.skip_connection, torch.from_numpy), (jnn.skip_connection, jnp.asarray)):
            with pytest.raises(ValueError, match="No skip connection type"):
                fn(asarray(x), asarray(y), kind=kind)
        return
    _close(tnn.skip_connection(torch.from_numpy(x), torch.from_numpy(y), kind=kind),
           jnn.skip_connection(jnp.asarray(x), jnp.asarray(y), kind=kind), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["residual", "cat", None])
def test_sequential_skip_connection_matches_jax(kind) -> None:
    """Two layers (flax ``Dense``s, here ``MLP``s of one layer) threaded
    through skips, with ``"cat"``'s fan-ins in flax's order."""
    import flax.linen as fnn

    E = 6
    rng = _rng(3)
    x, y = rng.normal(size=(5, E)).astype(np.float32), rng.normal(size=(5, E)).astype(np.float32)
    jmod = jnn.SequentialSkipConnection(E, kind=kind, layers=(lambda: jnn.MLP((E,)), lambda: jnn.MLP((E,))))
    params = jax.device_get(jmod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y))["params"])
    tmod = tnn.SequentialSkipConnection(E, kind=kind, layers=[tnn.MLP(E, (E,)), tnn.MLP(E, (E,))])
    load_jax_params(tmod, params)
    assert jax.tree_util.tree_structure(to_jax_params(tmod)) == jax.tree_util.tree_structure(params)
    _close(tmod(torch.from_numpy(x), torch.from_numpy(y)).detach(), jmod.apply({"params": params}, x, y))
    assert fnn  # flax builds the layers above


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------

#: (window, embed_dim, heads): rl8_tpu's batch-last branch (AttentiveAlpaca's
#: window of 5 at E = 8), and flax's MHA branch (a window of 20; E = 128).
SHAPES = {"small-window": (5, 8, 4), "mha-window-20": (20, 16, 2), "mha-embed-128": (3, 128, 4)}


def _attention_inputs(window: int, E: int, seed: int = 4):
    rng = _rng(seed)
    x = rng.normal(size=(4, window, E)).astype(np.float32)
    padding = np.zeros((4, window), bool)
    padding[1, : window // 2] = True  # padded history
    padding[2] = True  # a fully padded row
    return x, padding


def _check_module(jmod, tmod, args: tuple, jargs: tuple, seed: int = 0) -> None:
    """Forward and gradients (parameters and inputs) of ``tmod`` against
    ``jmod`` from the flax module's parameters; the flax tree round trips."""
    params = jax.device_get(jax.jit(jmod.init)(jax.random.key(seed), *jargs)["params"])
    load_jax_params(tmod, params)
    tree = to_jax_params(tmod)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    floats = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor) and a.is_floating_point()]
    targs = [a.clone().requires_grad_(True) if i in floats else a for i, a in enumerate(args)]
    out = tmod(*targs)
    want = jax.jit(jmod.apply)({"params": params}, *jargs)
    _close(out.detach(), want)
    assert torch.isfinite(out).all()
    cot = _rng(seed + 9).normal(size=tuple(out.shape)).astype(np.float32)

    def loss(params, *float_args):
        full = list(jargs)
        for i, a in zip(floats, float_args):
            full[i] = a
        return jnp.sum(jmod.apply({"params": params}, *full) * cot)

    jgrads = jax.jit(jax.grad(loss, argnums=tuple(range(1 + len(floats)))))(params, *(jargs[i] for i in floats))
    (out * torch.from_numpy(cot)).sum().backward()
    _tree_grads_close(_grad_tree(tmod), jgrads[0])
    for i, g in zip(floats, jgrads[1:]):
        _grad_close(targs[i].grad.numpy(), g, f"input {i}")


@pytest.mark.parametrize(
    "shape,skip_kind",
    [("small-window", "cat"), ("small-window", "residual"), ("small-window", None), ("mha-window-20", "cat"),
     ("mha-embed-128", "residual")],
)
def test_self_attention_matches_jax(shape: str, skip_kind) -> None:
    window, E, H = SHAPES[shape]
    x, padding = _attention_inputs(window, E)
    causal = np.tril(np.ones((window, window), bool))
    jmod = jnn.SelfAttention(E, num_heads=H, hidden_dim=16, skip_kind=skip_kind)
    tmod = tnn.SelfAttention(E, num_heads=H, hidden_dim=16, skip_kind=skip_kind)
    _check_module(jmod, tmod, (torch.from_numpy(x), torch.from_numpy(padding), torch.from_numpy(causal)),
                  (jnp.asarray(x), jnp.asarray(padding), jnp.asarray(causal)))


@pytest.mark.parametrize("share", [True, False], ids=["shared", "unshared"])
@pytest.mark.parametrize("shape", ["small-window", "mha-window-20"])
def test_self_attention_stack_matches_jax(shape: str, share: bool) -> None:
    """Two layers, their parameters shared (one ``layers_shared`` subtree,
    each tensor once in ``parameters()``, gradients summed over both
    applications) or not."""
    window, E, H = SHAPES[shape]
    x, padding = _attention_inputs(window, E)
    kw = dict(num_layers=2, num_heads=H, hidden_dim=16, skip_kind="residual", share_parameters=share)
    tmod = tnn.SelfAttentionStack(E, **kw)
    n_unique = len(list(tmod.parameters()))
    assert n_unique == (16 if share else 32)
    _check_module(jnn.SelfAttentionStack(E, **kw), tmod, (torch.from_numpy(x), torch.from_numpy(padding)),
                  (jnp.asarray(x), jnp.asarray(padding)))


@pytest.mark.parametrize("shape", ["small-window", "mha-window-20"])
def test_cross_attention_matches_jax(shape: str) -> None:
    window, E, H = SHAPES[shape]
    kv, padding = _attention_inputs(window, E)
    q = _rng(5).normal(size=(4, 3, E)).astype(np.float32)
    am = _rng(6).integers(0, 2, size=(3, window)).astype(bool)
    am[0] = False  # a query that may attend to nothing
    jmod = jnn.CrossAttention(E, num_heads=H, hidden_dim=16)
    tmod = tnn.CrossAttention(E, num_heads=H, hidden_dim=16)
    _check_module(jmod, tmod, tuple(torch.from_numpy(a) for a in (q, kv, padding, am)),
                  tuple(jnp.asarray(a) for a in (q, kv, padding, am)))


def test_pointer_network_matches_jax() -> None:
    rng = _rng(7)
    dec, enc = rng.normal(size=(3, 4, 6)).astype(np.float32), rng.normal(size=(3, 5, 6)).astype(np.float32)
    mask = rng.integers(0, 2, size=(3, 4, 5)).astype(bool)
    mask[0, 0] = False
    jmod, tmod = jnn.PointerNetwork(8), tnn.PointerNetwork(8, in_features=6)
    _check_module(jmod, tmod, tuple(torch.from_numpy(a) for a in (dec, enc, mask)),
                  tuple(jnp.asarray(a) for a in (dec, enc, mask)))


def test_attention_bf16_matches_jax_rule() -> None:
    """A bf16 stack (AttentiveAlpaca's shape) against flax's bf16 forward
    op by op, both held against the f32 forward: the port's error at most
    2x ``rl8_tpu``'s, and the two within a few bf16 roundings (the rule
    of ``tests/test_torch_amp.py``)."""
    window, E, H = SHAPES["small-window"]
    x, padding = _attention_inputs(window, E)
    kw = dict(num_layers=2, num_heads=H, hidden_dim=16, skip_kind="residual", share_parameters=True)
    j32, j16 = jnn.SelfAttentionStack(E, **kw), jnn.SelfAttentionStack(E, dtype=jnp.bfloat16, **kw)
    params = jax.device_get(j32.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(padding))["params"])
    ref = np.asarray(j32.apply({"params": params}, x, padding), np.float64)
    with jax.disable_jit():
        want = np.asarray(j16.apply({"params": params}, x, padding).astype(jnp.float32), np.float64)
    tmod = tnn.SelfAttentionStack(E, dtype=torch.bfloat16, **kw)
    load_jax_params(tmod, params)
    out = tmod(torch.from_numpy(x), torch.from_numpy(padding))
    # The residual skip adds the f32 input: f32 out, as in rl8_tpu.
    assert out.dtype == torch.float32
    got = out.detach().numpy().astype(np.float64)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 2.0 * np.abs(want - ref).max() + 1e-6 * scale
    assert np.abs(got - want).max() <= 2e-2 * scale


# ----------------------------------------------------------------------
# Embeddings, Perceiver, activations
# ----------------------------------------------------------------------


@pytest.mark.parametrize("embed_dim", [8, 7])
def test_positional_embedding_matches_jax(embed_dim: int) -> None:
    from rl8_tpu.nn.modules.embeddings import sinusoidal_embedding as jtable

    from rl8_tpu_torch.nn.modules.embeddings import sinusoidal_embedding

    np.testing.assert_array_equal(sinusoidal_embedding(16, embed_dim), jtable(16, embed_dim))
    x = _rng(8).normal(size=(3, 5, embed_dim)).astype(np.float32)
    got = tnn.PositionalEmbedding(embed_dim, max_len=16)(torch.from_numpy(x))
    want = jnn.PositionalEmbedding(embed_dim, max_len=16).apply({}, jnp.asarray(x))
    _close(got, want, rtol=0, atol=0)
    # The f32 table promotes a bf16 input, as in rl8_tpu.
    assert tnn.PositionalEmbedding(embed_dim, 16)(torch.from_numpy(x).bfloat16()).dtype == torch.float32


def test_perceiver_layers_match_jax() -> None:
    E = 8
    kv, padding = _attention_inputs(5, E)
    q = _rng(9).normal(size=(4, 3, E)).astype(np.float32)
    kw = dict(num_heads=2, hidden_dim=16, num_layers=1)
    _check_module(jnn.PerceiverLayer(E, **kw), tnn.PerceiverLayer(E, **kw),
                  tuple(torch.from_numpy(a) for a in (q, kv, padding)), tuple(jnp.asarray(a) for a in (q, kv, padding)))
    kw = dict(num_heads=2, hidden_dim=16, num_layers=1, share_parameters=True)
    _check_module(jnn.PerceiverIOLayer(E, output_seq_dim=2, **kw), tnn.PerceiverIOLayer(E, output_seq_dim=2, **kw),
                  tuple(torch.from_numpy(a) for a in (q, kv, padding)), tuple(jnp.asarray(a) for a in (q, kv, padding)))


def test_squared_relu_and_exports_match_jax() -> None:
    x = _rng(10).normal(size=(7,)).astype(np.float32)
    _close(tnn.SquaredReLU()(torch.from_numpy(x)), jnn.SquaredReLU()(jnp.asarray(x)), rtol=0, atol=0)
    assert set(jnn.__all__) <= set(tnn.__all__)


def test_init_and_dropout_knobs() -> None:
    """``reset_parameters`` applies flax's initializers (LayerNorm 1/0, zero
    biases, lecun-scale weights); dropout acts only when not
    ``deterministic``."""
    tmod = tnn.SelfAttention(8, num_heads=4, hidden_dim=16, attention_dropout=0.5, hidden_dropout=0.5)
    tmod.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(tmod.block.q_norm.scale, torch.ones(8))
    assert float(tmod.block.attention.query.bias.detach().abs().max()) == 0.0
    assert 0.1 < float(tmod.block.attention.query.weight.detach().std()) < 0.6
    x = torch.randn(2, 5, 8)
    torch.testing.assert_close(tmod(x), tmod(x))
    torch.manual_seed(0)
    assert not torch.equal(tmod(x), tmod(x, deterministic=False))
