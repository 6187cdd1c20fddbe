"""Wide chains: the chain kernels' plain versions at the widths that
``csrc/chains.cu``'s staged routes take (every chain ``rl8_tpu``'s
residency gate admits, up to 2382 wide at MischievousMule's layout), held on the CPU against
``rl8_tpu``'s ``fused_chains`` (the Pallas kernels in interpret mode) and
against ``jax.grad`` of a plain ``jnp`` forward; zero-variance rows at
2382 wide; the chain layouts that ``chip_smoke.py`` sweeps on the card
against the custom and default models' own chains; and the wrappers'
refusal, before any launch, of chains past the kernels' counts.

Tolerances. Against the Pallas kernels, which multiply in bf16 on the MXU
at widths of 8 and more: their own ``_rel_close`` and ``_norm_close``
(``tests/test_torch_chains.py``'s ``BF16_REL``, ``BF16_NORM``). Against
``jax.grad`` of the plain forward, f32 on both sides with other summation
orders over up to 4096-term sums: outputs and dx to 1e-5 of the largest
magnitude, each gradient by a norm-relative error of 1e-5.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import mule_layout, torso_layout
from rl8_tpu.ops.fused_mlp import fused_chains as jax_fused_chains
from rl8_tpu_torch.examples.algotrading import AlgoTrading, AttentiveAlpaca, LazyLemur, MischievousMule
from rl8_tpu_torch.models import DefaultDiscreteModel
from rl8_tpu_torch.ops import card_takes_chains, chains_fit_vmem, fused_chains, fused_chains_bwd, fused_chains_fwd
from rl8_tpu_torch.ops.fused_mlp import chain_names, chain_structure, flatten_chains, named_chains
from rl8_tpu_torch.policies import Policy, RecurrentPolicy
from rl8_tpu_torch.specs import Discrete, Unbounded
from tests.test_torch_chains import BF16_NORM, BF16_REL, _leaves, _random_chains, _to, _torch_loss_and_grads
from tests.test_torch_wide import _reports_cuda
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_OUT_REL, F32_GRAD_NORM = 1e-5, 1e-5

#: ``(d_in, rows, layout)``: MischievousMule's layout at 1024 and at
#: rl8_tpu's last admitted 2382, LazyLemur's (d_in 64) at its last
#: admitted 2354, one
#: 4096-wide LayerNorm chain (the card refused it before the staged
#: routes), and a ragged pair (three layers beside one; a 9-wide head).
WIDE_CASES = {
    "mule-1024": (7, 48, mule_layout(1024)),
    "mule-2382": (7, 24, mule_layout(2382)),
    "lemur-2354": (64, 24, mule_layout(2354)),
    "ln-4096-din7": (7, 40, (([(4096, True)], [3]),)),
    "ragged-9-head": (5, 37, (([(1200, True), (900, False), (700, True)], [9, 2]), ([(1500, False)], [1]))),
}


def _inputs(case: str):
    d_in, N, layout = WIDE_CASES[case]
    chains = _random_chains(list(WIDE_CASES).index(case) + 10, d_in, layout)
    x = np.random.default_rng(5).normal(size=(N, d_in)).astype(np.float32)
    return x, chains


def _jax_loss_and_grads(forward, x, chains):
    """Head outputs, and the gradients of sum(sin(outs)) in x and every
    parameter, through ``forward(x, chains)`` (a list of head outputs)
    under one ``jax.jit`` (op by op, each op compiles on its own: several
    times slower at these widths)."""

    def loss(c, xx):
        outs = forward(xx, c)
        return sum(jnp.sum(jnp.sin(o)) for o in outs), outs

    grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, outs), (g_chains, g_x) = grad(_to(chains, jnp.asarray), jnp.asarray(x))
    return [np.asarray(o) for o in outs], np.asarray(g_x), [np.asarray(g) for g in _leaves(g_chains)]


def _pallas_forward(x, chains):
    """``rl8_tpu``'s ``fused_chains`` (its Pallas kernels in interpret
    mode), relu, head outputs chain by chain."""
    return [o for chain in jax_fused_chains("relu", True, x, chains) for o in chain]


@pytest.mark.parametrize("case", list(WIDE_CASES), ids=list(WIDE_CASES))
def test_plain_chains_match_pallas_at_wide_widths(case: str) -> None:
    """Head outputs, dx and every parameter gradient of sum(sin(outs))
    through the port's ``fused_chains`` (the plain versions and autograd)
    against ``rl8_tpu``'s in interpret mode, at the bf16 path's
    tolerances."""
    x, chains = _inputs(case)
    j_outs, j_dx, j_grads = _jax_loss_and_grads(_pallas_forward, x, chains)
    t_outs, t_dx, t_grads = _torch_loss_and_grads("relu", x, chains)

    def norm_close(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-9) < BF16_NORM

    for j, t in zip(j_outs, t_outs):
        np.testing.assert_allclose(t, j, atol=BF16_REL * (np.max(np.abs(j)) + 1e-6), rtol=BF16_REL)
    norm_close(j_dx, t_dx)
    assert len(t_grads) == len(j_grads)
    for j, t in zip(j_grads, t_grads):
        norm_close(j, t)


def _plain_jnp_forward(x, chains):
    """The chains' forward in plain ``jnp`` (flax's fast-variance LayerNorm,
    clamped at 0, eps 1e-6; relu)."""
    outs = []
    for layers, heads in chains:
        h = x
        for layer in layers:
            z = h @ layer[0] + layer[1]
            if len(layer) == 4:
                mu = jnp.mean(z, axis=-1, keepdims=True)
                var = jnp.maximum(jnp.mean(z * z, axis=-1, keepdims=True) - mu * mu, 0.0)
                z = (z - mu) * jax.lax.rsqrt(var + 1e-6) * layer[2] + layer[3]
            h = jax.nn.relu(z)
        outs.extend(h @ w + b for w, b in heads)
    return outs


@pytest.mark.parametrize("case", list(WIDE_CASES), ids=list(WIDE_CASES))
def test_plain_chains_match_jax_grad_f32(case: str) -> None:
    """The same through ``jax.grad`` of a plain ``jnp`` forward, f32 on both
    sides: outputs and dx to F32_OUT_REL of their largest magnitude, each
    gradient by a norm-relative error of F32_GRAD_NORM."""
    x, chains = _inputs(case)
    j_outs, j_dx, j_grads = _jax_loss_and_grads(_plain_jnp_forward, x, chains)
    t_outs, t_dx, t_grads = _torch_loss_and_grads("relu", x, chains)
    for j, t in [*zip(j_outs, t_outs), (j_dx, t_dx)]:
        np.testing.assert_allclose(t, j, rtol=0, atol=F32_OUT_REL * np.max(np.abs(j)))
    assert len(j_grads) == len(t_grads)
    for j, t in zip(j_grads, t_grads):
        j = np.asarray(j, np.float64)
        assert np.linalg.norm(t - j) <= F32_GRAD_NORM * np.linalg.norm(j), t.shape


def test_zero_variance_rows_give_no_nan_at_2382() -> None:
    """MischievousMule's layout at 2382 wide with a constant first-layer
    bias and zero input rows: those rows' pre-LayerNorm values are all 0.5
    (variance 0, s = 1000); every output, dx and gradient is finite, and
    the zero rows' outputs agree (to the rounding of the products' row
    blocking)."""
    chains = _random_chains(21, 7, mule_layout(2382))
    (first, *rest), heads = chains[0]
    w, _, scale, bias = first
    chains = (((w, np.full_like(scale, 0.5), scale, bias), *rest), heads), chains[1]
    x = np.random.default_rng(6).normal(size=(30, 7)).astype(np.float32)
    x[::3] = 0.0
    outs, dx, grads = _torch_loss_and_grads("relu", x, chains)
    for t in (*outs, dx, *grads):
        assert np.isfinite(t).all()
    for o in outs:
        np.testing.assert_allclose(o[::3], np.broadcast_to(o[0], o[::3].shape), rtol=1e-6, atol=1e-7)


def _meta_model(name: str, width: int):
    env = AlgoTrading(1, device="cpu")
    config = {"hiddens": (width, width)}
    with torch.device("meta"):
        if name == "torso":
            return DefaultDiscreteModel(Unbounded(1), Discrete(2, shape=(1,)), hiddens=(width, width))
        if name == "lemur":
            return RecurrentPolicy(env.observation_spec, env.action_spec, model_cls=LazyLemur,
                                   model_config={**config, "hidden_size": 64}).model
        cls = {"mule": MischievousMule, "alpaca": AttentiveAlpaca}[name]
        return Policy(env.observation_spec, env.action_spec, model_cls=cls, model_config=config).model


@pytest.mark.parametrize(
    "name,width,d_in,layout",
    [("mule", 2382, 7, mule_layout), ("alpaca", 2380, 11, mule_layout), ("lemur", 2354, 64, mule_layout),
     ("torso", 2388, 1, torso_layout)],
    ids=["mule-2382", "alpaca-2380", "lemur-2354", "torso-2388"],
)
def test_swept_layouts_are_the_models_chains(name: str, width: int, d_in: int, layout) -> None:
    """``chip_smoke.py``'s chain layouts are the models' own chains (built
    on the ``meta`` device): the same input width, layers, LayerNorm flags
    and heads; and rl8_tpu's gate (``chains_fit_vmem``) admits them at the
    last widths it admits (those the card's sweep and builds run) and not
    one wider."""
    model = _meta_model(name, width)
    chains = named_chains(model, chain_names(model))
    want = (d_in, tuple((tuple((w, ln) for w, ln in layers), tuple(heads)) for layers, heads in layout(width)))
    assert chain_structure(chains) == want
    assert chains_fit_vmem(chains)
    wider = _meta_model(name, width + 1)
    assert not chains_fit_vmem(named_chains(wider, chain_names(wider)))


def test_chain_wrappers_refuse_counts_before_any_launch(monkeypatch) -> None:
    """The wrappers refuse no count: chains past the kernels' former counts
    (5 chains, one of 9 layers, one with 5 heads) on tensors that report
    ``cuda`` reach the library whole, its capacity query and both launches
    receiving the full spec (with the allocations and the stream stubbed on
    this CPU-only build); where the query says -1 (the workspace budget),
    both raise ``NotImplementedError`` before any launch or count.
    ``card_takes_chains`` is that query at one row."""
    fused_mlp = importlib.import_module("rl8_tpu_torch.ops.fused_mlp")
    asked, launched = [], []
    answer = {"floats": 7}

    class Library:
        def rl8_chains_workspace(self, N, d_in, spec, n, backward):
            asked.append((N, d_in, backward, list(spec)[:n]))
            return answer["floats"]

        def rl8_chains_fwd(self, x, params, outs, work, N, d_in, spec, n, act, save, device, stream):
            launched.append(("fwd", N, d_in, list(spec)[:n], save))
            return 0

        def rl8_chains_bwd(self, x, params, douts, dx, grads, work, N, d_in, spec, n, act, saved, device, stream):
            launched.append(("bwd", N, d_in, list(spec)[:n], saved))
            return 0

    layout = (([(16, False)] * 9, [2]), ([(8, True)], [1, 2, 3, 1, 4]), ([(4, False)], [1]), ([(4, True)], [1]),
              ([(6, False), (6, True)], [2]))
    chains = _to(_random_chains(22, 3, layout), torch.from_numpy)
    structure = chain_structure(chains)
    want = [5]
    for layers, heads in structure[1]:
        want += [len(layers), *[v for w, ln in layers for v in (w, int(ln))], len(heads), *heads]
    real_empty = torch.empty
    monkeypatch.setattr(fused_mlp, "load", Library)
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: real_empty(*a, **k))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 0})())
    x = _reports_cuda(torch.zeros((5, 3)))
    flat = _reports_cuda(flatten_chains(chains))
    launches = (fused_chains_fwd.launches, fused_chains_bwd.launches)
    outs = fused_chains_fwd(x, flat, structure, "relu")
    assert [tuple(o.shape) for o in outs] == [(5, w) for _, heads in structure[1] for w in heads]
    douts = [_reports_cuda(torch.zeros(o.shape)) for o in outs]
    fused_chains_bwd(x, flat, structure, "relu", douts)
    assert launched == [("fwd", 5, 3, want, 0), ("bwd", 5, 3, want, 0)]
    assert (fused_chains_fwd.launches, fused_chains_bwd.launches) == (launches[0] + 1, launches[1] + 1)
    assert all(spec == want for *_, spec in asked)
    assert card_takes_chains(chains) and asked[-1] == (1, 3, 1, want)
    answer["floats"] = -1
    with pytest.raises(NotImplementedError, match="workspace budget"):
        fused_chains_fwd(x, flat, structure, "relu")
    with pytest.raises(NotImplementedError, match="workspace budget"):
        fused_chains_bwd(x, flat, structure, "relu", douts)
    assert len(launched) == 2
    assert not card_takes_chains(chains)


def test_wide_chains_autograd_through_fused_chains_on_cpu() -> None:
    """``fused_chains`` on CPU tensors at 2382 wide is differentiable in x
    and every parameter (the plain backward on the activations its forward
    kept), and its gradients equal autograd through the plain forward."""
    x, chains = _inputs("mule-2382")
    tx = torch.tensor(x[:8], requires_grad=True)
    tchains = _to(chains, lambda p: torch.tensor(p, requires_grad=True))
    outs = fused_chains("relu", tx, tchains)
    sum(o.sum() for chain in outs for o in chain).backward()
    grads = [tx.grad] + [p.grad for p in _leaves(tchains)]
    rx = torch.tensor(x[:8], requires_grad=True)
    rchains = _to(chains, lambda p: torch.tensor(p, requires_grad=True))
    from rl8_tpu_torch.ops import forward_chains

    routs, _ = forward_chains(rx, rchains, "relu")
    sum(o.sum() for chain in routs for o in chain).backward()
    for g, r in zip(grads, [rx.grad] + [p.grad for p in _leaves(rchains)]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


#: ``(d_in, rows, activation, layout)`` of the saving route's tests: widths
#: below 8, where ``rl8_tpu``'s Pallas kernels compute in f32 (so the port
#: is held to them at f32's tolerance), with LayerNorm layers and without,
#: under relu and tanh.
_SAVING_CASES = {
    "ln-relu": (7, 37, "relu", (([(5, True), (6, False)], [3, 1]), ([(4, True)], [2]))),
    "ln-tanh": (3, 20, "tanh", (([(7, True), (6, True)], [2]), ([(5, False), (4, True)], [1]))),
    "noln-relu": (1, 29, "relu", (([(6, False), (5, False)], [2]), ([(3, False)], [1]))),
    "noln-tanh": (5, 16, "tanh", (([(7, False)], [1, 3]), ([(6, False), (6, False), (2, False)], [1]))),
}


@pytest.mark.parametrize("case", list(_SAVING_CASES), ids=list(_SAVING_CASES))
def test_saving_route_gradients_match_pallas_jax_grad(case: str, monkeypatch) -> None:
    """Through ``fused_chains`` with gradients on, the forward keeps its
    activations and the backward reads them (the recompute,
    ``chains_vjp_plain``, is never called): dx and every parameter's
    gradient of sum(sin(outs)) equal ``jax.grad`` through ``rl8_tpu``'s
    ``fused_chains`` (its Pallas kernels in interpret mode, f32 at these
    widths) to rtol 1e-5, atol 1e-5."""
    from tests.test_torch_chains import _jax_loss_and_grads as pallas_loss_and_grads

    fused_mlp = importlib.import_module("rl8_tpu_torch.ops.fused_mlp")

    def no_recompute(*args, **kwargs):
        raise AssertionError("the backward recomputed the forward")

    monkeypatch.setattr(fused_mlp, "chains_vjp_plain", no_recompute)
    d_in, N, act, layout = _SAVING_CASES[case]
    chains = _random_chains(list(_SAVING_CASES).index(case) + 30, d_in, layout)
    x = np.random.default_rng(31).normal(size=(N, d_in)).astype(np.float32)
    j_outs, j_dx, j_grads = pallas_loss_and_grads(act, x, chains)
    t_outs, t_dx, t_grads = _torch_loss_and_grads(act, x, chains)
    for j, t in zip(j_outs, t_outs):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_dx, j_dx, rtol=1e-5, atol=1e-5)
    assert len(t_grads) == len(j_grads)
    for j, t in zip(j_grads, t_grads):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["ln-relu", "ln-tanh", "noln-tanh"])
def test_saved_backward_is_the_recompute_bit_for_bit(case: str) -> None:
    """``fused_chains_bwd`` on what a saving ``fused_chains_fwd`` kept
    (``_backward`` on its stacks and LayerNorm aux) gives the same bits as
    its recompute (``chains_vjp_plain``), and the saving forward's outputs
    are the forward's."""
    d_in, N, act, layout = _SAVING_CASES[case]
    chains = _to(_random_chains(list(_SAVING_CASES).index(case) + 40, d_in, layout), torch.from_numpy)
    x = torch.from_numpy(np.random.default_rng(41).normal(size=(N, d_in)).astype(np.float32))
    structure, flat = chain_structure(chains), flatten_chains(chains)
    outs, saved = fused_chains_fwd(x, flat, structure, act, save=True)
    assert all(torch.equal(a, b) for a, b in zip(outs, fused_chains_fwd(x, flat, structure, act)))
    douts = [torch.from_numpy(np.random.default_rng(42 + i).normal(size=o.shape).astype(np.float32))
             for i, o in enumerate(outs)]
    dx, dflat = fused_chains_bwd(x, flat, structure, act, douts, saved=saved)
    rdx, rdflat = fused_chains_bwd(x, flat, structure, act, douts)
    assert torch.equal(dx, rdx) and torch.equal(dflat, rdflat)


def test_forward_saves_only_where_a_backward_will_run(monkeypatch) -> None:
    """``fused_chains`` asks its forward to save only with grad mode on and
    an input that requires a gradient: under ``torch.no_grad`` (a rollout)
    and on inputs that need none it saves nothing. A second backward
    through retained graph recomputes, with the same gradients."""
    fused_mlp = importlib.import_module("rl8_tpu_torch.ops.fused_mlp")
    asked = []
    real = fused_mlp.fused_chains_fwd

    def spy(*args, save=False):
        asked.append(save)
        return real(*args, save=save)

    monkeypatch.setattr(fused_mlp, "fused_chains_fwd", spy)
    d_in, N, act, layout = _SAVING_CASES["ln-relu"]
    chains = _random_chains(50, d_in, layout)
    x = np.random.default_rng(51).normal(size=(N, d_in)).astype(np.float32)
    tchains = _to(chains, lambda p: torch.tensor(p, requires_grad=True))
    with torch.no_grad():
        outs = fused_chains(act, torch.tensor(x), tchains)
    assert asked == [False] and all(o.grad_fn is None for chain in outs for o in chain)
    fused_chains(act, torch.tensor(x), _to(chains, torch.tensor))
    assert asked == [False, False]
    outs = fused_chains(act, torch.tensor(x, requires_grad=True), tchains)
    assert asked == [False, False, True]
    loss = sum(torch.sin(o).sum() for chain in outs for o in chain)
    first = torch.autograd.grad(loss, _leaves(tchains), retain_graph=True)
    second = torch.autograd.grad(loss, _leaves(tchains))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _deep_mule(depth: int) -> tuple:
    """MischievousMule's chains at ``hiddens=(128,) * depth`` (its first
    layer with a LayerNorm)."""
    return tuple(([(128, True)] + [(128, False)] * (depth - 1), [w]) for w in (3, 1))


@pytest.mark.parametrize(
    "name, layout, N, want",
    [
        ("wide_custom", mule_layout(2048), 32768, 32768),
        ("deep_custom", _deep_mule(12), 32768, 32768),
        ("mule_2382", mule_layout(2382), 32768, 32768),
        ("deep_memory", _deep_mule(324), 32768, 5504),
        ("mule_tiled", mule_layout(128), 32768, 0),
    ],
)
def test_route_rule_saves_exactly_where_the_chunk_is_every_row(name: str, layout, N: int, want: int) -> None:
    """``staged_chunk_rows``, the pure-Python mirror of ``csrc/chains.cu``'s
    ``rl8_chains_chunk_rows`` (``chip_smoke.py``'s ``backward_rule`` holds
    it to the library on the card), at the cells' shapes: ``wide_custom``
    and ``deep_custom`` (and rl8_tpu's widest admitted MischievousMule)
    hold every row in one chunk behind the staged forward, so their
    forwards save (``staged_saves``); the deepest admitted MischievousMule
    (324 x 128) runs in six chunks of 5,504 rows (the card's answer) and
    the main path's MischievousMule takes the tiled backward, so both
    recompute."""
    from rl8_tpu_torch.ops.fused_mlp import staged_chunk_rows, staged_saves

    structure = (7, tuple((tuple(layers), tuple(heads)) for layers, heads in layout))
    assert staged_chunk_rows(structure, N) == want
    assert staged_saves(structure, N) == (want == N)


@pytest.mark.parametrize("N", [1000, 32768])
def test_route_rule_recomputes_behind_the_tiled_forward(N: int) -> None:
    """160- and 136-wide layers (``chip_smoke.py``'s chain config (e)):
    the forward takes its tiled route and the backward its staged route
    with every row in one chunk. The forward keeps nothing there, so that
    its outputs are the tiled route's bits with grad mode on too, and the
    backward recomputes."""
    from rl8_tpu_torch.ops.fused_mlp import _tiled_forward_fits, staged_chunk_rows, staged_saves

    structure = (7, ((((160, True), (136, False)), (2, 9)), (((136, True),), (1,))))
    assert _tiled_forward_fits(structure) and staged_chunk_rows(structure, N) == N
    assert not staged_saves(structure, N)


def test_saving_wrappers_pass_the_saved_workspace(monkeypatch) -> None:
    """On the card's path (a fake library), a saving forward asks for the
    saved layout's floats (``rl8_chains_workspace(..., 2)``), launches with
    ``save`` and returns that workspace; the saved backward launches on it
    with ``saved`` and allocates no workspace of its own; where the library
    answers 0 (the route recomputes) the forward keeps nothing. A
    workspace of another size is refused before any launch."""
    fused_mlp = importlib.import_module("rl8_tpu_torch.ops.fused_mlp")
    launched, answer = [], {"saved": 11}

    class Library:
        def rl8_chains_workspace(self, N, d_in, spec, n, backward):
            return answer["saved"] if backward == 2 else 7

        def rl8_chains_fwd(self, x, params, outs, work, N, d_in, spec, n, act, save, device, stream):
            launched.append(("fwd", work, save))
            return 0

        def rl8_chains_bwd(self, x, params, douts, dx, grads, work, N, d_in, spec, n, act, saved, device, stream):
            launched.append(("bwd", work, saved))
            return 0

    real_empty = torch.empty
    allocated = []

    def empty(*a, device=None, **k):
        t = real_empty(*a, **k)
        allocated.append(t.numel())
        return t

    monkeypatch.setattr(fused_mlp, "load", Library)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 0})())
    chains = _to(_random_chains(60, 3, (([(4, True)], [2]),)), torch.from_numpy)
    structure = chain_structure(chains)
    x = _reports_cuda(torch.zeros((5, 3)))
    flat = _reports_cuda(flatten_chains(chains))
    outs, saved = fused_chains_fwd(x, flat, structure, "relu", save=True)
    assert saved is not None and saved.numel() == 11 and launched[-1] == ("fwd", saved.data_ptr(), 1)
    douts = [_reports_cuda(torch.zeros(o.shape)) for o in outs]
    saved = _reports_cuda(saved)
    allocated.clear()
    fused_chains_bwd(x, flat, structure, "relu", douts, saved=saved)
    assert launched[-1] == ("bwd", saved.data_ptr(), 1) and 11 not in allocated and 7 not in allocated
    with pytest.raises(ValueError, match="saving chain forward"):
        fused_chains_bwd(x, flat, structure, "relu", douts, saved=_reports_cuda(torch.zeros(12)))
    assert len(launched) == 2
    answer["saved"] = 0
    outs, saved = fused_chains_fwd(x, flat, structure, "relu", save=True)
    assert saved is None and launched[-1][2] == 0
