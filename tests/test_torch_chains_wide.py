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

        def rl8_chains_fwd(self, x, params, outs, work, N, d_in, spec, n, act, device, stream):
            launched.append(("fwd", N, d_in, list(spec)[:n]))
            return 0

        def rl8_chains_bwd(self, x, params, douts, dx, grads, work, N, d_in, spec, n, act, device, stream):
            launched.append(("bwd", N, d_in, list(spec)[:n]))
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
    assert launched == [("fwd", 5, 3, want), ("bwd", 5, 3, want)]
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
    and every parameter (the plain recompute-based backward), and its
    gradients equal autograd through the plain forward."""
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
