"""Why the update kernels multiply in 3xTF32, pinned on the CPU.

The update kernels (``csrc/ppo.cu``, ``csrc/rnn_ppo.cu`` and
``csrc/wgrad.cuh``) run their products on the tensor cores through
``csrc/mma.cuh``: every f32 operand x splits into big = tf32(x), rounded
to nearest at TF32's 10 mantissa bits (PTX's ``cvt.rna``), and small = x -
big, which the tensor core reads truncated to TF32, and a product adds
small * big + big * small, then big * big, into f32 accumulators. The
checks of ``chip_smoke.py`` hold each gradient to ``||k - p|| <= 1e-4
||p|| + 1e-6`` against the f32 plain version. Here TF32 is emulated in
torch at the update's shapes (256-deep dot products, and weight-gradient
sums over 65,536 rows in the kernel's order: groups of rows, chunks of 8
per tensor-core step, f32 accumulators, a fixed-order sum of the groups'
partials) and held against float64: 3xTF32 stays ten times under the
checks' limit, one TF32 product per f32 product does not meet it. (The
emulation rounds each step's f32 result to nearest; the card's tensor
cores round it toward zero, which is why ``mma.cuh`` starts a fresh
accumulator every step and the forwards stay on the CUDA cores.)

The recurrent act kernel's gate products (``csrc/rnn_act.cu``) and the
chain backward's dh products (``csrc/chains.cu``) also run on 3xTF32; a
last case emulates them as the card rounds, each ``mma``'s f32 result
truncated toward zero into a fresh accumulator per k step of 8, and holds
them against float64 at ten times under the act checks' and the chain
checks' absolute tolerance. Its ``act_torso`` case emulates the discrete
act kernel's wgmma route (``csrc/act.cu``, ``csrc/wgmma.cuh``), whose
accumulators hold a layer's whole K: there 3xTF32 stays ten times inside
the act checks' limits, and one TF32 product per f32 product does not.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

#: The update checks' norm-relative limit (chip_smoke.py PPO_GRAD_RTOL).
PPO_GRAD_RTOL = 1e-4
#: The act and chain checks' absolute tolerances (chip_smoke.py ACT_ATOL,
#: CHAIN_ATOL), and the act checks' relative one (ACT_RTOL).
ACT_ATOL = CHAIN_ATOL = 1e-4
ACT_RTOL = 1e-4


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> f32 rounded to nearest, ties away from zero, at 10 mantissa
    bits (``cvt.rna.tf32.f32`` with the low 13 bits cleared): adding half
    of the dropped range to the magnitude's bits carries into the kept
    ones exactly when the dropped part is at least half an ulp."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_rz(x: torch.Tensor) -> torch.Tensor:
    """f32 -> f32 truncated to 10 mantissa bits, as the tensor core reads
    an f32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32_rna(x)
    return big, tf32_rz(x - big)


def products_3x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One tensor-core step of 3xTF32 for a [M, k] x [k, N] chunk: TF32
    operands multiply exactly (float64 holds their products), the small
    terms first, then big * big, rounded into f32."""
    ab, as_ = (t.double() for t in split(a))
    bb, bs = (t.double() for t in split(b))
    return ((as_ @ bb + ab @ bs) + ab @ bb).float()


def products_1x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product per f32 product."""
    return (tf32_rna(a).double() @ tf32_rna(b).double()).float()


def f32_rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> f32 rounded toward zero, as an ``mma``'s f32 result."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def products_3x_rz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as ``mma.cuh``'s ``mma_3xtf32`` computes it on the card:
    per k step of 8, three ``mma``s into a fresh accumulator (small * big,
    big * small, big * big), each result truncated to f32 toward zero,
    then added to the running f32 sum (round to nearest)."""
    ab, as_ = (t.double() for t in split(a))
    bb, bs = (t.double() for t in split(b))
    total = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        t = f32_rz(as_[:, s] @ bb[s])
        t = f32_rz(t.double() + ab[:, s] @ bs[s])
        t = f32_rz(t.double() + ab[:, s] @ bb[s])
        total = total + t
    return total


def products_3x_rz_whole_k(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the discrete act kernel's wgmma route computes it on the
    card: per k step of 8, three products (small * big, big * small, big *
    big) into one accumulator that holds the whole K, each step's f32
    result truncated toward zero."""
    ab, as_ = (t.double() for t in split(a))
    bb, bs = (t.double() for t in split(b))
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        acc = f32_rz(acc.double() + as_[:, s] @ bb[s])
        acc = f32_rz(acc.double() + ab[:, s] @ bs[s])
        acc = f32_rz(acc.double() + ab[:, s] @ bb[s])
    return acc


def lecun_normal(rng: np.random.Generator, fan_in: int, shape: tuple[int, int]) -> np.ndarray:
    """flax's default kernel init (the port's ``lecun_normal_``): a normal
    of variance ``1 / fan_in`` truncated at two of its stds."""
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = rng.normal(size=shape)
    while (bad := np.abs(w) > 2.0).any():
        w[bad] = rng.normal(size=int(bad.sum()))
    return w * std


def act_torso_outputs(obs: torch.Tensor, chains, products) -> list[torch.Tensor]:
    """Each chain's head outputs: two relu layers whose products are
    ``products`` (the bias added after it, as the kernel adds it to the
    accumulator), then an f32 head (the CUDA cores' narrow sums)."""
    outs = []
    for w0, w1, head in chains:
        h = torch.relu(products(obs, w0))
        h = torch.relu(products(h, w1))
        outs.append(h @ head)
    return outs


def weight_sum(a: torch.Tensor, b: torch.Tensor, products, groups: int = 64, chunk: int = 8) -> torch.Tensor:
    """``a^T b`` over rows as the tiled weight products sum it: each group
    of rows accumulates chunk after chunk in f32, then the groups'
    partials are added in order in f32."""
    rows = a.shape[0]
    per = rows // groups
    total = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float32)
    for g in range(groups):
        acc = torch.zeros_like(total)
        for r in range(g * per, (g + 1) * per, chunk):
            acc = acc + products(a[r : r + chunk].T.contiguous(), b[r : r + chunk])
        total = total + acc
    return total


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).norm() / want.norm())


def test_tf32_rounding_is_to_nearest_ties_away() -> None:
    ulp = 2.0**-10
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 4, 1.0 + 3 * ulp / 4, -(1.0 + ulp / 2), 3.0e-3], dtype=torch.float32)
    got = tf32_rna(x)
    assert got[:5].tolist() == [1.0, 1.0 + ulp, 1.0, 1.0 + ulp, -(1.0 + ulp)]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert tf32_rz(torch.tensor([1.0 + 3 * ulp / 4])).item() == 1.0
    # big + small keeps ~21 bits: the split's error is at f32's scale.
    v = torch.from_numpy(np.random.default_rng(0).normal(size=10_000).astype(np.float32))
    big, small = split(v)
    assert float(((big.double() + small.double()) - v.double()).abs().max() / v.abs().max()) < 2.0**-20


@pytest.mark.parametrize("seed", [0, 1])
def test_256_deep_dot_products(seed: int) -> None:
    """[64, 256] x [256, 256], the row pass's dense products (h W, and
    dpre W^T) at the default torso width."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(np.maximum(rng.normal(size=(64, 256)), 0.0).astype(np.float32) * 30.0)
    b = torch.from_numpy((rng.normal(size=(256, 256)) / 16.0).astype(np.float32))
    want = a.double() @ b.double()
    assert rel_err(products_3x(a, b), want) <= PPO_GRAD_RTOL / 10
    assert rel_err(products_1x(a, b), want) > PPO_GRAD_RTOL


@pytest.mark.parametrize("seed", [0, 1])
def test_weight_gradient_sums_over_65536_rows(seed: int) -> None:
    """dW = h^T dpre over 65,536 rows, 64 groups: relu activations against
    zero-mean cotangents of the loss's 1 / n_rows scale."""
    rng = np.random.default_rng(seed)
    rows = 65_536
    h = torch.from_numpy(np.maximum(rng.normal(size=(rows, 8)), 0.0).astype(np.float32) * 20.0)
    dpre = torch.from_numpy((rng.normal(size=(rows, 8)) / rows).astype(np.float32))
    want = h.double().T @ dpre.double()
    assert rel_err(weight_sum(h, dpre, products_3x), want) <= PPO_GRAD_RTOL / 10
    assert rel_err(weight_sum(h, dpre, products_1x), want) > PPO_GRAD_RTOL


@pytest.mark.parametrize("shape", ["lstm_gates", "chain_dh", "act_torso"])
def test_truncating_3xtf32_products_at_the_act_and_chain_shapes(shape: str) -> None:
    """``lstm_gates``: a recurrent act step's gate pre-activations, [x | h]
    [8192, 257] x [Wi; Wh] [257, 1024] (observations in +-3, h in (-1, 1),
    lecun-scale Wi and orthogonal-scale Wh); ``chain_dh``: the chain
    backward's dh = dpre W^T, [4096, 128] x [128, 128]. Truncated 3xTF32
    stays ten times under the checks' absolute tolerance against float64.

    ``act_torso``: the discrete act kernel's forward at the main path's
    shapes, as ``chip_smoke.py``'s ``check_act`` drives it: 8,192 rows of
    observations in +-100 through twin 256-wide relu torsos at the default
    init (lecun-normal kernels, zero biases; both heads lecun-normal, as
    ``check_act`` redraws the logits head), every layer's product in
    truncated 3xTF32 with the whole K in one accumulator. What the act
    checks compare, the log-probs (the logits' log-softmax, A=1, n=2) and
    the value, stays ten times inside their limit against float64, ``|k -
    p| <= (ACT_ATOL + ACT_RTOL |p|) / 10`` (values reach ~200, so an
    absolute bound alone would not hold f32 itself); one TF32 product per
    f32 product breaks the limit itself."""
    rng = np.random.default_rng(7)
    if shape == "act_torso":
        obs = rng.uniform(-100.0, 100.0, size=(8192, 1))
        chains = [(lecun_normal(rng, 1, (1, 256)), lecun_normal(rng, 256, (256, 256)), lecun_normal(rng, 256, (256, n)))
                  for n in (2, 1)]
        obs32 = torch.from_numpy(obs.astype(np.float32))
        chains32 = [tuple(torch.from_numpy(w.astype(np.float32)) for w in chain) for chain in chains]
        want = act_torso_outputs(obs32.double(), [tuple(w.double() for w in c) for c in chains32],
                                 lambda a, b: a @ b)

        def ratio(products) -> float:
            logits, values = act_torso_outputs(obs32, chains32, products)
            pairs = ((torch.log_softmax(logits.double(), 1), torch.log_softmax(want[0], 1)), (values, want[1]))
            return max(float(((g.double() - w).abs() / (ACT_ATOL + ACT_RTOL * w.abs())).max()) for g, w in pairs)

        assert ratio(products_3x_rz_whole_k) <= 0.1
        assert ratio(products_1x) > 1.0
        return
    if shape == "lstm_gates":
        x = rng.uniform(-3.0, 3.0, size=(8192, 1))
        h = rng.uniform(-1.0, 1.0, size=(8192, 256))
        a = np.concatenate([x, h], axis=1)
        b = np.concatenate([rng.normal(size=(1, 1024)), rng.normal(size=(256, 1024)) / 16.0])
        tol = ACT_ATOL / 10
    else:
        a = rng.normal(size=(4096, 128)) * np.maximum(rng.normal(size=(4096, 128)), 0.0)
        b = rng.normal(size=(128, 128)) / np.sqrt(128.0)
        tol = CHAIN_ATOL / 10
    a32, b32 = torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b.astype(np.float32))
    want = a32.double() @ b32.double()
    assert float((products_3x_rz(a32, b32).double() - want).abs().max()) <= tol
