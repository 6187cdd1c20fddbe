"""Why the update kernels multiply in 3xTF32, pinned on the CPU. (Two
cases of the staged torso test are split off into
``tests/test_torch_tf32_torso.py``, which uses the helpers here, to
spread the run time over the test workers.)

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

The act kernels' staged routes (``csrc/act.cu`` past 256 wide,
``csrc/rnn_act.cu`` past the 32-row tiles) run the LSTM's gate products
and the discrete torso's layers on 3xTF32 ``wgmma`` (``csrc/stage.cuh``'s
``tc_product``: ``bwd_product``'s fresh accumulator every 32 k, an f32
running sum, the bias added after; for the gates x Wi, its k padded to a
whole stage of 32, then h Wh, in one run of chunks), and the continuous
torso's layers in f32 on the CUDA cores (``fwd_product``: each output one
accumulator, in order of k, one ``fmaf`` a term, from 0, the bias added
after; ``kernel_variants.py`` also runs the gates and the discrete layers
that way, from the bias for the gates). The staged cases emulate both at
the routes' depths against float64 as a share of the act checks' limit;
one TF32 product per f32 product breaks the limit at every one of them.

The update kernels' wide routes (``csrc/stage.cuh``'s ``bwd_product``, in
``ppo_staged_bwd_kernel`` and ``rnn_staged_bwd_kernel``) and the chain backward's
staged route (``chains_dh_kernel``) run the backward's dh products on
3xTF32 ``wgmma`` over a block's 128 rows, at depths of 1024 to 6468. ``wgmma``'s accumulator rounds each k step toward zero; held over the
whole K, that bias passes a tenth of the update checks' limit from K ~
2400 up, so the kernel starts a fresh accumulator every 32 k (one stage)
and adds it to an f32 running sum. The wide cases emulate exactly that and hold it ten
times inside the limit against float64, where one TF32 product per f32
product misses the limit and one whole-K accumulator misses the margin.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


def products_3x_rz_chunked(a: torch.Tensor, b: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """``a @ b`` as the wide routes' ``bwd_product`` computes it on the
    card: per ``chunk`` of k, a fresh ``wgmma`` accumulator over its k steps
    of 8 (``products_3x_rz_whole_k``), added in order to an f32 running sum
    (round to nearest)."""
    total = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], chunk):
        total = total + products_3x_rz_whole_k(a[:, k : k + chunk], b[k : k + chunk])
    return total


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


#: The wide routes' dh products at their depths over the 128 rows of one
#: row-pass block (a pass of 128 output units): the feedforward dh_{l-1} =
#: dpre_l W_l^T at K = 1024 (``wide_torso``) and 2388 (the widest torso
#: ``rl8_tpu``'s gate admits), the recurrent dh_t = dz Wh^T and dx = dz
#: Wi^T at K = 4H = 4096 (``wide_recurrent``) and 6468 (H = 1617, the gate's
#: widest LSTM), and the chain backward's staged dh = dpre W^T
#: (``csrc/chains.cu``'s ``chains_dh_kernel`` on ``bwd_product``) at K =
#: 2382, MischievousMule's widest layer that ``rl8_tpu``'s gate admits.
WIDE_DH = {"ppo_1024": (1024, "ppo"), "ppo_2388": (2388, "ppo"), "rnn_4096": (4096, "rnn"), "rnn_6468": (6468, "rnn"),
           "chain_2382": (2382, "ppo")}


def wide_dh_operands(K: int, kind: str, seed: int = 11) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cotangents [128, K], W^T [K, 128])``: relu-gated normal cotangents
    against lecun-normal W (``ppo``), or gate cotangents (a product of
    normals and gate derivatives in (0, 1/4]) against W of the LSTM's
    1 / sqrt(H) scale (``rnn``)."""
    rng = np.random.default_rng(seed)
    if kind == "ppo":
        a = rng.normal(size=(128, K)) * (rng.normal(size=(128, K)) > 0.0)
        w = lecun_normal(rng, K, (K, 128))
    else:
        a = rng.normal(size=(128, K)) * rng.uniform(0.0, 0.25, size=(128, K))
        w = rng.normal(size=(K, 128)) / np.sqrt(K / 4)
    return torch.from_numpy(a.astype(np.float32)), torch.from_numpy(w.astype(np.float32))


@pytest.mark.parametrize("case", list(WIDE_DH))
def test_wide_route_dh_products_in_64_deep_wgmma_chunks(case: str) -> None:
    """The wide routes' dh products as ``bwd_product`` sums them (fresh
    truncating accumulators every 32 k, an f32 running sum) stay ten times
    inside the update checks' norm-relative limit against float64; one
    TF32 product per f32 product breaks the limit itself."""
    K, kind = WIDE_DH[case]
    a, w = wide_dh_operands(K, kind)
    want = a.double() @ w.double()
    assert rel_err(products_3x_rz_chunked(a, w), want) <= PPO_GRAD_RTOL / 10
    assert rel_err(products_1x(a, w), want) > PPO_GRAD_RTOL


@pytest.mark.parametrize("case", ["ppo_2388", "rnn_4096", "rnn_6468", "chain_2382"])
def test_whole_k_wgmma_accumulator_misses_the_margin_at_wide_depths(case: str) -> None:
    """Why ``bwd_product`` folds its accumulator every 32 k: one truncating
    accumulator over the whole K (as the act kernel's ``wgmma`` route holds
    its 256-deep layers) biases the products past a tenth of the update
    checks' limit at these depths."""
    K, kind = WIDE_DH[case]
    a, w = wide_dh_operands(K, kind)
    want = a.double() @ w.double()
    assert rel_err(products_3x_rz_whole_k(a, w), want) > PPO_GRAD_RTOL / 10


def deep_dh_chain(layers: int, products) -> torch.Tensor:
    """The chain backward's dh down ``layers`` relu layers of 128 units
    over one 128-row block (MischievousMule's deepest admitted layout is 324
    layers of 128): dh_{l-1} = (dh_l * mask_l) W_l^T by ``products``, W_l
    at He's scale, masks half open, from normal cotangents."""
    rng = np.random.default_rng(31)
    dh = torch.from_numpy(rng.normal(size=(128, 128)).astype(np.float32))
    for _ in range(layers):
        w = torch.from_numpy((rng.normal(size=(128, 128)) * np.sqrt(2.0 / 128)).astype(np.float32))
        mask = torch.from_numpy(rng.random(size=(128, 128)) > 0.5)
        dh = products(dh * mask, w.T.contiguous()).float()
    return dh


def test_deep_chain_dh_products_in_32_deep_wgmma_chunks() -> None:
    """Why ``bwd_product`` folds every 32 k, not 64: each fold leaves the
    bias of its truncating accumulator, and down a deep chain's dh products
    that bias compounds. At 324 layers of 128 (the card measured the chain
    backward 1.2e-4 off float64 at 64 k a chunk, the plain f32 version
    2.4e-5) 64-deep chunks pass the update checks' norm-relative limit and
    32-deep ones stay inside it."""
    want = deep_dh_chain(324, lambda a, b: a.double() @ b.double())
    assert rel_err(deep_dh_chain(324, products_3x_rz_chunked), want) <= 0.8 * PPO_GRAD_RTOL
    assert rel_err(deep_dh_chain(324, lambda a, b: products_3x_rz_chunked(a, b, 64)), want) > PPO_GRAD_RTOL


def f32_fma_sum(a: torch.Tensor, w: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """``start + a @ w`` as ``fwd_product`` sums it: one f32 accumulator per
    output, one fused multiply-add a k in order of k (the product exact in
    float64, the sum rounded to f32 once per term)."""
    acc = start.float().clone()
    a64, w64 = a.double(), w.double()
    for k in range(a.shape[1]):
        acc = (acc.double() + a64[:, k : k + 1] * w64[k : k + 1]).float()
    return acc


#: The LSTM gate sums of ``rnn_gates_tc_kernel`` over 128 rows (d_x, H):
#: the gate pre-activations at H = 1024 (``wide_recurrent``'s act; x Wi
#: over the obs dim 1, then h Wh over 1024) and H = 1617 (the gate's
#: widest), and a second layer's (x of 1024 h' values).
STAGED = {"lstm_1024": (1, 1024), "lstm_1617": (1, 1617), "lstm_layer2_1024": (1024, 1024)}

#: The continuous act kernel's staged layers (f32, ``fwd_product``) over
#: 128 rows and one 256-column tile: a torso layer at 1024 (``wide_torso``)
#: and 2388 (the widest admitted twin torso).
STAGED_TORSO = {"torso_1024": 1024, "torso_2388": 2388}


@pytest.mark.parametrize("case", list(STAGED_TORSO))
def test_staged_act_sums_in_f32_order_of_k(case: str) -> None:
    """The continuous kinds' staged layer sums in f32 in order of k against
    float64, as a share of the act checks' limit ``ACT_ATOL + ACT_RTOL
    |p|``: relu activations of a wide cell's spread, up to ~80, against
    lecun-normal weights, outputs up to ~65, within a quarter of it, and
    within twice what torch's own f32 product reaches on the same inputs
    (~0.09 of the limit: f32 itself leaves no tenfold margin at outputs of
    that size)."""
    d_x = STAGED_TORSO[case]
    rng = np.random.default_rng(23)
    a = np.maximum(rng.normal(size=(128, d_x)), 0.0) * 20.0
    w = lecun_normal(rng, d_x, (d_x, 256))
    start = np.zeros((128, 256))
    a32, w32, s32 = (torch.from_numpy(v.astype(np.float32)) for v in (a, w, start))
    want = s32.double() + a32.double() @ w32.double()

    def share(got: torch.Tensor) -> float:
        return float(((got.double() - want).abs() / (ACT_ATOL + ACT_RTOL * want.abs())).max())

    staged = share(f32_fma_sum(a32, w32, s32))
    assert staged <= 0.25
    assert staged <= 2 * share(s32 + a32 @ w32)


def staged_gate_operands(d_x: int, H: int, seed: int = 23):
    """A 128-row block's gate operands for one 128-column tile: ``[x, 0, h]``
    with x's k padded to a whole stage of 32 (observations in +-3 when
    ``d_x`` is 1, else a layer's h' in (-1, 1)), ``[Wi; 0; Wh]`` at the
    LSTM's 1 / sqrt(H) scale, a bias of a few tenths; and the float64
    pre-activations."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, size=(128, d_x)) if d_x == 1 else rng.uniform(-1.0, 1.0, size=(128, d_x))
    pad = (-d_x) % 32
    a = np.concatenate([x, np.zeros((128, pad)), rng.uniform(-1.0, 1.0, size=(128, H))], 1)
    w = np.concatenate([rng.uniform(-1.0, 1.0, size=(d_x, 128)), np.zeros((pad, 128)),
                        rng.uniform(-1.0, 1.0, size=(H, 128))], 0) / np.sqrt(H)
    b = rng.uniform(-0.3, 0.3, size=(1, 128))
    a32, w32, b32 = (torch.from_numpy(v.astype(np.float32)) for v in (a, w, b))
    return a32, w32, b32, a32.double() @ w32.double() + b32.double()


@pytest.mark.parametrize("case", ["lstm_1024", "lstm_1617", "lstm_layer2_1024"])
def test_staged_wgmma_gates_in_64_deep_chunks(case: str) -> None:
    """``rnn_gates_tc_kernel``'s sums (x Wi then h Wh through
    ``tc_product``'s 32-deep chunks, then the bias) stay ten times inside
    the act checks' limit against float64 at the gate depths of
    ``wide_recurrent`` (1 + 1024), the gate's widest LSTM (1 + 1617) and a
    second 1024-wide layer (1024 + 1024); one TF32 product per f32 product
    breaks the limit."""
    d_x, H = STAGED[case]
    a, w, b, want = staged_gate_operands(d_x, H)

    def share(got: torch.Tensor) -> float:
        return float(((got.double() - want).abs() / (ACT_ATOL + ACT_RTOL * want.abs())).max())

    assert share(products_3x_rz_chunked(a, w) + b) <= 0.1
    assert share(products_1x(a, w) + b) > 1.0


@pytest.mark.parametrize("width", [2388])
def test_staged_wgmma_torso_in_64_deep_chunks(width: int) -> None:
    """``check_staged_wgmma_torso`` at the widest admitted twin torso (1025
    and 1813 in ``tests/test_torch_tf32_torso.py``)."""
    check_staged_wgmma_torso(width)


def check_staged_wgmma_torso(width: int) -> None:
    """The discrete act kernel's staged route at twin torsos of ``width``
    (the second layer's k 1025 to 2388), as ``wide_sweep`` drives it: 256
    rows of observations 20 N(0, 1) through two relu layers whose products
    are ``tc_product``'s (32-deep chunks; the first layer's k of 1 padded
    to a stage), then f32 heads (lecun-normal, as the checks draw them).
    What the act checks compare, the log-probs (A=1, n=2) and the value,
    stays within a quarter of their limit against float64 (torch's own f32
    products reach 0.03-0.07 of it there), and one TF32 product per f32
    product breaks the limit."""
    rng = np.random.default_rng(29)
    obs = torch.from_numpy((rng.normal(size=(256, 1)) * 20.0).astype(np.float32))
    chains = [tuple(torch.from_numpy(m.astype(np.float32)) for m in
                    (lecun_normal(rng, 1, (1, width)), lecun_normal(rng, width, (width, width)),
                     lecun_normal(rng, width, (width, n)))) for n in (2, 1)]
    want = act_torso_outputs(obs.double(), [tuple(m.double() for m in c) for c in chains], lambda a, b: a @ b)

    def share(products) -> float:
        logits, values = act_torso_outputs(obs, chains, products)
        pairs = ((torch.log_softmax(logits.double(), 1), torch.log_softmax(want[0], 1)), (values, want[1]))
        return max(float(((g.double() - w).abs() / (ACT_ATOL + ACT_RTOL * w.abs())).max()) for g, w in pairs)

    assert share(products_3x_rz_chunked) <= 0.25
    assert share(products_1x) > 1.0
