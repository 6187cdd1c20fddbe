"""The feedforward update's products on ``wgmma``, emulated on the CPU as the
card rounds them, at the main path's shapes.

``csrc/wgrad.cuh``'s ``reduce_wgmma_kernel`` sums each weight product dW =
h^T dpre over its rows on 3xTF32 ``wgmma``: the rows split into groups (4,096
rows each up to 64 groups, ``split_rows``), each group walks its rows 32 at a
time, and each 32-row chunk is a fresh tensor-core accumulator over 4 k steps
of 8 rows, each of the three products (small * big, big * small, big * big)
of a step truncating the f32 sum toward zero, which the CUDA cores add into
the group's f32 running sum in order; the groups' partials are then added in
a fixed order (``sum_partials_kernel``). The row pass's dh products
(``stage.cuh``'s ``bwd_product``, 128 rows a block) sum dh = dpre W^T over
the layer's units in 32-deep fresh accumulators the same way, and the first
layer's gradient (K = d_in, a small job) is summed from dh's rows on the
CUDA cores in f32 by ``reduce_small_kernel``: in order within each of 8
slices of a group's rows, then the slices in order.

Each case holds the emulation against float64 at ten times inside
``chip_smoke.py``'s gradient limit (``||k - p|| <= 1e-4 ||p|| + 1e-6``, here
as a norm-relative error), over 65,536 rows of twin 256-wide relu torsos'
activations and cotangents, and shows that one TF32 product per f32 product
breaks the limit itself.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_tf32 import (
    PPO_GRAD_RTOL,
    lecun_normal,
    products_1x,
    products_3x_rz_chunked,
    rel_err,
    split,
    tf32_rna,
)

#: Rows of the emulated minibatch, and wgrad.cuh's rows per group.
ROWS = 65_536
GROUP_ROWS = 4096
#: A wgmma accumulator's rows (wgrad.cuh's kChunk), in k steps of 8.
CHUNK = 32


def f32_rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> f32 rounded toward zero, as a ``wgmma``'s f32 result: the
    float64 bits past f32's 24-bit significand cleared (exact for the normal
    f32 range these sums stay in), then converted exactly."""
    return (x.view(torch.int64) & ~0x1FFFFFFF).view(torch.float64).float()


def torso_operands(seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(h [ROWS, 256], dpre [ROWS, 256])``: relu activations of the main
    path's spread (observations 20 N(0, 1) give h up to ~80) and cotangents
    of the loss's 1 / n_rows scale, half of them cut by the relu masks."""
    rng = np.random.default_rng(seed)
    h = np.maximum(rng.normal(size=(ROWS, 256)), 0.0) * 20.0
    dpre = rng.normal(size=(ROWS, 256)) / ROWS * (rng.random(size=(ROWS, 256)) > 0.5)
    return torch.from_numpy(h.astype(np.float32)), torch.from_numpy(dpre.astype(np.float32))


def wgmma_weight_sum(h: torch.Tensor, dpre: torch.Tensor, three: bool = True) -> torch.Tensor:
    """``h^T dpre`` as ``reduce_wgmma_kernel`` sums it (see the module's
    docstring): per group of GROUP_ROWS rows, per chunk of CHUNK rows a fresh
    accumulator over k steps of 8, each product's f32 result truncated toward
    zero, the chunks added in order in f32, then the groups' partials in
    order. ``three=False``: one TF32 product (big * big) a step instead of
    three."""
    rows, K = h.shape
    J = dpre.shape[1]
    hb, hs = (t.double() for t in split(h))
    db, ds = (t.double() for t in split(dpre))
    if not three:
        hb, db = tf32_rna(h).double(), tf32_rna(dpre).double()
    total = torch.zeros((K, J), dtype=torch.float32)
    for g0 in range(0, rows, GROUP_ROWS):
        run = torch.zeros((K, J), dtype=torch.float32)
        for b0 in range(g0, g0 + GROUP_ROWS, 32 * CHUNK):  # 32 chunks at a time, as a batch
            rs = slice(b0, b0 + 32 * CHUNK)
            ab, bb = hb[rs].reshape(-1, CHUNK, K), db[rs].reshape(-1, CHUNK, J)
            a_s, b_s = hs[rs].reshape(-1, CHUNK, K), ds[rs].reshape(-1, CHUNK, J)
            acc = None
            for k in range(0, CHUNK, 8):
                s = slice(k, k + 8)
                terms = [ab[:, s].transpose(1, 2) @ bb[:, s]]
                if three:
                    terms = [a_s[:, s].transpose(1, 2) @ bb[:, s], ab[:, s].transpose(1, 2) @ b_s[:, s], *terms]
                for term in terms:
                    acc = f32_rz(term if acc is None else acc.double() + term)
            for c in range(acc.shape[0]):
                run = run + acc[c]
        total = total + run
    return total


#: reduce_small_kernel's slices of a group's rows (its warps).
SLICES = 8


def f32_group_sums(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x^T v`` for one input column x [rows, 1] as ``reduce_small_kernel``
    sums it: per group, each of SLICES equal slices of its rows one f32
    fused multiply-add a row in order (exact product, one rounding), the
    slices' sums added in order, then the groups in order."""
    x64, v64 = x.double(), v.double()
    total = torch.zeros(v.shape[1], dtype=torch.float32)
    per = GROUP_ROWS // SLICES
    for g0 in range(0, x.shape[0], GROUP_ROWS):
        group = torch.zeros(v.shape[1], dtype=torch.float32)
        for s0 in range(g0, g0 + GROUP_ROWS, per):
            s = torch.zeros(v.shape[1], dtype=torch.float32)
            for n in range(s0, s0 + per):
                s = (s.double() + x64[n] * v64[n]).float()
            group = group + s
        total = total + group
    return total


@pytest.mark.parametrize("seed", [0, 1])
def test_wgmma_weight_products_over_65536_rows(seed: int) -> None:
    """dW = h^T dpre of a 256 x 256 torso layer over 65,536 rows (16 groups
    of 4,096), as the redesigned weight products sum it on the card: ten
    times inside the gradient limit against float64; one TF32 product per f32
    product breaks the limit (already over the first 16,384 rows)."""
    h, dpre = torso_operands(seed)
    want = h.double().T @ dpre.double()
    assert rel_err(wgmma_weight_sum(h, dpre), want) <= PPO_GRAD_RTOL / 10
    few = slice(0, 4 * GROUP_ROWS)
    assert rel_err(wgmma_weight_sum(h[few], dpre[few], three=False), h[few].double().T @ dpre[few].double()) > PPO_GRAD_RTOL


def test_row_pass_dh_products_and_the_gradients_they_reach() -> None:
    """The row pass's dh_0 = dpre_1 W_1^T at 256 x 256 over 65,536 rows (512
    blocks of 128 rows; each row's sum in 32-deep fresh accumulators), then
    dpre_0 = dh_0 * relu'(h_0) and what it reaches: the first layer's db_0
    and dW_0 (K = d_in = 1, observations 20 N(0, 1)), summed in f32 by the
    small jobs. dh and both gradients stay ten times inside the gradient
    limit against float64; with one TF32 product per f32 product dh breaks
    it."""
    rng = np.random.default_rng(5)
    obs = torch.from_numpy((rng.normal(size=(ROWS, 1)) * 20.0).astype(np.float32))
    dpre1 = torch.from_numpy((rng.normal(size=(ROWS, 256)) / ROWS * (rng.random(size=(ROWS, 256)) > 0.5))
                             .astype(np.float32))
    w1t = torch.from_numpy(lecun_normal(rng, 256, (256, 256)).astype(np.float32)).T.contiguous()
    mask = torch.from_numpy(rng.random(size=(ROWS, 256)) > 0.5)
    want_dh = dpre1.double() @ w1t.double()
    dh = torch.cat([products_3x_rz_chunked(dpre1[r : r + 4096], w1t) for r in range(0, ROWS, 4096)])
    assert rel_err(dh, want_dh) <= PPO_GRAD_RTOL / 10
    one = torch.cat([products_1x(dpre1[r : r + 4096], w1t) for r in range(0, ROWS, 4096)])
    assert rel_err(one, want_dh) > PPO_GRAD_RTOL
    want_dpre0 = want_dh * mask
    dpre0 = dh * mask
    ones = torch.ones((ROWS, 1), dtype=torch.float32)
    for x in (ones, obs):
        want = (x.double() * want_dpre0).sum(0)
        assert rel_err(f32_group_sums(x, dpre0), want) <= PPO_GRAD_RTOL / 10
