"""The recurrent update's backward through time as ``csrc/rnn_ppo.cu``'s
staged route rounds it, pinned on the CPU at the Recurrent cell's widths
(the helpers, tolerances and rounding model of ``tests/test_torch_tf32.py``,
whose docstring explains the emulation).

``rnn_staged_bwd_kernel`` runs the cell backward elementwise in f32 and the
dh products dh_t = dz Wh^T (1024 deep at H 256) on 3xTF32 ``wgmma``
(``csrc/stage.cuh``'s ``bwd_passes``): a fresh truncating accumulator every
32 k, added in order to an f32 running sum. Its forward stays in f32 on the
CUDA cores. Here a minibatch of 1,024 sequences of 4 steps through one
256-wide LSTM layer and three head outputs, drawn with numpy, runs its
forward in f32 and its backward through time with the dh products summed
as the card sums them, and the gradients of Wi, Wh and b are held against
the same backward in float64 at a tenth of the update checks' limit
(``||k - p|| <= 1e-5 ||p|| + 1e-7``). One TF32 product per f32 product in
the dh products breaks that margin.

The act kernel's staged route sums the gates ``x Wi`` then ``h Wh`` the same
way (``tc_product``); its case here holds them at H 256 (257 deep) ten
times inside the act checks' limit, where one TF32 product per f32 product
breaks the limit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_tf32 import (
    ACT_ATOL,
    ACT_RTOL,
    PPO_GRAD_RTOL,
    lecun_normal,
    products_1x,
    products_3x_rz_chunked,
    rel_err,
    split,
    staged_gate_operands,
)

#: The update checks' absolute term (chip_smoke.py PPO_GRAD_ATOL).
PPO_GRAD_ATOL = 1e-6
#: The Recurrent cell's shapes: sequences (1,024 of its 65,536: 4,096 samples),
#: steps, width, input and head outputs.
N, L, H, D_IN, N_OUT = 1024, 4, 256, 1, 3


def lstm_inputs(seed: int = 7) -> dict[str, np.ndarray]:
    """A minibatch and a model as the Recurrent cell draws them: obs 3 N(0,
    1), stored h in (-1, 1) and c of a few units, Wi lecun-normal, Wh at the
    LSTM's 1 / sqrt(H) scale, a bias of a few tenths, heads in +-0.3 and
    head cotangents N(0, 1)."""
    rng = np.random.default_rng(seed)
    return {
        "obs": 3.0 * rng.normal(size=(N, L, D_IN)),
        "h0": rng.uniform(-1.0, 1.0, size=(N, H)),
        "c0": 2.0 * rng.normal(size=(N, H)),
        "wi": lecun_normal(rng, D_IN, (D_IN, 4 * H)),
        "wh": rng.normal(size=(H, 4 * H)) / np.sqrt(H),
        "b": rng.uniform(-0.3, 0.3, size=(4 * H,)),
        "wo": rng.uniform(-0.3, 0.3, size=(H, N_OUT)),
        "dout": rng.normal(size=(N, L, N_OUT)),
    }


def lstm_grads(inputs: dict[str, np.ndarray], dtype: torch.dtype, dh_products) -> list[torch.Tensor]:
    """``[dWi, dWh, db]`` of one LSTM layer over the minibatch: the forward
    (gates i, f, g, o), then the backward through time in reverse as
    ``rnn_staged_bwd_kernel`` runs it: dh = dh_t + dout Wo^T, the cell
    backward into dz, and dh_t = ``dh_products(dz, Wh^T)`` for the step
    before (none before step 0). The weight sums run in float64 on the
    ``dtype`` operands, so that only the dh products' rounding differs
    from float64's."""
    t = {k: torch.from_numpy(v).to(dtype) for k, v in inputs.items()}
    h, c = t["h0"], t["c0"]
    xs, hs, cs, gates = [], [h], [c], []
    for s in range(L):
        x = t["obs"][:, s]
        z = t["b"] + x @ t["wi"] + h @ t["wh"]
        gi, gf, gg, go = torch.sigmoid(z[:, :H]), torch.sigmoid(z[:, H:2 * H]), torch.tanh(z[:, 2 * H:3 * H]), \
            torch.sigmoid(z[:, 3 * H:])
        c = gf * c + gi * gg
        h = go * torch.tanh(c)
        xs.append(x)
        hs.append(h)
        cs.append(c)
        gates.append((gi, gf, gg, go))
    dwi = torch.zeros((D_IN, 4 * H), dtype=torch.float64)
    dwh = torch.zeros((H, 4 * H), dtype=torch.float64)
    db = torch.zeros(4 * H, dtype=torch.float64)
    dh_t = dc_t = None
    for s in reversed(range(L)):
        dh = t["dout"][:, s] @ t["wo"].T
        if dh_t is not None:
            dh = dh_t + dh
        gi, gf, gg, go = gates[s]
        tc = torch.tanh(cs[s + 1])
        dc = dh * go * (1.0 - tc * tc) + (dc_t if dc_t is not None else 0.0)
        dz = torch.cat([dc * gg * gi * (1.0 - gi), dc * cs[s] * gf * (1.0 - gf), dc * gi * (1.0 - gg * gg),
                        dh * tc * go * (1.0 - go)], 1)
        dc_t = dc * gf
        if s > 0:
            dh_t = dh_products(dz, t["wh"].T.contiguous()).to(dtype)
        dwi += xs[s].double().T @ dz.double()
        dwh += hs[s].double().T @ dz.double()
        db += dz.double().sum(0)
    return [dwi, dwh, db]


def within(got: list[torch.Tensor], want: list[torch.Tensor], share: float) -> list[bool]:
    """Each gradient within ``share`` of the update checks' limit."""
    return [float((g - w).norm()) <= share * (PPO_GRAD_RTOL * float(w.norm()) + PPO_GRAD_ATOL)
            for g, w in zip(got, want)]


@pytest.fixture(scope="module")
def backward() -> dict[str, list[torch.Tensor]]:
    """The gradients in float64, and in f32 with the dh products summed in
    3xTF32 32-deep chunks (the staged route) and in one TF32 product per
    f32 product."""
    inputs = lstm_inputs()
    return {
        "f64": lstm_grads(inputs, torch.float64, lambda a, b: a @ b),
        "staged": lstm_grads(inputs, torch.float32, products_3x_rz_chunked),
        "one_tf32": lstm_grads(inputs, torch.float32, products_1x),
    }


def test_staged_dh_products_stay_a_tenth_inside_the_gradient_limit(backward) -> None:
    """The staged route's rounding keeps dWi, dWh and db ten times inside
    the update checks' limit against float64."""
    assert all(within(backward["staged"], backward["f64"], 0.1)), [
        rel_err(g, w) for g, w in zip(backward["staged"], backward["f64"])]


def test_one_tf32_product_breaks_the_margin(backward) -> None:
    """One TF32 product per f32 product in the dh products puts the
    gradients past a tenth of the limit."""
    assert not all(within(backward["one_tf32"], backward["f64"], 0.1)), [
        rel_err(g, w) for g, w in zip(backward["one_tf32"], backward["f64"])]


def test_split_halves_add_up() -> None:
    """The emulation's TF32 halves: big + small recovers an f32 operand of
    the dh products to within small's truncation."""
    dz = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 4 * H)).astype(np.float32))
    big, small = split(dz)
    assert float(((big + small) - dz).abs().max()) <= 2.0**-21 * float(dz.abs().max())


def test_staged_gates_at_the_recurrent_cells_width() -> None:
    """The act kernel's staged gates (x Wi then h Wh in 32-deep 3xTF32
    chunks, then the bias) at H 256 and one input stay ten times inside
    the act checks' limit against float64; one TF32 product per f32
    product breaks the limit."""
    a, w, b, want = staged_gate_operands(1, H)

    def share(got: torch.Tensor) -> float:
        return float(((got.double() - want).abs() / (ACT_ATOL + ACT_RTOL * want.abs())).max())

    assert share(products_3x_rz_chunked(a, w) + b) <= 0.1
    assert share(products_1x(a, w) + b) > 1.0
