"""Activation-MLP chains: their layout, plain forward and backward, and
the chain kernels.

PyTorch/CUDA counterpart of ``rl8_tpu/ops/fused_mlp.py``. A chain is
``(layers, heads)``: each layer is ``(W [in, out], b [out])`` or, where
the torso interleaves flax's LayerNorm (``MLP(layer_norm=True)``),
``(W, b, ln_scale, ln_bias)``, and every layer is followed by the
activation (the MLP's inner activations plus the model's trailing one);
each head is a linear ``(W, b)``. Several chains share one input.

- The ONE definition of which submodules of a model the kernels read
  (:func:`chain_names`, :func:`named_chains`, :func:`default_chains`)
  and in what order (:func:`flatten_chains`): the act and update kernels
  of the default models read it too.
- :func:`forward_chains` and :func:`chains_vjp_plain` are the plain
  versions of the chain kernels (``csrc/chains.cu``, replacing
  ``_fwd_kernel`` and ``_bwd_kernel``); :func:`fused_chains_fwd` and
  :func:`fused_chains_bwd` launch them for CUDA tensors or raise, and run
  the plain versions for CPU tensors. :func:`fused_chains` is the
  differentiable op over them, a ``torch.autograd.Function``. Where its
  backward will run, its forward keeps the activations for it: on the
  card where both take their staged routes and the backward holds every
  row at once (the kernels' row scratch, which that backward allocates
  anyway), on the CPU always. Elsewhere (the tiled routes, chunked staged
  backwards) the backward recomputes the activations from ``x``, as the
  TPU's custom VJP does. Either way a forward's outputs are the same bits
  with and without grad mode.
- :func:`model_fits_vmem` and :func:`chains_fit_vmem`: ``rl8_tpu``'s
  residency gates, which send a model too wide for its TPU kernels' VMEM
  to the module forward and the autodiff update; the algorithms AND them
  into their kernel routes where ``rl8_tpu`` does.
- :class:`FusedApplySpec`, :func:`supports_fused_apply`,
  :func:`fused_custom_apply` and :func:`fused_default_apply` run a
  model's forward through :func:`fused_chains`; for custom recurrent
  models, :class:`FusedRecurrentApplySpec`,
  :func:`supports_fused_recurrent_apply` and
  :func:`fused_recurrent_custom_apply`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from ..data import DataKeys
from ..nn.modules.normalization import layer_norm_stats
from ._build import check, load

__all__ = [
    "ACT_FNS",
    "FusedApplySpec",
    "FusedRecurrentApplySpec",
    "card_takes_chains",
    "chain_names",
    "chains_fit_vmem",
    "chain_structure",
    "chains_backward_plain",
    "chains_vjp_plain",
    "default_chains",
    "flatten_chains",
    "forward_chains",
    "fused_chains",
    "fused_chains_bwd",
    "fused_chains_fwd",
    "fused_custom_apply",
    "fused_default_apply",
    "fused_recurrent_custom_apply",
    "load_flat_params",
    "model_fits_vmem",
    "named_chains",
    "supports_fused_apply",
    "supports_fused_recurrent_apply",
    "unflatten_chains",
]

#: Activations the kernels implement, by name (their ``act`` code is
#: the position in this dict).
ACT_FNS = {"relu": torch.relu, "tanh": torch.tanh}
#: Each activation's derivative from its *output* (what the backward
#: keeps), as ``fused_mlp._ACT_GRAD_FROM_OUT`` computes it.
_ACT_GRAD_FROM_OUT = {
    "relu": lambda h: (h > 0.0).to(h.dtype),
    "tanh": lambda h: 1.0 - h * h,
}

Layer = tuple[torch.Tensor, ...]
Chain = tuple[tuple[Layer, ...], tuple[tuple[torch.Tensor, torch.Tensor], ...]]
#: A chain's shape: per layer ``(width, has_layer_norm)``, and the head
#: widths.
ChainShape = tuple[tuple[tuple[int, bool], ...], tuple[int, ...]]
#: ``(d_in, per-chain shapes)``: everything but the values.
Structure = tuple[int, tuple[ChainShape, ...]]

#: ``rl8_tpu``'s VMEM budget for its kernels' resident parameters and
#: row tiles (``rl8_tpu/ops/fused_mlp.py:_VMEM_TOTAL_BUDGET``, 88 MiB of a
#: TPU core's VMEM). It is ``rl8_tpu``'s routing rule, not a limit of the
#: card: the port sends the models it admits to the kernels and the rest to
#: the module forward and the autodiff update, as ``rl8_tpu`` does. The
#: card kernels' own limits are asked of them (:func:`card_takes_chains`,
#: ``fused_ppo.card_takes_update``, ``fused_act.card_takes_act``,
#: ``fused_rnn_ppo.card_takes_rnn_update``, ``fused_rnn_act.card_takes_rnn_act``).
_VMEM_TOTAL_BUDGET = 88 * 1024 * 1024

#: Per-model (torso, heads) layouts, which are also the flax trees'
#: names (``models/convert.py``). Chain 0 is the policy, chain 1 the value.
_DISCRETE_CHAIN_NAMES = (
    ("feature_model", ("feature_head",)),
    ("vf_model", ("vf_head",)),
)
_CONTINUOUS_CHAIN_NAMES = (
    ("latent_model", ("action_mean", "action_log_std")),
    ("vf_model", ("vf_head",)),
)


@dataclass(frozen=True)
class FusedApplySpec:
    """A custom model's declaration of its fused-kernel decomposition
    (``rl8_tpu``'s ``FusedApplySpec``).

    The model's input assembly and output postprocessing stay in plain
    PyTorch; its torso-MLP + linear-head chains run through
    :func:`fused_chains`, whose ``dx`` autograd carries back through
    ``assemble`` (embedding tables and friends get their gradients). The
    model holds its parameters, so ``assemble`` takes only the batch.

    Attributes:
        assemble: ``(batch) -> x [N, d]``, the chains' shared input.
        finalize: ``(batch, outs) -> (features, values)`` from the
            per-chain head-output tuples.
        chain_names: ``((torso, (head, ...)), ...)``: the ``MLP``
            submodule of each chain's torso and the ``nn.Linear`` heads,
            named as in the flax tree.
    """

    assemble: Callable[[Any], torch.Tensor]
    finalize: Callable[[Any, Any], tuple[dict[str, torch.Tensor], torch.Tensor]]
    chain_names: tuple[tuple[str, tuple[str, ...]], ...]


@dataclass(frozen=True)
class FusedRecurrentApplySpec:
    """:class:`FusedApplySpec` for a custom recurrent model (``rl8_tpu``'s
    ``FusedRecurrentApplySpec``): ``assemble`` runs the recurrent front
    half (states thread serially over time) and returns the chains' input
    with the new states; the per-row torso and head chains run through
    :func:`fused_chains`, whose ``dx`` carries the gradient back through
    time.

    Attributes:
        assemble: ``(batch [B, T, ...], states) -> (x [B * T, d],
            new_states)``.
        finalize: ``(batch, outs) -> (features, values)``.
        chain_names: As in :class:`FusedApplySpec`.
    """

    assemble: Callable[[Any, Any], tuple[torch.Tensor, Any]]
    finalize: Callable[[Any, Any], tuple[dict[str, torch.Tensor], torch.Tensor]]
    chain_names: tuple[tuple[str, tuple[str, ...]], ...]


def chain_names(model: Any) -> tuple[tuple[str, tuple[str, ...]], ...]:
    """``(torso, heads)`` submodule names of a model, per chain: the
    default models' fixed layouts, or a custom model's
    ``fused_apply_spec().chain_names``."""
    from ..models import DefaultContinuousModel, DefaultDiscreteModel

    if isinstance(model, DefaultDiscreteModel):
        return _DISCRETE_CHAIN_NAMES
    if isinstance(model, DefaultContinuousModel):
        return _CONTINUOUS_CHAIN_NAMES
    spec = model.fused_apply_spec() if hasattr(model, "fused_apply_spec") else None
    if spec is None:
        raise TypeError(f"No chain layout is known for {type(model).__name__}.")
    return spec.chain_names


def _pair(linear: Any) -> tuple[torch.Tensor, torch.Tensor]:
    if linear.bias is None:
        raise ValueError("The chain kernels need biased linear layers.")
    return linear.weight.t(), linear.bias


def named_chains(model: Any, names: Sequence[tuple[str, Sequence[str]]]) -> tuple[Chain, ...]:
    """The chains of the named torsos and heads, with weights as ``[in,
    out]`` views of the live ``nn.Linear`` weights (autograd reaches the
    parameters through them) and each LayerNorm's scale and bias after
    its layer's."""
    chains = []
    for torso, heads in names:
        mlp = getattr(model, torso)
        layers = []
        for i, linear in enumerate(mlp.layers):
            norm = (mlp.norms[i].scale, mlp.norms[i].bias) if i < len(mlp.norms) else ()
            layers.append((*_pair(linear), *norm))
        chains.append((tuple(layers), tuple(_pair(getattr(model, head)) for head in heads)))
    return tuple(chains)


def default_chains(model: Any) -> tuple[Chain, ...]:
    """``(layers, heads)`` chains of a model (:func:`chain_names`),
    detached from autograd."""
    return tuple(
        (tuple(tuple(p.detach() for p in layer) for layer in layers), tuple((w.detach(), b.detach()) for w, b in heads))
        for layers, heads in named_chains(model, chain_names(model))
    )


def _linears(model: Any) -> list[tuple[Any, ...]]:
    """Per chain, the ``nn.Linear`` modules in kernel order."""
    return [
        (*getattr(model, torso).layers, *(getattr(model, head) for head in heads))
        for torso, heads in chain_names(model)
    ]


def load_flat_params(model: Any, flat: torch.Tensor) -> None:
    """Write a flat vector in :func:`flatten_chains` order back into a
    default model's ``nn.Linear`` weights and biases, in
    place: the inverse of ``flatten_chains(default_chains(model))``."""
    off = 0
    with torch.no_grad():
        for linears in _linears(model):
            for linear in linears:
                n_out, n_in = linear.weight.shape
                linear.weight.copy_(flat[off : off + n_in * n_out].view(n_in, n_out).t())
                off += n_in * n_out
                linear.bias.copy_(flat[off : off + n_out])
                off += n_out
    if off != flat.numel():
        raise ValueError(f"The flat vector has {flat.numel()} values; the model takes {off}.")


def flatten_chains(chains: Sequence[Chain]) -> torch.Tensor:
    """All parameters in kernel order (per chain: each layer's ``W [in,
    out]``, ``b`` and, with a LayerNorm, its scale and bias; then each
    head's ``W`` and ``b``) as one contiguous f32 vector: ``rl8_tpu``'s
    ``_flatten_params`` order."""
    parts = [p.reshape(-1) for layers, heads in chains for tensors in (*layers, *heads) for p in tensors]
    return torch.cat(parts).to(torch.float32).contiguous()


def chain_structure(chains: Sequence[Chain]) -> Structure:
    """The :data:`Structure` of ``chains`` (``rl8_tpu``'s ``_chain_sizes``
    with the widths)."""
    d_in = chains[0][0][0][0].shape[0] if chains[0][0] else chains[0][1][0][0].shape[0]
    return int(d_in), tuple(
        (
            tuple((int(layer[0].shape[1]), len(layer) == 4) for layer in layers),
            tuple(int(w.shape[1]) for w, _ in heads),
        )
        for layers, heads in chains
    )


def _param_shapes(structure: Structure) -> list[tuple[int, ...]]:
    """Shapes of the parameters in :func:`flatten_chains` order."""
    d_in, shapes = structure
    out: list[tuple[int, ...]] = []
    for layers, heads in shapes:
        k = d_in
        for width, has_ln in layers:
            out += [(k, width), (width,)] + ([(width,), (width,)] if has_ln else [])
            k = width
        for width in heads:
            out += [(k, width), (width,)]
    return out


def unflatten_chains(flat: torch.Tensor, structure: Structure) -> tuple[Chain, ...]:
    """The chains as views of ``flat`` (the inverse of
    :func:`flatten_chains`)."""
    shapes = _param_shapes(structure)
    sizes = [torch.Size(shape).numel() for shape in shapes]
    if sum(sizes) != flat.numel():
        raise ValueError(f"The flat vector has {flat.numel()} values; the chains take {sum(sizes)}.")
    tensors = [t.view(shape) for t, shape in zip(flat.split(sizes), shapes)]
    it = iter(tensors)
    return tuple(
        (
            tuple(tuple(next(it) for _ in range(4 if has_ln else 2)) for _, has_ln in layers),
            tuple((next(it), next(it)) for _ in heads),
        )
        for layers, heads in structure[1]
    )


def _forward_block(
    x: torch.Tensor, chains: Sequence[Chain], activation: str
) -> tuple[list[list[torch.Tensor]], list[list[torch.Tensor]], list[list[Any]]]:
    """Plain forward of every chain: each chain's head outputs, its
    activation stack ``[x, h_1, ..., h_L]`` and its LayerNorm aux ``(xhat,
    s)`` per layer (``None`` without one), as ``_forward_block`` in
    ``rl8_tpu`` returns them."""
    act = ACT_FNS[activation]
    outs, all_hs, all_aux = [], [], []
    for layers, heads in chains:
        hs, aux = [x], []
        for layer in layers:
            z = hs[-1] @ layer[0] + layer[1]
            if len(layer) == 4:
                xhat, s = layer_norm_stats(z)
                aux.append((xhat, s))
                z = xhat * layer[2] + layer[3]
            else:
                aux.append(None)
            hs.append(act(z))
        outs.append([hs[-1] @ w + b for w, b in heads])
        all_hs.append(hs)
        all_aux.append(aux)
    return outs, all_hs, all_aux


def forward_chains(
    x: torch.Tensor, chains: Sequence[Chain], activation: str
) -> tuple[list[list[torch.Tensor]], list[list[torch.Tensor]]]:
    """Plain forward of every chain on the shared input ``x [N, d]``.

    Returns ``(outs, hs)``: each chain's head outputs, and each chain's
    activation stack ``[x, h_1, ..., h_L]`` that
    :func:`chains_backward_plain` reads."""
    outs, hs, _ = _forward_block(x, chains, activation)
    return outs, hs


def _backward(
    chains: Sequence[Chain],
    activation: str,
    hs: Sequence[Sequence[torch.Tensor]],
    aux: None | Sequence[Sequence[Any]],
    douts: Sequence[Sequence[torch.Tensor]],
    need_dx: bool,
) -> tuple[tuple[Chain, ...], None | torch.Tensor]:
    """``rl8_tpu``'s ``_chains_backward`` in plain PyTorch: the parameter
    gradients with the structure of ``chains``, and (``need_dx``) the
    input's cotangent summed over chains."""
    act_grad = _ACT_GRAD_FROM_OUT[activation]
    grads = []
    dx = None
    for c, ((layers, heads), h, chain_douts) in enumerate(zip(chains, hs, douts)):
        dheads = []
        dh = None
        for (w, _), dout in zip(heads, chain_douts):
            dheads.append((h[-1].t() @ dout, dout.sum(dim=0)))
            contrib = dout @ w.t()
            dh = contrib if dh is None else dh + contrib
        dlayers: list[Layer] = []
        for layer in range(len(layers) - 1, -1, -1):
            params = layers[layer]
            da = dh * act_grad(h[layer + 1])
            if len(params) == 4:
                if aux is None:
                    raise ValueError("A LayerNorm layer's backward needs the forward's (xhat, s).")
                xhat, s = aux[c][layer]
                dxhat = da * params[2]
                m1 = dxhat.mean(dim=1, keepdim=True)
                m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
                dpre = s * (dxhat - m1 - xhat * m2)
                norm_grads: tuple[torch.Tensor, ...] = ((da * xhat).sum(dim=0), da.sum(dim=0))
            else:
                dpre = da
                norm_grads = ()
            dlayers.insert(0, (h[layer].t() @ dpre, dpre.sum(dim=0), *norm_grads))
            if layer > 0 or need_dx:
                dh = dpre @ params[0].t()
        if need_dx:
            dx = dh if dx is None else dx + dh
        grads.append((tuple(dlayers), tuple(dheads)))
    return tuple(grads), dx


def chains_backward_plain(
    chains: Sequence[Chain],
    activation: str,
    hs: Sequence[Sequence[torch.Tensor]],
    douts: Sequence[Sequence[torch.Tensor]],
) -> tuple[Chain, ...]:
    """Plain backward of chains without LayerNorm from their heads'
    cotangents (what the PPO update kernels compute).

    ``hs`` are the activation stacks from :func:`forward_chains` and
    ``douts[c][j]`` the cotangent of chain ``c``'s head ``j``
    ``[N, d_out]``. Returns the parameter gradients with the structure of
    ``chains`` (so :func:`flatten_chains` lays them out as the kernels
    do): ``dW = h_in^T @ dpre`` and ``db = sum(dpre)`` over rows, where
    ``dpre = dh * act'(h_out)`` is taken from each layer's output. The
    input's cotangent is not formed."""
    return _backward(chains, activation, hs, None, douts, need_dx=False)[0]


def chains_vjp_plain(
    x: torch.Tensor,
    chains: Sequence[Chain],
    activation: str,
    douts: Sequence[Sequence[torch.Tensor]],
) -> tuple[torch.Tensor, tuple[Chain, ...]]:
    """Plain version of the backward chain kernel: recompute the forward
    from ``x``, then ``(dx, dchains)`` from the heads' cotangents
    ``douts[c][j]``, LayerNorm included (``rl8_tpu``'s ``_bwd_kernel``)."""
    _, hs, aux = _forward_block(x, chains, activation)
    grads, dx = _backward(chains, activation, hs, aux, douts, need_dx=True)
    assert dx is not None
    return dx, grads


# ----------------------------------------------------------------------
# The kernels' wrappers
# ----------------------------------------------------------------------


def _spec(structure: Structure) -> Any:
    """``csrc/chains.cu``'s host int array: the chain count, then per
    chain its layer count, ``(width, ln)`` per layer, head count and head
    widths."""
    ints = [len(structure[1])]
    for layers, heads in structure[1]:
        ints.append(len(layers))
        for width, has_ln in layers:
            ints += [width, int(has_ln)]
        ints.append(len(heads))
        ints += list(heads)
    return (ctypes.c_int * len(ints))(*ints), len(ints)


def card_takes_chains(chains: Sequence[Chain]) -> bool:
    """Whether ``csrc/chains.cu`` takes these chains: any number of
    chains, layers and heads, of any width (chains too large for the tiled
    routes, or deeper than 8 layers or with more than 4 heads, take the
    staged ones, whose activations live in a device scratch; the staged
    backward runs over chunks of rows within a 4 GiB budget, so chains whose
    weight copies and partials leave no room for one row block are
    refused). This builds the kernels, if they are not built yet, and asks
    them (the counterpart of ``rl8_tpu``'s ``chains_fit_vmem``)."""
    structure = chain_structure(chains)
    spec, n = _spec(structure)
    return load().rl8_chains_workspace(1, structure[0], spec, n, 1) >= 0


#: ``csrc/chains.cu``'s constants that decide the routes and the staged
#: backward's chunk (:func:`staged_saves` mirrors them): the tiled routes'
#: tables, rows a tile (backward, forward) and shared memory a block (with
#: a ``TileChain`` of 984 bytes, a ``FwdChain`` of 880); the staged
#: route's rows a block, stage depth and passes (``stage.cuh``), its
#: narrow-product width, its weight products' groups and partials, and its
#: workspace budget (4 GiB).
_TILE_DEPTH, _TILE_HEADS, _TILE_ROWS, _TILE_SMEM, _TILE_CHAIN_BYTES = 8, 4, 32, 232448, 984
_FWD_TILE_ROWS, _FWD_PASS, _FWD_CHAIN_BYTES = 64, 128, 880
_ST_ROWS, _ST_K, _ST_PASS, _ST_FWD_PASS, _NARROW = 128, 32, 128, 256, 8
_GROUP_ROWS, _MAX_CHAIN_GROUPS, _PARTIAL_FLOATS, _WORKSPACE_FLOATS = 128, 256, 64 << 20, 1 << 30


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _tiled_backward_fits(structure: Structure) -> bool:
    """``chains.cu``'s ``make_tiled``: whether every chain fits the tiled
    backward's tables and its parameters, gradients and 32-row tile fit
    one block's shared memory."""
    d_in, shapes = structure

    def act_ld(w: int) -> int:
        return _round_up(w, 32) + 4

    def weight_ld(w: int) -> int:
        ld = _round_up(w, 8)
        return ld + 8 if ld % 16 == 0 else ld

    for layers, heads in shapes:
        if len(layers) > _TILE_DEPTH or len(heads) > _TILE_HEADS:
            return False
        off, k = 0, d_in
        for width, has_ln in layers:
            off += k * weight_ld(width) + (3 * width if has_ln else width)
            k = width
        off = _round_up(off + k * weight_ld(sum(heads)) + sum(heads), 4)
        rows = act_ld(d_in) + sum(act_ld(w) * (2 if ln else 1) for w, ln in layers) + act_ld(sum(heads))
        floats = 2 * off + _TILE_ROWS * rows + len(layers) * _TILE_ROWS
        if 4 * floats + _TILE_CHAIN_BYTES > _TILE_SMEM:
            return False
    return True


def _tiled_forward_fits(structure: Structure) -> bool:
    """``chains.cu``'s ``make_fwd_tiled``: whether every chain fits the
    tiled forward's tables and its parameters, with two 64-row tiles of
    ``x`` and the activation buffers, fit one block's shared memory."""
    d_in, shapes = structure
    if any(len(layers) > _TILE_DEPTH or len(heads) > _TILE_HEADS for layers, heads in shapes):
        return False

    def tile_ld(w: int) -> int:
        ld = _round_up(w, 4)
        return ld + 4 if ld % 8 == 0 else ld

    widest = max(width for layers, _ in shapes for width, _ in layers)
    lda = tile_ld(max(widest, d_in))
    sa = 2 * _FWD_TILE_ROWS * tile_ld(d_in)
    base = (sa if widest <= _FWD_PASS else sa + _FWD_TILE_ROWS * lda) + _FWD_TILE_ROWS * lda
    for layers, heads in shapes:
        off, k = base, d_in
        for width, has_ln in layers:
            off = _round_up(off + k * _round_up(width, 4), 4)
            off = _round_up(off + (3 * width if has_ln else width), 4)
            k = width
        for hw in heads:
            off = _round_up(off + k * _round_up(hw, 4), 4)
            off = _round_up(off + hw, 4)
        if 4 * off + _FWD_CHAIN_BYTES > _TILE_SMEM:
            return False
    return True


def staged_saves(structure: Structure, N: int) -> bool:
    """Whether the forward keeps its activations for the chain backward on
    the card (``csrc/chains.cu``'s ``rl8_chains_workspace(..., 2)`` is
    positive): both take their staged routes and the backward's chunk is
    every row (:func:`staged_chunk_rows` answers ``N``). A pure-Python
    mirror, for the tests."""
    return not _tiled_forward_fits(structure) and staged_chunk_rows(structure, N) == N


def staged_chunk_rows(structure: Structure, N: int) -> int:
    """A pure-Python mirror of ``csrc/chains.cu``'s
    ``rl8_chains_chunk_rows``: the rows of a chunk of the chain backward's
    staged route on ``N`` rows (``N`` where its weight copies, partials
    and every row's activations fit its 4 GiB budget at once), 0 where the
    backward takes its tiled route, -1 where the copies and partials leave
    no room for one 128-row block."""
    if _tiled_backward_fits(structure):
        return 0
    d_in, shapes = structure
    n_params = sum(torch.Size(shape).numel() for shape in _param_shapes(structure))
    copies, per_row, slabs = 0, _round_up(d_in, 4) + len(shapes) * d_in, 0
    for layers, heads in shapes:
        k = d_in
        for i, (width, has_ln) in enumerate(layers):
            copies += _round_up(k, _ST_K) * _round_up(width, _ST_FWD_PASS)
            if i > 0 or k >= _NARROW:
                copies += 2 * _round_up(width, _ST_K) * _round_up(k, _ST_PASS)
            ld = _round_up(width, 4)
            per_row += 2 * ld + (2 * ld + 1 if has_ln else 0)
            slabs += 5 if has_ln else 2
            k = width
        n_out = sum(heads)
        copies += _round_up(k * n_out, 4) + 2 * _round_up(n_out, _ST_K) * _round_up(k, _ST_PASS)
        per_row += _round_up(n_out, 4)
    groups = max(min(-(-N // _GROUP_ROWS), _MAX_CHAIN_GROUPS, _PARTIAL_FLOATS // n_params), 1)
    fixed = copies + groups * n_params + 4 * (slabs + 2 * len(shapes) + 2)
    if fixed >= _WORKSPACE_FLOATS:
        return -1
    fit = (_WORKSPACE_FLOATS - fixed) // per_row // _ST_ROWS * _ST_ROWS
    if fit >= N:
        return N
    if fit < _ST_ROWS:
        return -1
    chunks = -(-N // fit)
    return _round_up(-(-N // chunks), _ST_ROWS)


def _chain_mem(structure: Structure) -> tuple[int, int]:
    """``rl8_tpu``'s VMEM footprint model of its chain backward (the
    bigger of its two chain kernels), over a :data:`Structure`:
    ``(fixed_bytes, row_f32s)``. ``fixed_bytes`` counts the parameters,
    their gradient accumulators and the transposed head weights;
    ``row_f32s`` the per-row f32s of a row tile: the input and its
    cotangent, each chain's activations, the LayerNorms' ``(xhat, s)``,
    the head cotangents and three ``dh``-sized transients."""
    d_in, shapes = structure
    fixed = row = 0
    for layers, heads in shapes:
        k = d_in
        for width, has_ln in layers:
            fixed += (k * width + width + (2 * width if has_ln else 0)) * 8  # param + dparam
            k = width
        for n_out in heads:
            fixed += (k * n_out + n_out) * 8 + k * n_out * 4  # + W^T
            row += n_out
        widths = [width for width, _ in layers]
        row += d_in + sum(widths)
        row += sum(width + 1 for width, has_ln in layers if has_ln)
        row += 3 * max(widths, default=d_in)
    row += 2 * (d_in or 1)
    return fixed, row


def chains_fit_vmem(chains: Sequence[Chain]) -> bool:
    """``rl8_tpu``'s ``chains_fit_vmem``: whether the resident set of
    ``chains`` leaves room for an 8-row tile in :data:`_VMEM_TOTAL_BUDGET`
    (twin torsos up to 2388 wide at the dummy envs' shapes)."""
    fixed, row = _chain_mem(chain_structure(chains))
    return fixed + 4 * row * 8 <= _VMEM_TOTAL_BUDGET


def model_fits_vmem(model: Any) -> bool:
    """``rl8_tpu``'s ``model_fits_vmem``: :func:`chains_fit_vmem` of the
    model's chains (a default model's, or a custom model's declared by its
    :class:`FusedApplySpec` or :class:`FusedRecurrentApplySpec`; ``False``
    for a custom model with neither). The algorithms AND it into their
    kernel routes at build, after :func:`supports_fused_apply` (a model
    it refuses may have no chains), as ``rl8_tpu`` does."""
    from ..models import DefaultContinuousModel, DefaultDiscreteModel

    if type(model) in (DefaultDiscreteModel, DefaultContinuousModel):
        names = chain_names(model)
    else:
        spec = _custom_spec(model) or _custom_spec(model, FusedRecurrentApplySpec)
        if spec is None:
            return False
        names = spec.chain_names
    return chains_fit_vmem(named_chains(model, names))


def _check(x: torch.Tensor, flat: torch.Tensor, structure: Structure, activation: str) -> None:
    if activation not in ACT_FNS:
        raise ValueError(f"The chain kernels support activations {tuple(ACT_FNS)}, not {activation!r}.")
    if x.dim() != 2 or x.shape[1] != structure[0] or x.dtype != torch.float32:
        raise ValueError(f"x must be f32 [N, {structure[0]}], got {x.dtype} {tuple(x.shape)}.")
    if flat.dim() != 1 or flat.dtype != torch.float32 or flat.device != x.device:
        raise ValueError("The flat parameters must be an f32 vector on x's device.")


def _launch_args(x: torch.Tensor, flat: torch.Tensor, structure: Structure) -> tuple[Any, ...]:
    if x.device.type != "cuda":
        raise ValueError(f"No chain kernel for device {x.device}.")
    if not (x.is_contiguous() and flat.is_contiguous()):
        raise ValueError("The chain kernels need a contiguous x and flat parameters.")
    n_params = sum(torch.Size(s).numel() for s in _param_shapes(structure))
    if flat.numel() != n_params:
        raise ValueError(f"The flat vector has {flat.numel()} values; the chains take {n_params}.")
    spec, n = _spec(structure)
    if load().rl8_chains_workspace(x.shape[0], structure[0], spec, n, 1) < 0:
        raise NotImplementedError(
            "The card's chain kernels do not take these chains: their weight copies and partials"
            " leave no room for one row block in the staged backward's workspace budget."
        )
    return spec, n


def fused_chains_fwd(
    x: torch.Tensor, flat: torch.Tensor, structure: Structure, activation: str, save: bool = False
) -> Any:
    """Every head's output ``[N, hw]``, chain by chain, of the chains of
    ``structure`` with parameters ``flat`` (:func:`flatten_chains` order)
    on ``x [N, d_in]``.

    CUDA tensors launch ``csrc/chains.cu``'s forward (persistent blocks
    that each hold one chain's parameters in shared memory and walk 64-row
    tiles through register-tiled f32 products, or, for chains too large for
    that, the staged route: one launch a layer depth over 128-row blocks,
    the activations in a workspace this allocates; the route is picked by
    the chains' shapes; counting one launch in
    ``fused_chains_fwd.launches``) or raise; CPU tensors run
    :func:`forward_chains`.

    ``save``: returns ``(outs, saved)``, where ``saved`` is what
    :func:`fused_chains_bwd` reads instead of recomputing the forward: on
    the card, where both take their staged routes and the backward holds
    every row at once, the staged forward's workspace in the backward's
    layout (every ``h_l``, each LayerNorm's ``xhat_l`` and ``s_l``, and
    the backward's weight copies), else ``None``; on the CPU the
    activation stacks and LayerNorm aux. The outputs are the same bits as
    without ``save``."""
    _check(x, flat, structure, activation)
    if x.device.type == "cpu":
        outs, hs, aux = _forward_block(x, unflatten_chains(flat, structure), activation)
        flat_outs = [o for chain in outs for o in chain]
        return (flat_outs, (hs, aux)) if save else flat_outs
    spec, n = _launch_args(x, flat, structure)
    lib = load()
    N = x.shape[0]
    dev = x.device
    outs = [torch.empty((N, w), dtype=torch.float32, device=dev) for _, heads in structure[1] for w in heads]
    ptrs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    floats = lib.rl8_chains_workspace(N, structure[0], spec, n, 2) if save else 0
    saving = floats > 0
    if not saving:
        floats = lib.rl8_chains_workspace(N, structure[0], spec, n, 0)
    work = torch.empty(floats, dtype=torch.float32, device=dev) if floats > 0 else None
    code = lib.rl8_chains_fwd(
        x.data_ptr(), flat.data_ptr(), ptrs, None if work is None else work.data_ptr(), N, structure[0], spec, n,
        list(ACT_FNS).index(activation), int(saving), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    check(code, "The chain forward kernel", outs)
    fused_chains_fwd.launches += 1
    return (outs, work if saving else None) if save else outs


def fused_chains_bwd(
    x: torch.Tensor,
    flat: torch.Tensor,
    structure: Structure,
    activation: str,
    douts: Sequence[torch.Tensor],
    saved: Any = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx [N, d_in], dflat)``: the cotangents of the input and of the
    flat parameters from every head's output cotangent ``douts`` (chain
    by chain, as :func:`fused_chains_fwd` returns the outputs).

    CUDA tensors launch ``csrc/chains.cu``'s backward (persistent blocks
    that each hold one chain's parameters and gradients in shared memory
    and recompute the forward tile by tile, or, for chains too large for
    that, the staged route: a row pass through a device scratch, its dh
    products in 3xTF32 ``wgmma``, and split-K weight products whose
    partials a fixed budget bounds; then fixed-order sums, bit-identical
    from launch to launch;
    counting one launch in ``fused_chains_bwd.launches``) or raise; CPU
    tensors run :func:`chains_vjp_plain`. ``saved``: what a saving
    :func:`fused_chains_fwd` on the same ``x`` and ``flat`` returned; the
    staged row pass then reads its activations and weight copies instead
    of recomputing them, with the same kernels and sums (the same bits),
    and overwrites them (one backward a saving forward); on the CPU
    :func:`chains_vjp_plain`'s backward on the saved stacks."""
    _check(x, flat, structure, activation)
    widths = [w for _, heads in structure[1] for w in heads]
    if len(douts) != len(widths) or any(
        tuple(d.shape) != (x.shape[0], w) or d.dtype != torch.float32 or d.device != x.device
        for d, w in zip(douts, widths)
    ):
        raise ValueError(f"douts must be one f32 [N, width] tensor per head, widths {widths}.")
    if x.device.type == "cpu":
        grouped, i = [], 0
        for _, heads in structure[1]:
            grouped.append(list(douts[i : i + len(heads)]))
            i += len(heads)
        chains = unflatten_chains(flat, structure)
        if saved is None:
            dx, dchains = chains_vjp_plain(x, chains, activation, grouped)
        else:
            dchains, dx = _backward(chains, activation, saved[0], saved[1], grouped, need_dx=True)
        return dx, flatten_chains(dchains)
    spec, n = _launch_args(x, flat, structure)
    lib = load()
    N = x.shape[0]
    douts = [d.contiguous() for d in douts]
    dev = x.device
    if saved is None:
        work = torch.empty(lib.rl8_chains_workspace(N, structure[0], spec, n, 1), dtype=torch.float32, device=dev)
    else:
        floats = lib.rl8_chains_workspace(N, structure[0], spec, n, 2)
        if floats <= 0 or saved.numel() != floats or saved.device != dev:
            raise ValueError("saved is not the workspace of a saving chain forward on these chains and rows.")
        work = saved
    dx = torch.empty_like(x)
    dflat = torch.empty_like(flat)
    ptrs = (ctypes.c_void_p * len(douts))(*(d.data_ptr() for d in douts))
    code = lib.rl8_chains_bwd(
        x.data_ptr(), flat.data_ptr(), ptrs, dx.data_ptr(), dflat.data_ptr(), work.data_ptr(), N, structure[0],
        spec, n, list(ACT_FNS).index(activation), int(saved is not None), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(code, "The chain backward kernel", dx, dflat)
    fused_chains_bwd.launches += 1
    return dx, dflat


#: Kernel launches so far (CUDA tensors only; the CPU path counts none).
fused_chains_fwd.launches = 0
fused_chains_bwd.launches = 0


class _FusedChains(torch.autograd.Function):
    """:func:`fused_chains` as an autograd op: it saves ``x``, the packed
    parameters and, where ``save`` (autograd will run its backward), what
    :func:`fused_chains_fwd` keeps for the backward; its backward reads
    that, once, or recomputes the activations where nothing was kept
    (or a second backward runs after the first consumed it)."""

    @staticmethod
    def forward(
        ctx: Any, activation: str, structure: Structure, save: bool, x: torch.Tensor, *params: torch.Tensor
    ) -> Any:
        flat = torch.cat([p.reshape(-1) for p in params]).to(torch.float32)
        ctx.activation, ctx.structure = activation, structure
        ctx.shapes = [p.shape for p in params]
        ctx.save_for_backward(x, flat)
        if not (save and any(ctx.needs_input_grad)):
            ctx.kept = None
            return tuple(fused_chains_fwd(x, flat, structure, activation))
        outs, ctx.kept = fused_chains_fwd(x, flat, structure, activation, save=True)
        return tuple(outs)

    @staticmethod
    def backward(ctx: Any, *douts: torch.Tensor) -> Any:
        x, flat = ctx.saved_tensors
        kept, ctx.kept = ctx.kept, None
        dx, dflat = fused_chains_bwd(x, flat, ctx.structure, ctx.activation, douts, saved=kept)
        grads, off = [], 0
        for shape in ctx.shapes:
            n = shape.numel()
            grads.append(dflat[off : off + n].view(shape))
            off += n
        return (None, None, None, dx, *grads)


def fused_chains(activation: str, x: torch.Tensor, chains: Sequence[Chain]) -> tuple[tuple[torch.Tensor, ...], ...]:
    """Evaluate several activation-MLP chains with linear heads on the
    shared input ``x [N, d]``: per chain, the tuple of its head outputs,
    f32 ``[N, d_out]`` (``rl8_tpu``'s ``fused_chains``).

    Differentiable in ``x`` and every parameter: the backward is the
    chain backward kernel (or its plain version on the CPU), which returns
    ``dx`` and the gradients in the layout of the parameters given
    (``[in, out]`` views of ``nn.Linear`` weights carry their gradients
    back to the weights). Where grad mode is on and an input requires a
    gradient, the forward keeps the activations for the backward where
    the route allows (:func:`fused_chains_fwd`'s ``save``); under
    ``torch.no_grad`` it keeps nothing."""
    structure = chain_structure(chains)
    params = [p for layers, heads in chains for tensors in (*layers, *heads) for p in tensors]
    save = torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params))
    flat_outs = _FusedChains.apply(activation, structure, save, x.to(torch.float32).contiguous(), *params)
    grouped, i = [], 0
    for _, heads in structure[1]:
        grouped.append(tuple(flat_outs[i : i + len(heads)]))
        i += len(heads)
    return tuple(grouped)


# ----------------------------------------------------------------------
# Model adapters
# ----------------------------------------------------------------------


def _custom_spec(model: Any, cls: type = FusedApplySpec) -> Any:
    """The model's spec of class ``cls`` (:class:`FusedApplySpec` or
    :class:`FusedRecurrentApplySpec`) when it declares one and the kernels
    can honor it, else ``None``: a kernel activation, and a compute dtype
    of ``None`` or ``torch.bfloat16`` (``rl8_tpu``'s gate). A bf16 (AMP)
    model's chains run in the kernels' f32, which only tightens its
    numerics, as ``rl8_tpu``'s bf16-operand, f32-accumulating kernels do;
    any other dtype keeps the module forward."""
    get_spec = getattr(model, "fused_apply_spec", None)
    if get_spec is None:
        return None
    spec = get_spec()
    if not isinstance(spec, cls):
        return None
    if getattr(model, "dtype", None) not in (None, torch.bfloat16):
        return None
    if getattr(model, "activation_fn", None) not in ACT_FNS:
        return None
    return spec


def supports_fused_apply(model: Any) -> bool:
    """Whether the chain kernels can evaluate ``model``'s forward: a
    default model (relu or tanh, biased layers, float observations, no
    compute dtype: an AMP default model keeps its bf16 module forward), or
    a custom model declaring a :class:`FusedApplySpec`, f32 or bf16
    (``rl8_tpu``'s gating)."""
    from ..models import DefaultContinuousModel, DefaultDiscreteModel

    if type(model) not in (DefaultContinuousModel, DefaultDiscreteModel):
        return _custom_spec(model) is not None
    if getattr(model, "dtype", None) is not None:
        return False
    if not model.observation_spec.dtype.is_floating_point:
        return False
    return bool(model.bias) and model.activation_fn in ACT_FNS


def fused_custom_apply(model: Any, batch: Any) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """``model(batch)`` for a model declaring a :class:`FusedApplySpec`:
    ``assemble`` and ``finalize`` in plain PyTorch, the chains through
    :func:`fused_chains`. Differentiable end to end. A bf16 model's
    assembled input is upcast to f32 for the kernels, which return f32
    heads; its cotangent returns to the input's dtype through the cast."""
    spec = _custom_spec(model)
    if spec is None:
        raise TypeError(f"{type(model).__name__} has no fused apply spec the chain kernels take.")
    x = spec.assemble(batch)
    outs = fused_chains(model.activation_fn, x, named_chains(model, spec.chain_names))
    return spec.finalize(batch, outs)


def supports_fused_recurrent_apply(model: Any) -> bool:
    """Whether ``model`` declares a :class:`FusedRecurrentApplySpec` the
    chain kernels can honor (:func:`_custom_spec`'s dtype and activation
    rules)."""
    return _custom_spec(model, FusedRecurrentApplySpec) is not None


def fused_recurrent_custom_apply(
    model: Any, batch: Any, states: Any
) -> tuple[tuple[dict[str, torch.Tensor], torch.Tensor], Any]:
    """``model(batch, states)`` for a recurrent model declaring a
    :class:`FusedRecurrentApplySpec`: ``assemble`` (the recurrent front
    half) and ``finalize`` in plain PyTorch, the chains through
    :func:`fused_chains`. Differentiable end to end, through time too."""
    spec = _custom_spec(model, FusedRecurrentApplySpec)
    if spec is None:
        raise TypeError(f"{type(model).__name__} has no fused recurrent apply spec the chain kernels take.")
    x, new_states = spec.assemble(batch, states)
    outs = fused_chains(model.activation_fn, x, named_chains(model, spec.chain_names))
    return spec.finalize(batch, outs), new_states


def fused_default_apply(model: Any, batch: Any) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """``model(batch)`` for the default models, through
    :func:`fused_chains`."""
    from ..models import DefaultContinuousModel, DefaultDiscreteModel

    obs = batch[DataKeys.OBS]
    chains = named_chains(model, chain_names(model))
    if type(model) is DefaultDiscreteModel:
        (logits,), (values,) = fused_chains(model.activation_fn, obs, chains)
        A, n = model.action_spec.shape[0], model.action_spec.n
        return {"logits": logits.reshape(-1, A, n)}, values
    if type(model) is not DefaultContinuousModel:
        raise TypeError(f"{type(model).__name__} is not a default model.")
    (mean, log_std), (values,) = fused_chains(model.activation_fn, obs, chains)
    return {"mean": mean, "log_std": torch.tanh(log_std)}, values
