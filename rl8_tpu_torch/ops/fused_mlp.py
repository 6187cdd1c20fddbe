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
  differentiable op over them, a ``torch.autograd.Function`` whose
  backward recomputes the activations from ``x``, as the TPU's custom
  VJP does.
- :class:`FusedApplySpec`, :func:`supports_fused_apply`,
  :func:`fused_custom_apply` and :func:`fused_default_apply` run a
  model's forward through :func:`fused_chains`.
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
    "card_takes_chains",
    "chain_names",
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
    "load_flat_params",
    "named_chains",
    "supports_fused_apply",
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
    """Whether ``csrc/chains.cu`` takes these chains: at most 4 chains of
    1 to 8 layers and 1 to 4 heads, whose row passes fit a block's shared
    memory (layers up to ~800 wide). The limit is the kernels' own; this
    builds them, if they are not built yet, and asks them (the
    counterpart of ``rl8_tpu``'s ``chains_fit_vmem``)."""
    structure = chain_structure(chains)
    spec, n = _spec(structure)
    return load().rl8_chains_workspace(1, structure[0], spec, n, 1) >= 0


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
            "The card's chain kernels do not take these chains (at most 4 chains of 1 to 8"
            " layers and 1 to 4 heads, whose row passes must fit a block's shared memory)."
        )
    return spec, n


def fused_chains_fwd(x: torch.Tensor, flat: torch.Tensor, structure: Structure, activation: str) -> list[torch.Tensor]:
    """Every head's output ``[N, hw]``, chain by chain, of the chains of
    ``structure`` with parameters ``flat`` (:func:`flatten_chains` order)
    on ``x [N, d_in]``.

    CUDA tensors launch ``csrc/chains.cu``'s forward (persistent blocks
    that each hold one chain's parameters in shared memory and walk 32-row
    tiles through register-tiled f32 products, or, for chains too large for
    that, 16-row blocks with the weights streaming from L2; the route is
    picked by the chains' shapes; counting one launch in
    ``fused_chains_fwd.launches``) or raise; CPU tensors run
    :func:`forward_chains`."""
    _check(x, flat, structure, activation)
    if x.device.type == "cpu":
        outs, _ = forward_chains(x, unflatten_chains(flat, structure), activation)
        return [o for chain in outs for o in chain]
    spec, n = _launch_args(x, flat, structure)
    N = x.shape[0]
    outs = [torch.empty((N, w), dtype=torch.float32, device=x.device) for _, heads in structure[1] for w in heads]
    ptrs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    dev = x.device
    code = load().rl8_chains_fwd(
        x.data_ptr(), flat.data_ptr(), ptrs, N, structure[0], spec, n, list(ACT_FNS).index(activation),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    check(code, "The chain forward kernel")
    fused_chains_fwd.launches += 1
    return outs


def fused_chains_bwd(
    x: torch.Tensor,
    flat: torch.Tensor,
    structure: Structure,
    activation: str,
    douts: Sequence[torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx [N, d_in], dflat)``: the cotangents of the input and of the
    flat parameters from every head's output cotangent ``douts`` (chain
    by chain, as :func:`fused_chains_fwd` returns the outputs).

    CUDA tensors launch ``csrc/chains.cu``'s backward (persistent blocks
    that each hold one chain's parameters and gradients in shared memory
    and recompute the forward tile by tile, or, for chains too large for
    that, a row pass through a device scratch and split-K weight
    products; then fixed-order sums, bit-identical from launch to launch;
    counting one launch in ``fused_chains_bwd.launches``) or raise; CPU
    tensors run :func:`chains_vjp_plain`."""
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
        dx, dchains = chains_vjp_plain(x, unflatten_chains(flat, structure), activation, grouped)
        return dx, flatten_chains(dchains)
    spec, n = _launch_args(x, flat, structure)
    lib = load()
    N = x.shape[0]
    douts = [d.contiguous() for d in douts]
    dev = x.device
    work = torch.empty(lib.rl8_chains_workspace(N, structure[0], spec, n, 1), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dflat = torch.empty_like(flat)
    ptrs = (ctypes.c_void_p * len(douts))(*(d.data_ptr() for d in douts))
    code = lib.rl8_chains_bwd(
        x.data_ptr(), flat.data_ptr(), ptrs, dx.data_ptr(), dflat.data_ptr(), work.data_ptr(), N, structure[0],
        spec, n, list(ACT_FNS).index(activation), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    check(code, "The chain backward kernel")
    fused_chains_bwd.launches += 1
    return dx, dflat


#: Kernel launches so far (CUDA tensors only; the CPU path counts none).
fused_chains_fwd.launches = 0
fused_chains_bwd.launches = 0


class _FusedChains(torch.autograd.Function):
    """:func:`fused_chains` as an autograd op: it saves only ``x`` and the
    packed parameters, and its backward recomputes the activations."""

    @staticmethod
    def forward(ctx: Any, activation: str, structure: Structure, x: torch.Tensor, *params: torch.Tensor) -> Any:
        flat = torch.cat([p.reshape(-1) for p in params]).to(torch.float32)
        ctx.activation, ctx.structure = activation, structure
        ctx.shapes = [p.shape for p in params]
        ctx.save_for_backward(x, flat)
        return tuple(fused_chains_fwd(x, flat, structure, activation))

    @staticmethod
    def backward(ctx: Any, *douts: torch.Tensor) -> Any:
        x, flat = ctx.saved_tensors
        dx, dflat = fused_chains_bwd(x, flat, ctx.structure, ctx.activation, douts)
        grads, off = [], 0
        for shape in ctx.shapes:
            n = shape.numel()
            grads.append(dflat[off : off + n].view(shape))
            off += n
        return (None, None, dx, *grads)


def fused_chains(activation: str, x: torch.Tensor, chains: Sequence[Chain]) -> tuple[tuple[torch.Tensor, ...], ...]:
    """Evaluate several activation-MLP chains with linear heads on the
    shared input ``x [N, d]``: per chain, the tuple of its head outputs,
    f32 ``[N, d_out]`` (``rl8_tpu``'s ``fused_chains``).

    Differentiable in ``x`` and every parameter: the backward is the
    recompute-based chain kernel (or its plain version on the CPU),
    which returns ``dx`` and the gradients in the layout of the
    parameters given (``[in, out]`` views of ``nn.Linear`` weights carry
    their gradients back to the weights)."""
    structure = chain_structure(chains)
    params = [p for layers, heads in chains for tensors in (*layers, *heads) for p in tensors]
    flat_outs = _FusedChains.apply(activation, structure, x.to(torch.float32).contiguous(), *params)
    grouped, i = [], 0
    for _, heads in structure[1]:
        grouped.append(tuple(flat_outs[i : i + len(heads)]))
        i += len(heads)
    return tuple(grouped)


# ----------------------------------------------------------------------
# Model adapters
# ----------------------------------------------------------------------


def _custom_spec(model: Any) -> None | FusedApplySpec:
    """The model's :class:`FusedApplySpec` when it declares one and the
    kernels can honor it, else ``None``: f32 only (the port has no bf16
    compute yet, where ``rl8_tpu`` also takes ``dtype=bfloat16``), and a
    kernel activation."""
    get_spec = getattr(model, "fused_apply_spec", None)
    if get_spec is None:
        return None
    spec = get_spec()
    if not isinstance(spec, FusedApplySpec):
        return None
    if getattr(model, "dtype", None) is not None:
        return None
    if getattr(model, "activation_fn", None) not in ACT_FNS:
        return None
    return spec


def supports_fused_apply(model: Any) -> bool:
    """Whether the chain kernels can evaluate ``model``'s forward: a
    default model (relu or tanh, biased layers, float observations, no
    compute dtype), or a custom model declaring a
    :class:`FusedApplySpec` (``rl8_tpu``'s gating, without bf16)."""
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
    :func:`fused_chains`. Differentiable end to end."""
    spec = _custom_spec(model)
    if spec is None:
        raise TypeError(f"{type(model).__name__} has no fused apply spec the chain kernels take.")
    x = spec.assemble(batch)
    outs = fused_chains(model.activation_fn, x, named_chains(model, spec.chain_names))
    return spec.finalize(batch, outs)


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
