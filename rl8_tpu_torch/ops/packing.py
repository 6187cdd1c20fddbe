"""Row packing: the training batch as one int32 ``[N, D]`` matrix.

PyTorch counterpart of ``rl8_tpu/ops/packing.py``. The update kernel
(``csrc/ppo.cu``) reads every per-row input from one packed matrix, so an
epoch's shuffle is one gather and a minibatch is a contiguous slice.

Packing is bit-exact: 4-byte leaves are bitcast (``tensor.view(
torch.int32)``), narrower ones are widened losslessly first exactly as
the JAX package's ``_WIDEN`` does (``bool/int8/int16/uint8/uint16 ->
int32``, ``bfloat16/float16 -> float32``). Leaves are taken in pytree
order, i.e. nested dicts by sorted key as ``jax.tree_util`` flattens
them, so a column range means the same leaf in both packages: for the
flat training batch ``{actions, advantages, logp, returns, views: {obs}}``
the columns are actions, advantages, logp, returns, then obs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["block_shuffle", "pack_rows", "RowUnpacker"]

# Lossless widening for sub-4-byte dtypes (then bitcast to int32). The
# JAX package widens unsigned types to uint32; for uint8/uint16 values
# int32 holds the same bits.
_WIDEN: dict[torch.dtype, torch.dtype] = {
    torch.bool: torch.int32,
    torch.int8: torch.int32,
    torch.uint8: torch.int32,
    torch.int16: torch.int32,
    torch.uint16: torch.int32,
    torch.bfloat16: torch.float32,
    torch.float16: torch.float32,
}


@dataclass(frozen=True)
class _LeafMeta:
    start: int
    stop: int
    shape: tuple[int, ...]  # trailing (per-row) shape
    dtype: torch.dtype  # original dtype
    wide_dtype: torch.dtype  # dtype bitcast from int32 when unpacking


def _flatten(tree: Any) -> tuple[list[torch.Tensor], Any]:
    """Leaves in pytree order and a structure to rebuild the tree: dicts
    by sorted key, lists and tuples in order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            sub, d = _flatten(tree[k])
            leaves.extend(sub)
            defs.append(d)
        return leaves, ("dict", tuple(keys), tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for item in tree:
            sub, d = _flatten(item)
            leaves.extend(sub)
            defs.append(d)
        return leaves, (type(tree), None, tuple(defs))
    return [tree], None


def _unflatten(treedef: Any, leaves: list[Any]) -> Any:
    it = iter(leaves)

    def build(d: Any) -> Any:
        if d is None:
            return next(it)
        kind, keys, defs = d
        items = [build(sub) for sub in defs]
        if kind == "dict":
            return dict(zip(keys, items))
        return kind(items)

    return build(treedef)


@dataclass(frozen=True)
class RowUnpacker:
    """Inverse of :func:`pack_rows` for any leading batch size."""

    treedef: Any
    metas: tuple[_LeafMeta, ...]

    def __call__(self, packed: torch.Tensor) -> Any:
        rows = packed.shape[0]
        leaves = []
        for m in self.metas:
            col = packed[:, m.start : m.stop].contiguous().view(m.wide_dtype)
            leaves.append(col.reshape(rows, *m.shape).to(m.dtype))
        return _unflatten(self.treedef, leaves)

    def leaf_index_tree(self) -> Any:
        """The packed tree's structure with each leaf replaced by its
        index into :attr:`metas`: how the update kernel's wrapper finds a
        leaf's column range by key."""
        return _unflatten(self.treedef, list(range(len(self.metas))))


def pack_rows(tree: Any) -> tuple[torch.Tensor, RowUnpacker]:
    """Pack a tree (nested dicts, lists, tuples) of ``[N, ...]`` tensors
    into one contiguous ``[N, D]`` int32 matrix plus an unpacker that
    restores the tree bit-exactly from any ``[rows, D]`` selection of it.

    Examples:
        >>> import torch
        >>> from rl8_tpu_torch.ops.packing import pack_rows
        >>> tree = {"b": torch.tensor([[1.5], [2.5]]), "a": torch.tensor([[1, 0], [0, 1]])}
        >>> packed, unpack = pack_rows(tree)
        >>> tuple(packed.shape), [(m.start, m.stop) for m in unpack.metas]
        ((2, 3), [(0, 2), (2, 3)])
        >>> torch.equal(unpack(packed)["b"], tree["b"])
        True

    """
    leaves, treedef = _flatten(tree)
    cols = []
    metas = []
    offset = 0
    for leaf in leaves:
        dtype = leaf.dtype
        wide = _WIDEN.get(dtype)
        arr = leaf.to(wide) if wide is not None else leaf
        if arr.element_size() != 4:
            raise TypeError(f"pack_rows supports dtypes of at most 4 bytes, got {dtype}.")
        n = arr.shape[0]
        trailing = tuple(arr.shape[1:])
        width = 1
        for s in trailing:
            width *= s
        cols.append(arr.reshape(n, width).contiguous().view(torch.int32))
        metas.append(_LeafMeta(offset, offset + width, trailing, dtype, arr.dtype))
        offset += width
    packed = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
    return packed.contiguous(), RowUnpacker(treedef, tuple(metas))


def block_shuffle(packed: torch.Tensor, generator: torch.Generator, blk: int) -> torch.Tensor:
    """Uniformly permute ``packed [N, D]`` in blocks of ``blk``
    consecutive rows (rows inside a block stay adjacent and in order).

    ``blk`` must divide ``N``; ``blk=1`` is a row-level uniform shuffle.
    ``generator`` lives on ``packed``'s device. Returns a new contiguous
    tensor.
    """
    n, d = packed.shape
    if blk <= 0 or n % blk:
        raise ValueError(f"blk={blk} must be positive and divide the {n} rows.")
    perm = torch.randperm(n // blk, generator=generator, device=packed.device)
    return packed.reshape(n // blk, blk * d).index_select(0, perm).reshape(n, d)
