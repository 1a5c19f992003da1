"""Sharding rules: parameter / optimizer / batch / cache trees -> shardings.

The reference's policy, rule for rule:
  * batch axis of inputs/activations -> ("pod", "data")      [data parallel]
  * weight matrices -> 2-D sharded: last dim over "model" (tensor parallel),
    second-to-last over "data" (FSDP-style) when divisible — this is what
    lets 340B/671B parameter + optimizer state fit 16 GB/chip.
  * MoE expert banks (L, E, in, out): E over "model" (expert parallel),
    `in` over "data".
  * small vectors (norms, biases) replicated.
  * decode caches: batch over ("pod","data") when divisible, else the cache
    LENGTH axis over "data" (context parallelism for long_500k's batch=1).

Divisibility is checked against the mesh; anything non-divisible is left
unsharded on that axis.

Trees are nested dicts and lists whose leaves carry ``shape`` (tensors or
``TensorSpec``s).  A leaf's path joins its dict keys and list indices with
"/" as the reference's does: ``blocks/0/mixer/wq``, ``m/embed``.  The
reference's parameter tree is what ``transformer.params_to_numpy`` yields
(``blocks`` one entry per pattern position, stacked over periods).

A ``NamedSharding`` on a shape-only mesh (``mesh.ShapeMesh``) gives
per-device shapes and bytes; on a ``DeviceMesh`` (one process, ``model`` =
1) it also places tensors: whole on the mesh's first device, or cut along
``data`` over its devices with ``sharded_executor``'s padding and order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.launch.mesh import DeviceMesh, batch_axes


class PartitionSpec(tuple):
    """Per dimension: a mesh axis name, ``None`` (unsharded) or a tuple of
    names (sharded over their product)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is never made (the counterpart of
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def spec_of(x) -> TensorSpec:
    return x if isinstance(x, TensorSpec) else TensorSpec(tuple(x.shape), x.dtype)


@dataclasses.dataclass
class Sharded:
    """A tensor cut along ``dim`` into one piece per device of a mesh's
    ``data`` axis, in mesh order, after zero padding to a multiple of the
    shard count; ``size`` is the uncut length of ``dim``."""

    pieces: tuple[torch.Tensor, ...]
    dim: int
    size: int


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes one entry of a ``PartitionSpec`` names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The per-device shape of a ``shape`` leaf (each dim cut by the
        product of its axes' sizes; the specs only shard dims they divide)."""
        sizes = self.mesh.shape
        out = list(shape)
        for i, entry in enumerate(self.spec):
            out[i] //= math.prod(sizes[a] for a in spec_axes(entry))
        return tuple(out)

    def shard_bytes(self, leaf) -> int:
        s = spec_of(leaf)
        return math.prod(self.shard_shape(s.shape)) * s.dtype.itemsize

    def place(self, x: torch.Tensor):
        """``x`` on a ``DeviceMesh``: whole on the first device when no dim
        is sharded over ``data``, else a ``Sharded`` cut along that dim."""
        if not isinstance(self.mesh, DeviceMesh):
            raise TypeError(f"a {type(self.mesh).__name__} has no devices to place on")
        devices = self.mesh.devices
        dims = [i for i, e in enumerate(self.spec) if "data" in spec_axes(e)]
        if not dims:
            return x.to(devices[0])
        dim, n = dims[0], len(devices)
        size = x.shape[dim]
        pad = (-size) % n
        if pad:
            zeros = x.new_zeros(x.shape[:dim] + (pad,) + x.shape[dim + 1:])
            x = torch.cat([x, zeros], dim)
        per = (size + pad) // n
        pieces = tuple(x.narrow(dim, i * per, per).to(dev, non_blocking=True).contiguous()
                       for i, dev in enumerate(devices))
        return Sharded(pieces, dim, size)


# ------------------------------------------------------------------ trees
def tree_map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(path, leaf)`` over every leaf, keeping the tree's structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def tree_leaves_with_path(tree) -> list[tuple[str, Any]]:
    out: list = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def tree_zip_leaves(tree, other) -> list[tuple[Any, Any]]:
    """Pairs of leaves of two trees of one structure."""
    return [(a, b) for (_, a), (_, b) in zip(tree_leaves_with_path(tree),
                                             tree_leaves_with_path(other))]


def _divides(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


class Partitioner:
    def __init__(self, mesh):
        self.mesh = mesh
        self.model_n = mesh.shape.get("model", 1)
        self.data_n = mesh.shape.get("data", 1)
        self.batch_ax = batch_axes(mesh)
        self.batch_n = math.prod(mesh.shape[a] for a in self.batch_ax)

    # ------------------------------------------------------------ weights
    def param_spec(self, path: str, shape: tuple[int, ...]) -> PartitionSpec:
        dims: list = [None] * len(shape)
        if len(shape) == 0:
            return P()
        lead = 1 if path.startswith("blocks/") else 0   # blocks carry the period axis

        if "experts/" in path and len(shape) - lead == 3:
            e_i, in_i = lead, lead + 1
            if _divides(shape[e_i], self.model_n):
                dims[e_i] = "model"
            if _divides(shape[in_i], self.data_n):
                dims[in_i] = "data"
            return P(*dims)

        if path.startswith("embed"):
            # (V, D) or (K, V, D): vocab-parallel
            v_i = len(shape) - 2
            if _divides(shape[v_i], self.model_n):
                dims[v_i] = "model"
            if _divides(shape[-1], self.data_n):
                dims[-1] = "data"
            return P(*dims)

        if len(shape) - lead >= 2:
            if _divides(shape[-1], self.model_n):
                dims[-1] = "model"
            if _divides(shape[-2], self.data_n):
                dims[-2] = "data"
        # 1-D vectors (norm scales, biases) stay replicated
        return P(*dims)

    def param_shardings(self, params_shapes):
        return tree_map_with_path(
            lambda path, leaf: NamedSharding(self.mesh, self.param_spec(path, tuple(leaf.shape))),
            params_shapes)

    def opt_shardings(self, opt_shapes, params_shapes):
        """Optimizer moments mirror the param specs; scalars replicate."""
        p_flat = dict(tree_leaves_with_path(params_shapes))

        def one(path, leaf):
            sub = path.split("/", 1)[1] if "/" in path else ""   # strip the leading m/ v/
            if sub in p_flat and tuple(p_flat[sub].shape) == tuple(leaf.shape):
                return NamedSharding(self.mesh, self.param_spec(sub, tuple(leaf.shape)))
            return NamedSharding(self.mesh, P())

        return tree_map_with_path(one, opt_shapes)

    # ------------------------------------------------------------- inputs
    def batch_spec(self, shape: tuple[int, ...]) -> PartitionSpec:
        dims: list = [None] * len(shape)
        if len(shape) and _divides(shape[0], self.batch_n):
            dims[0] = self.batch_ax if len(self.batch_ax) > 1 else self.batch_ax[0]
        return P(*dims)

    def batch_shardings(self, batch_shapes):
        return tree_map_with_path(
            lambda _, leaf: NamedSharding(self.mesh, self.batch_spec(tuple(leaf.shape))),
            batch_shapes)

    def cache_spec(self, path: str, shape: tuple[int, ...]) -> PartitionSpec:
        """Cache leaves carry (period, B, ...) leading axes.

        Batch axis shards over ("pod","data") when divisible; the cache
        LENGTH/state axis (index 2: T for attention, d_inner for Mamba,
        d_model for sLSTM) additionally shards over "model" — sequence/
        context parallelism for decode.  With batch=1 (long_500k) the
        length axis takes every available mesh axis instead.
        """
        dims: list = [None] * len(shape)
        batch_dim = self.batch_ax if len(self.batch_ax) > 1 else self.batch_ax[0]
        if len(shape) >= 2 and _divides(shape[1], self.batch_n):
            dims[1] = batch_dim
            if len(shape) >= 3 and _divides(shape[2], self.model_n):
                dims[2] = "model"
            elif len(shape) >= 4 and _divides(shape[3], self.model_n):
                dims[3] = "model"
            return P(*dims)
        # batch not shardable: context-parallel over everything available
        all_axes = tuple(self.batch_ax) + ("model",)
        total = self.batch_n * self.model_n
        if len(shape) >= 3:
            if _divides(shape[2], total):
                dims[2] = all_axes
            elif _divides(shape[2], self.data_n):
                dims[2] = "data"
                if len(shape) >= 4 and _divides(shape[3], self.model_n):
                    dims[3] = "model"
        return P(*dims)

    def cache_shardings(self, cache_shapes):
        return tree_map_with_path(
            lambda path, leaf: NamedSharding(self.mesh, self.cache_spec(path, tuple(leaf.shape))),
            cache_shapes)

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())


def logical_binding(mesh) -> dict:
    """Logical-axis binding for ``models.sharding.axis_binding``."""
    return {
        "__mesh__": mesh,
        "batch": batch_axes(mesh),
        "model": ("model",),
        "model_act": None,     # activations: keep d_model unsharded (baseline)
    }


def per_device_bytes(tree, shardings) -> int:
    """Bytes of ``tree``'s leaves on one device under ``shardings`` (a tree
    of one structure, or one sharding for every leaf)."""
    if isinstance(shardings, NamedSharding):
        return sum(shardings.shard_bytes(leaf) for _, leaf in tree_leaves_with_path(tree))
    return sum(sh.shard_bytes(leaf) for leaf, sh in tree_zip_leaves(tree, shardings))
