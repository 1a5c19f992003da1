"""Logical-axis sharding hints, resolved against the active mesh.

Models annotate activations with LOGICAL axes ("batch", "model", ...); the
launcher binds logical axes to mesh axes (e.g. batch -> ("pod", "data")).
Outside any binding the hints are no-ops, so the same model code runs in
the tests, on the card and in the dry-run unchanged.

PyTorch has no SPMD partitioner to hand a constraint to, so under a binding
a hint checks the layout it names: each resolved mesh axis (or product of
axes) must divide its dimension.  A binding that carries an ``__uneven__``
list (the dry-run's) records the hints that do not divide there, which the
reference's compiler would pad; without one, such a hint raises.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

_BINDING: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "axis_binding", default=None)


@contextlib.contextmanager
def axis_binding(**logical_to_mesh):
    """e.g. axis_binding(__mesh__=mesh, batch=("pod", "data"), model=("model",))."""
    tok = _BINDING.set(logical_to_mesh)
    try:
        yield
    finally:
        _BINDING.reset(tok)


def _resolve(binding: dict, axis):
    """A logical axis entry (a name, None or a tuple of names) as mesh axes:
    None, one axis name, or a tuple of them."""
    if axis is None:
        return None
    names = axis if isinstance(axis, tuple) else (axis,)
    mesh_axes: list = []
    for n in names:
        m = binding.get(n)
        if m:
            mesh_axes.extend(m if isinstance(m, tuple) else (m,))
    if not mesh_axes:
        return None
    return tuple(mesh_axes) if len(mesh_axes) > 1 else mesh_axes[0]


def shard_hint(x, *logical_axes):
    """``x`` unchanged; under a binding with a ``__mesh__``, first checks
    that every resolved axis divides its dimension of ``x``."""
    binding = _BINDING.get()
    if binding is None or "__mesh__" not in binding:
        return x
    sizes = binding["__mesh__"].shape
    for dim, axis in zip(x.shape, logical_axes):
        mesh_axes = _resolve(binding, axis)
        if mesh_axes is None:
            continue
        names = mesh_axes if isinstance(mesh_axes, tuple) else (mesh_axes,)
        n = math.prod(sizes[a] for a in names)
        if dim % n:
            if "__uneven__" not in binding:
                raise ValueError(f"shard_hint: dim {dim} of {tuple(x.shape)} is not divisible "
                                 f"by mesh axes {names} ({n} devices)")
            binding["__uneven__"].append((tuple(x.shape), tuple(logical_axes)))
    return x
