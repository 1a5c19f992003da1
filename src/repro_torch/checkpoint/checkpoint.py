"""Pytree checkpointing to ``.npz``, in the reference's file format.

A tree of tensors or numpy arrays, nested in dicts, lists and tuples, is
flattened to '/'-joined key paths (dict keys sorted, list and tuple
indices) and written with ``np.savez`` beside ``__meta__``, the metadata
as JSON: the layout of ``repro/checkpoint/checkpoint.py``, so a file
written by either package loads in the other.

bfloat16 leaves are written as the reference writes them: 2-byte ``V2``
records holding the bf16 bits (the reference's header names them ``<V2``
through ``ml_dtypes``; this one ``|V2``; numpy reads both as ``V2``).  The
reference cannot restore such a leaf (``load(like=...)`` raises
``ValueError: No cast function available``), and neither does this
``load``: it raises a ``ValueError`` naming the leaf (ROADMAP Queue 3 R4).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = to_numpy(tree)
    return out


def save(path: str, tree, metadata: dict | None = None) -> None:
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=json.dumps(metadata or {}), **flat)


def load(path: str, like=None):
    """Load a checkpoint -> ``(tree, meta)``.  Without ``like``, ``tree`` is
    the flat ``{path: numpy array}`` dict.  With ``like`` (a template tree),
    it is the template's structure, each leaf cast to the template leaf's
    dtype and shape, a tensor on its device where the template holds a
    tensor, else a numpy array."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(str(z["__meta__"])) if "__meta__" in z.files else {}
    if like is None:
        return flat, meta
    return _restore(like, flat, ""), meta


def _restore(tree, flat: dict, prefix: str):
    if isinstance(tree, dict):
        return {k: _restore(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore(v, flat, f"{prefix}{i}/") for i, v in enumerate(tree))
    key = prefix[:-1]
    arr = flat[key]
    if arr.dtype.kind == "V":
        raise ValueError(
            f"checkpoint leaf {key!r} holds {arr.dtype.itemsize}-byte raw records ({arr.dtype}, "
            "how bfloat16 leaves are written); the reference's load(like=...) raises "
            "'No cast function available' on them, and this load does not guess a cast")
    if isinstance(tree, torch.Tensor):
        out = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype=tree.dtype)
        return out.reshape(tree.shape).to(tree.device)
    ref = np.asarray(tree)
    return np.asarray(arr, dtype=ref.dtype).reshape(ref.shape)
