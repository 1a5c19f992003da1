"""Batching / sharding data pipeline (the "Data Cleaning" -> model feed
path of Fig 1, plus the classical-LM token pipeline for the architecture
zoo).

numpy in, numpy out for images: the trainer moves each batch to its device.
Token batches are ``torch.long`` tensors on the CPU, as ``batch_for`` makes
them; ``shard_batch`` places a batch over a ``DeviceMesh``.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.launch.partition import NamedSharding, P, tree_map_with_path


def clean(images: np.ndarray, clip_percentile: float = 99.5) -> np.ndarray:
    """Initial data cleaning (Fig 1): clamp extreme outliers, rescale to [0,1]."""
    hi = np.percentile(images, clip_percentile)
    x = np.clip(images, 0.0, hi) / max(hi, 1e-8)
    return x.astype(np.float32)


def batches(images: np.ndarray, labels: np.ndarray, batch_size: int,
            *, seed: int = 0, drop_remainder: bool = True,
            shuffle: bool = True) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Deterministic shuffled mini-batches."""
    n = len(labels)
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    end = n - (n % batch_size) if drop_remainder else n
    for i in range(0, end, batch_size):
        idx = order[i:i + batch_size]
        yield images[idx], labels[idx]


def synthetic_tokens(rng_seed: int, batch: int, seq_len: int, vocab: int) -> torch.Tensor:
    """Deterministic (batch, seq_len) token batch for LM smoke tests and
    benchmarks: the reference's values, as int64."""
    rng = np.random.default_rng(rng_seed)
    toks = rng.integers(0, vocab, size=(batch, seq_len), dtype=np.int32)
    return torch.from_numpy(toks).long()


def shard_batch(batch_arrays, mesh, axis: str = "data"):
    """Place host arrays (a tree of numpy arrays or tensors) onto a
    ``DeviceMesh``, each cut along its batch axis over ``axis`` (a
    ``partition.Sharded``: zero-padded to a multiple of the shard count,
    one piece per device in mesh order)."""
    def put(_, x):
        x = torch.as_tensor(x)
        return NamedSharding(mesh, P(axis, *([None] * (x.dim() - 1)))).place(x)
    return tree_map_with_path(put, batch_arrays)
