"""Task Segmentation module (paper §III-A, Fig 2).

Decomposes a large classical input (an image) into filter-sized sections that
are small enough to encode on low-qubit quantum workers.  The paper's
evaluation settings: stride s=2, filter width w=4, nF=4 filters.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    filter_width: int = 4   # w in Algorithm 1
    stride: int = 2         # s in Algorithm 1
    n_filters: int = 4      # nF in Algorithm 1


def n_patches(height: int, width: int, cfg: SegmentationConfig) -> tuple[int, int]:
    """Patch grid dims after implicit zero-padding to cover the full image."""
    def count(sz):
        return max(1, -(-(sz - cfg.filter_width) // cfg.stride) + 1)
    return count(height), count(width)


def segment(images: torch.Tensor, cfg: SegmentationConfig) -> torch.Tensor:
    """(B, H, W) images -> (B, n_patches, w*w) flattened sections.

    Sections are extracted in row-major order with stride ``cfg.stride`` and
    zero padding on the bottom/right edges ("there might be padding between
    the sections", paper Fig 2).
    """
    b, h, w = images.shape
    ph, pw = n_patches(h, w, cfg)
    need_h = (ph - 1) * cfg.stride + cfg.filter_width
    need_w = (pw - 1) * cfg.stride + cfg.filter_width
    x = F.pad(images, (0, need_w - w, 0, need_h - h))
    fw = cfg.filter_width
    rows = []
    for i in range(ph):
        for j in range(pw):
            r, c = i * cfg.stride, j * cfg.stride
            rows.append(x[:, r : r + fw, c : c + fw].reshape(b, -1))
    return torch.stack(rows, dim=1)  # (B, ph*pw, w*w)


def reassemble_coverage(height: int, width: int, cfg: SegmentationConfig) -> np.ndarray:
    """How many patches cover each source pixel (property-test helper)."""
    ph, pw = n_patches(height, width, cfg)
    need_h = (ph - 1) * cfg.stride + cfg.filter_width
    need_w = (pw - 1) * cfg.stride + cfg.filter_width
    cov = np.zeros((need_h, need_w), np.int32)
    for i in range(ph):
        for j in range(pw):
            r, c = i * cfg.stride, j * cfg.stride
            cov[r:r + cfg.filter_width, c:c + cfg.filter_width] += 1
    return cov[:height, :width]


def subtasks_per_image(height: int, width: int, cfg: SegmentationConfig) -> int:
    ph, pw = n_patches(height, width, cfg)
    return ph * pw * cfg.n_filters
