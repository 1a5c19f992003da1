"""Synthetic MNIST-style digit pairs, made from a seed (the benchmark's own
frozen copy of the program's ``data/mnist.py`` generator and the trainer's
``pipeline.clean``, vectorised so that a pool of tens of thousands of
images takes milliseconds).

Each image is a 5x7 glyph placed with a jitter of -1..1 rows and columns on
an 8x8 canvas, its ink spread one pixel down and right at 0.4, scaled by
U(0.8, 1), with uniform noise of amplitude ``noise / 2`` added, clipped to
[0, 1].  Labels: 1 for ``digit_a``, 0 for ``digit_b``, balanced, shuffled.
"""
from __future__ import annotations

import numpy as np

GLYPHS = {
    0: [" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "],
    1: ["  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],
    2: [" ### ", "#   #", "    #", "   # ", "  #  ", " #   ", "#####"],
    3: [" ### ", "#   #", "    #", "  ## ", "    #", "#   #", " ### "],
    4: ["   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "],
    5: ["#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "],
    6: [" ### ", "#    ", "#    ", "#### ", "#   #", "#   #", " ### "],
    7: ["#####", "    #", "   # ", "  #  ", " #   ", " #   ", " #   "],
    8: [" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "],
    9: [" ### ", "#   #", "#   #", " ####", "    #", "    #", " ### "],
}


def _templates(digit: int, size: int) -> np.ndarray:
    """(3, 3, size, size): the glyph placed at each of the nine jitters,
    ink spread applied (rows and columns of the jitter -1, 0, 1)."""
    glyph = np.array([[ch == "#" for ch in row] for row in GLYPHS[digit]], np.float32)
    out = np.zeros((3, 3, size, size), np.float32)
    for a, dr in enumerate((-1, 0, 1)):
        for b, dc in enumerate((-1, 0, 1)):
            canvas = np.zeros((size + 4, size + 4), np.float32)
            r0 = int(np.clip(2 + dr, 0, canvas.shape[0] - 7))
            c0 = int(np.clip(2 + dc + (size - 5) // 2 - 1, 0, canvas.shape[1] - 5))
            canvas[r0:r0 + 7, c0:c0 + 5] = glyph
            img = canvas[2:2 + size, 2:2 + size]
            spread = img.copy()
            spread[1:, :] = np.maximum(spread[1:, :], 0.4 * img[:-1, :])
            spread[:, 1:] = np.maximum(spread[:, 1:], 0.4 * img[:, :-1])
            out[a, b] = spread
    return out


def make_pairs(digit_a: int, digit_b: int, n: int, seed: int, size: int = 8,
               noise: float = 0.15) -> tuple[np.ndarray, np.ndarray]:
    """``n`` images (n, size, size) float32 and labels (n,) int64."""
    rng = np.random.default_rng(seed)
    labels = np.zeros(n, np.int64)
    labels[: n // 2] = 1
    labels = labels[rng.permutation(n)]
    temps = np.stack([_templates(digit_b, size), _templates(digit_a, size)])
    jit = rng.integers(0, 3, size=(n, 2))
    imgs = temps[labels, jit[:, 0], jit[:, 1]]
    imgs = imgs * rng.uniform(0.8, 1.0, size=(n, 1, 1)).astype(np.float32)
    imgs = imgs + noise * rng.random((n, size, size), dtype=np.float32) * 0.5
    return np.clip(imgs, 0.0, 1.0).astype(np.float32), labels


def clean(images: np.ndarray, clip_percentile: float = 99.5) -> np.ndarray:
    """Clamp outliers at the percentile and rescale to [0, 1]."""
    hi = np.percentile(images, clip_percentile)
    return (np.clip(images, 0.0, hi) / max(hi, 1e-8)).astype(np.float32)
