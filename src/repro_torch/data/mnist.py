"""Synthetic MNIST-style digit data (offline container — no downloads).

Procedurally rendered digit glyphs with deterministic jitter/noise, matching
MNIST's role in the paper: a handwritten-digit binary-classification source
for pairs like 3/9, 3/8, 3/6, 1/5 (§IV-B).  Images are 8x8 in [0, 1] —
already at the downsampled scale the paper's 4x4-filter segmentation expects.
"""
from __future__ import annotations

import numpy as np

# 5x7 glyph bitmaps (classic font) — rows are strings, '#' = ink.
_GLYPHS = {
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


def _glyph_array(d: int) -> np.ndarray:
    g = _GLYPHS[d]
    return np.array([[1.0 if ch == "#" else 0.0 for ch in row] for row in g],
                    np.float32)  # (7, 5)


def render_digit(d: int, rng: np.random.Generator, size: int = 8,
                 noise: float = 0.15) -> np.ndarray:
    """One jittered, noisy digit image (size x size, values in [0, 1])."""
    canvas = np.zeros((size + 4, size + 4), np.float32)
    glyph = _glyph_array(d)
    # random sub-pixel-ish placement via integer jitter
    r0 = 2 + rng.integers(-1, 2)
    c0 = 2 + rng.integers(-1, 2) + (size - 5) // 2 - 1
    r0 = int(np.clip(r0, 0, canvas.shape[0] - 7))
    c0 = int(np.clip(c0, 0, canvas.shape[1] - 5))
    canvas[r0:r0 + 7, c0:c0 + 5] = np.maximum(canvas[r0:r0 + 7, c0:c0 + 5], glyph)
    # crop center to size, blur-ish by averaging shifted copies (ink spread)
    img = canvas[2:2 + size, 2:2 + size]
    spread = img.copy()
    spread[1:, :] = np.maximum(spread[1:, :], 0.4 * img[:-1, :])
    spread[:, 1:] = np.maximum(spread[:, 1:], 0.4 * img[:, :-1])
    spread = spread * rng.uniform(0.8, 1.0)
    spread += noise * rng.random(spread.shape).astype(np.float32) * 0.5
    return np.clip(spread, 0.0, 1.0).astype(np.float32)


def make_pair_dataset(digit_a: int, digit_b: int, n_per_class: int,
                      seed: int = 0, size: int = 8):
    """Binary dataset for the paper's A/B classification tasks.

    Returns (images (N, size, size) f32, labels (N,) int32 — 1 for digit_a,
    0 for digit_b), shuffled deterministically.
    """
    rng = np.random.default_rng(seed + 1000 * digit_a + digit_b)
    xs, ys = [], []
    for d, y in ((digit_a, 1), (digit_b, 0)):
        for _ in range(n_per_class):
            xs.append(render_digit(d, rng, size=size))
            ys.append(y)
    xs = np.stack(xs)
    ys = np.array(ys, np.int32)
    order = rng.permutation(len(ys))
    return xs[order], ys[order]


def train_test_split(images: np.ndarray, labels: np.ndarray, test_frac: float = 0.25):
    n_test = int(len(labels) * test_frac)
    return ((images[n_test:], labels[n_test:]),
            (images[:n_test], labels[:n_test]))
