"""The least work of the dense layer's gradient on the wide route, which no
implementation can do with less: one inner product of the two 2**m-amplitude
registers for each (class, patch) (``counters.INNER_FLOPS_PER_AMP`` an
amplitude) and the trainable register's gates once a class
(``counters.FLOPS_PER_AMP``); the patches, ``w`` and ``b`` read once, and
``dW`` and ``db`` written once.  Counted from the configuration and the
number of patches alone.

``counters.dense_flops`` counts three forward evaluations of every (class,
patch) circuit, the encoding included, which a route that builds psi once a
class and takes the environments of one sweep does not need, so a roofline
on it would read the kernel faster than the card.
"""
from __future__ import annotations

import counters


def flops(model, samples: int) -> int:
    dim = 2**model.m
    _, train = counters.register_ops(model)
    psi = sum(counters.FLOPS_PER_AMP[g] for g in train) * dim
    return model.n_classes * (samples * counters.INNER_FLOPS_PER_AMP * dim + psi)


def nbytes(model, samples: int) -> int:
    pixels = model.filter_width**2
    layer = pixels * model.n_angles + model.n_angles
    return 4 * (samples * pixels + 2 * layer)


def bound_s(model, samples: int) -> float:
    """The least time the chip could take for one call over ``samples``
    patches: operations or bytes at peak."""
    return counters.bound_s(flops(model, samples), nbytes(model, samples))[0]
