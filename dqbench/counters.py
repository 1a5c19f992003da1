"""The yardstick's arithmetic: the float32 operations and bytes a QuClassi
step needs, counted from the configuration, the batch and the workers'
share of the bank alone (no plan or table of the program is read), and the
chip's peaks.

Operations are counted on register states of 2**m amplitudes, as the
parameter-shift bank needs them: one sample of a worker's share of a bank
runs the encoding on the data register, the variational layers forward on
the trainable register, the walk back from the last gate down to the
shallowest gate that one of its shifted parameters drives, the shifted
gate of each of its variants, and one inner product for the base fidelity
and one a variant.  A gate application costs ``FLOPS_PER_AMP`` operations
an amplitude.  The bytes of a share are its inputs read once (the sample's
P + D float32 angles) and its outputs written once (one float32 fidelity a
group).  The dense layer's gradient counts as three forward evaluations of
each (class, patch) circuit, counted on the registers as the base circuit
of a bank (the encoding, the variational layers, one inner product), and
of each patch's dense encoding (a product of its pixels with ``w``).
"""
from __future__ import annotations

#: NVIDIA H100 SXM (data sheet): float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

#: float32 operations per amplitude of one gate application: a rotation
#: updates each amplitude with 2 products and 1 sum for re and for im; a
#: controlled rotation touches half the amplitudes; H is 1 sum and 1
#: product per component; CSWAP only moves data.
FLOPS_PER_AMP = {"rx": 6, "ry": 6, "rz": 6, "ryy": 6, "rzz": 6,
                 "cry": 3, "crz": 3, "h": 4, "cswap": 0}
INNER_FLOPS_PER_AMP = 8  # |<chi|phi>|^2: 4 products, 4 sums per amplitude


def register_ops(model) -> tuple[list, list]:
    """(data gates, trainable gates) by name, in circuit order."""
    return [g for g, _, _ in model.data_ops], [g for g, _, _ in model.train_ops]


def share_flops(model, groups) -> int:
    """Operations of one sample of the bank groups ``groups`` (group 0 the
    base circuit, 1 + s * P + j parameter j shifted by the s-th shift)."""
    data, train = register_ops(model)
    p = model.n_theta
    pos = {j: k for k, (_, _, j) in enumerate(model.train_ops)}
    anchors = [pos[(g - 1) % p] for g in groups if g > 0]
    gates = data + train
    if anchors:
        gates += train[min(anchors):]
        gates += [train[k] for k in anchors]
    n_inner = 1 + len(anchors)
    dim = 2**model.m
    return sum(FLOPS_PER_AMP[g] for g in gates) * dim + n_inner * INNER_FLOPS_PER_AMP * dim


def share_bytes(model, groups) -> int:
    """Bytes of one sample of a share: its angles in, its fidelities out."""
    return 4 * (model.n_theta + model.n_angles) + 4 * len(groups)


def dense_flops(model, samples: int) -> int:
    """Operations of the dense layer's gradient over ``samples`` patches:
    three forward evaluations of each (class, patch) circuit on the
    registers and of each patch's encoding, ``w`` times its pixels plus ``b``."""
    encode = 2 * model.filter_width**2 * model.n_angles
    return 3 * samples * (model.n_classes * share_flops(model, (0,)) + encode)


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the chip could take: operations or bytes at peak."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def round_robin(n_groups: int, n_workers: int) -> list[tuple[int, ...]]:
    """Each worker's groups under the round-robin assignment."""
    return [tuple(range(w, n_groups, n_workers)) for w in range(min(n_workers, n_groups))]


def bank_bound_s(model, samples: int, n_workers: int) -> float:
    """Summed bound of one step's bank launches: a share a worker, a class."""
    shares = round_robin(1 + 2 * model.n_theta, n_workers)
    one_class = sum(bound_s(samples * share_flops(model, g), samples * share_bytes(model, g))[0]
                    for g in shares)
    return model.n_classes * one_class


def step_flops(model, batch: int, n_workers: int) -> int:
    """Operations one training step needs: every worker's share of every
    class's bank, and the dense layer's gradient where there is one."""
    samples = batch * model.n_patches
    shares = round_robin(1 + 2 * model.n_theta, n_workers)
    total = model.n_classes * samples * sum(share_flops(model, g) for g in shares)
    if model.use_dense:
        total += dense_flops(model, samples)
    return total


def circuits_per_step(model, batch: int) -> int:
    """Parameter-shift circuits of a step: C x B x Np x (2P + 1)."""
    return model.n_classes * batch * model.n_patches * (2 * model.n_theta + 1)
