"""The dense encoding layer's gradient on the two m-qubit registers.

QuClassi's dense layer turns each patch into data angles
``x = pi * sigmoid(patch @ w + b)`` (``core/quclassi.py``
``encode_patches``), and the SWAP test reads ``F_c = |s_c|^2`` with
``s_c = <phi(x)|psi(theta_c)>``, the inner product of the data register's
state and the trainable register's, as the shift-bank kernel takes it.
``phi(x)`` is a product state, each data qubit's two amplitudes made by
its own encoding rotations, each driven by its own angle, so

    dF_c/dx_j = 2 Re(conj(s_c) ds_c/dx_j),

where ``ds_c/dx_j`` replaces one qubit's factor by its rotation's
derivative (``dR(a)/da = R(a + pi) / 2``).  ``grad_shift`` chains this
through the loss's weights and the sigmoid to ``w`` and ``b`` in two
steps:

  * ``register_partials``: per patch the angle gradient, chained to the
    dense layer's pre-activation by ``dx/dz = x (1 - x / pi)``, summed
    into partial ``dW`` and ``db``; on the CPU a plain PyTorch version that
    builds ``phi`` and its derivatives whole (one partial), on the card
    one of two kernels of ``vqc_dense_grad.cu``:

    - the register route, ``dense_grad_kernel``: one thread a patch,
      ``psi(theta_c)`` of every class in a block's shared memory, one
      partial a block;
    - the wide route (``RegisterPlan.wide``), for registers of m = 13-16
      qubits, whose psi outgrow shared memory: ``dense_wide_psi_kernel`` builds each class's
      psi once a call into device memory, then ``dense_wide_kernel`` gives
      a block a patch at a time, each thread a slice of the amplitudes,
      the block's sums in a fixed order, one partial a block;
  * ``reduce_partials``: the partials summed in a fixed order
    (``dense_reduce_kernel`` on the card), so two calls give the same bits.

``route_plan`` says which route a configuration takes: QuClassi's circuit
(``core/circuits.build_quclassi_circuit``: RX(x_2q) then RY(x_2q+1) on
each data qubit, the variational layers, the SWAP test) takes the register
route with registers of up to ``MAX_M`` qubits whose classes' psi fit a
block's shared memory, and the wide route up to ``WIDE_MAX_M`` qubits.
Wider registers take the dense simulator's autograd (``grad_shift``'s
"simulator" route).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core import circuits
from repro_torch.kernels import vqc_statevector as K

#: encoding rotations a data qubit holds (QuClassi's RX and RY);
#: ``kSlots`` in ``vqc_dense_grad.cu``
SLOTS = 2
#: the widest register of the route: psi of 2**12 (re, im) float32 a class
#: in one block's shared memory
MAX_M = 12
#: patches a tile, one thread each (``kDenseThreads``)
THREADS = 128
#: blocks of the register kernel per SM at most; a block takes whole tiles
BLOCKS_PER_SM = 4
#: the widest register of the wide route: psi of 2**16 (re, im) float32 a
#: class in device memory, the widths the shift walk's device-memory route
#: runs (27-33 qubits)
WIDE_MAX_M = 16
#: threads of a ``dense_wide_kernel`` block (``kWideThreads``); each fixes
#: the WIDE_LO_BITS least significant qubits of the amplitudes it sums
WIDE_THREADS = 256
WIDE_LO_BITS = 8
#: blocks of the wide kernel per SM at most; a block takes whole patches
WIDE_BLOCKS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class RegisterPlan:
    """The trainable register's ops and, per data qubit, its encoding
    rotations (register-local qubits, from ``build_shift_plan``)."""

    m: int
    train_ops: tuple
    slots: tuple[tuple, ...]
    wide: bool = False


def smem_bytes(plan: RegisterPlan, n_classes: int, patch_dim: int) -> int:
    """Shared memory of a block of ``dense_grad_kernel``: psi of every
    class, a tile's patches and angle gradients, the block's partial."""
    n_angles = SLOTS * plan.m
    floats = n_classes * 2 * 2**plan.m + THREADS * (patch_dim + n_angles)
    return 4 * (floats + patch_dim * n_angles + n_angles)


def wide_smem_bytes(plan: RegisterPlan, n_classes: int, patch_dim: int) -> int:
    """Shared memory of a block of ``dense_wide_kernel``: the swept qubits'
    table, the warps' and the block's sums, a patch's cos / sin and dL/dz,
    the block's partial."""
    mh = max(plan.m - WIDE_LO_BITS, 0)
    n_angles, n_vals = SLOTS * plan.m, 2 + 4 * plan.m
    floats = (2 * 2**mh * (mh + 1) + (WIDE_THREADS // 32 + 1) * n_classes * n_vals
              + 3 * n_angles + patch_dim * n_angles + n_angles)
    return 4 * floats


def psi_smem(plan: RegisterPlan) -> tuple[bool, int]:
    """(state in shared memory, bytes) of a ``dense_wide_psi_kernel`` block:
    the op table and each op's cos / sin, and the state where it fits
    beside them (m <= 14), else the state is built in device memory."""
    tables = 4 * (2 * len(plan.train_ops) + _tables(plan)[0].size)
    in_smem = tables + 8 * 2**plan.m <= K.SMEM_BUDGET_BYTES
    return in_smem, tables + (8 * 2**plan.m if in_smem else 0)


@functools.lru_cache(maxsize=None)
def route_plan(qc: int, n_layers: int, n_classes: int, patch_dim: int) -> RegisterPlan | None:
    """The dense gradient's plan for QuClassi's ``qc``-qubit, ``n_layers``
    circuit: the register route where its registers are at most ``MAX_M``
    qubits and one block of the register kernel fits the card's shared
    memory, the wide route (``wide``) where they are of ``MAX_M`` + 1 to
    ``WIDE_MAX_M`` qubits, else None (the simulator route); the same on
    every device, so a CPU run takes the route the card would.  Decided
    once a configuration."""
    if (qc - 1) // 2 > WIDE_MAX_M:
        return None
    plan = K.build_shift_plan(circuits.build_quclassi_circuit(qc, n_layers))
    slots = [[] for _ in range(plan.m)]
    for op in plan.data_ops:
        slots[op.qubits[0]].append(op)
    encoding = [[(op.gate, op.param) for op in ops] for ops in slots]
    if encoding != [[("rx", ("data", 2 * q)), ("ry", ("data", 2 * q + 1))]
                    for q in range(plan.m)]:
        raise RuntimeError(f"QuClassi's {qc}q encoding is not RX, RY on each data qubit")
    plan = RegisterPlan(plan.m, plan.train_ops, tuple(tuple(ops) for ops in slots))
    if plan.m <= MAX_M:
        return plan if smem_bytes(plan, n_classes, patch_dim) <= K.SMEM_BUDGET_BYTES else None
    plan = dataclasses.replace(plan, wide=True)
    if wide_smem_bytes(plan, n_classes, patch_dim) > K.SMEM_BUDGET_BYTES:
        return None
    return plan


@functools.lru_cache(maxsize=None)
def _tables(plan: RegisterPlan):
    """The train ops' table and the data slots' (``m * SLOTS`` rows), each
    with its constant angles."""
    train_i, train_f = K._ops_table(plan.train_ops)
    rows, consts = zip(*(K._op_row(op) for ops in plan.slots for op in ops))
    return (train_i, train_f, np.array(rows, np.int32).reshape(-1, 6),
            np.array(consts, np.float32))


def _psi_plain(plan: RegisterPlan, theta):
    """psi(theta_c) of every class, (C, 2**m) complex."""
    re, im = K._zero_tile(2**plan.m, theta.shape[0], theta.device)
    th = theta.T
    for op in plan.train_ops:
        re, im = K._apply_one(op, re, im, plan.m, th, None)
    return torch.complex(re, im).T


def _factor_plain(ops, x, shifted=None):
    """One data qubit's factor, (N, 2) complex, from its rotations on |0>;
    rotation ``shifted`` replaced by its derivative R(a + pi) / 2."""
    re, im = K._zero_tile(2, x.shape[1], x.device)
    for k, op in enumerate(ops):
        ang = K._op_angle(op, x, x)
        c, s = torch.cos(ang / 2), torch.sin(ang / 2)
        if k == shifted:
            c, s = -s, c
        re, im = K._apply_cs(dataclasses.replace(op, qubits=(0,)), re, im, 1, c, s)
    f = torch.complex(re, im).T
    return f if shifted is None else f * 0.5


def _product(factors):
    """(N, 2**m) product state of m (N, 2) factors, qubit 0 most significant."""
    out = factors[0]
    for f in factors[1:]:
        out = (out[:, :, None] * f[:, None, :]).reshape(out.shape[0], -1)
    return out


def _partials_plain(plan: RegisterPlan, theta, angles, patches, weights, n_patches):
    """Plain version of ``dense_grad_kernel`` and of the wide route's two
    kernels: the whole batch as one partial, (1, patch_dim * A + A)."""
    psi = _psi_plain(plan, theta)                                   # (C, 2**m)
    x = angles.T                                                    # (A, N)
    factors = [_factor_plain(ops, x) for ops in plan.slots]
    s = _product(factors).conj() @ psi.T                            # (N, C)
    w = weights.repeat_interleave(n_patches, 0)                     # (N, C)
    w = torch.where(s.real**2 + s.imag**2 > 1.0, 0.0, w)
    dz = torch.zeros_like(angles)
    for q, ops in enumerate(plan.slots):
        for k, op in enumerate(ops):
            d = list(factors)
            d[q] = _factor_plain(ops, x, k)
            ds = _product(d).conj() @ psi.T                         # (N, C)
            dfdx = 2.0 * (s.real * ds.real + s.imag * ds.imag)
            j = op.param[1]
            xj = angles[:, j]
            dz[:, j] = (w * dfdx).sum(-1) * (xj * (1.0 - xj / math.pi))
    return torch.cat([(patches.T @ dz).reshape(-1), dz.sum(0)])[None]


def _partials_cuda(plan: RegisterPlan, theta, angles, patches, weights, n_patches):
    n, a, pd, c = angles.shape[0], angles.shape[1], patches.shape[1], theta.shape[0]
    dev = theta.device
    train_i, train_f, slot_i, slot_f = K._on_device(("dense", plan), _tables(plan), dev)
    n_tiles = -(-n // THREADS)
    per_block = max(1, -(-n_tiles // (BLOCKS_PER_SM * K._sm_count(dev))))
    blocks = -(-n_tiles // per_block)
    partial = torch.empty((blocks, pd * a + a), dtype=torch.float32, device=dev)
    lib = K._lib("vqc_dense_grad")
    with torch.cuda.device(dev):
        rc = lib.vqc_dense_grad_launch(
            K._ptr(theta), theta.shape[1], c, K._ptr(train_i), K._ptr(train_f),
            len(plan.train_ops), K._ptr(slot_i), K._ptr(slot_f), plan.m,
            K._ptr(angles), a, K._ptr(patches), pd, K._ptr(weights), n_patches, n,
            per_block, blocks, K._ptr(partial), smem_bytes(plan, c, pd), K._stream(dev),
        )
    K._check_launch(lib, rc, "dense-gradient")
    K._count("dense_grad")
    return partial


def _partials_wide_cuda(plan: RegisterPlan, theta, angles, patches, weights, n_patches):
    n, a, pd, c = angles.shape[0], angles.shape[1], patches.shape[1], theta.shape[0]
    dev = theta.device
    train_i, train_f, slot_i, slot_f = K._on_device(("dense", plan), _tables(plan), dev)
    lib = K._lib("vqc_dense_grad")
    psi = torch.empty((c, 2, 2**plan.m), dtype=torch.float32, device=dev)
    per_block = max(1, -(-n // (WIDE_BLOCKS_PER_SM * K._sm_count(dev))))
    blocks = -(-n // per_block)
    partial = torch.empty((blocks, pd * a + a), dtype=torch.float32, device=dev)
    in_smem, psi_bytes = psi_smem(plan)
    with torch.cuda.device(dev):
        rc = lib.vqc_dense_wide_psi_launch(
            K._ptr(theta), theta.shape[1], c, K._ptr(train_i), K._ptr(train_f),
            len(plan.train_ops), plan.m, K._ptr(psi), int(in_smem), psi_bytes, K._stream(dev))
        K._check_launch(lib, rc, "dense-gradient psi")
        K._count("dense_wide_psi")
        rc = lib.vqc_dense_wide_launch(
            K._ptr(psi), c, K._ptr(slot_i), K._ptr(slot_f), plan.m, K._ptr(angles), a,
            K._ptr(patches), pd, K._ptr(weights), n_patches, n, per_block, blocks,
            K._ptr(partial), wide_smem_bytes(plan, c, pd), K._stream(dev))
    K._check_launch(lib, rc, "wide dense-gradient")
    K._count("dense_wide")
    return partial


def register_partials(plan: RegisterPlan, theta: torch.Tensor, angles: torch.Tensor,
                      patches: torch.Tensor, weights: torch.Tensor,
                      n_patches: int) -> torch.Tensor:
    """Partial sums of the dense layer's gradient, (G, patch_dim * A + A):
    each row ``dW`` (row-major, ``(patch_dim, A)``) then ``db``.

    ``theta (C, P)``; ``angles (B * n_patches, A)``, the encoded patches'
    angles in ``[0, pi]``; ``patches (B * n_patches, patch_dim)``;
    ``weights (B, C)``: dL/dF of one patch of image b for class c, the
    loss's masks and means folded in (``quclassi.dense_chain_weights``)."""
    n, a = angles.shape
    want = (n // n_patches, theta.shape[0])
    if patches.shape[0] != n or tuple(weights.shape) != want:
        raise ValueError(f"expected patches ({n}, patch_dim) and weights {want}, got "
                         f"{tuple(patches.shape)} and {tuple(weights.shape)}")
    if a != SLOTS * plan.m:
        raise ValueError(f"expected {SLOTS * plan.m} angles a patch, got {a}")
    args = [t.to(torch.float32).contiguous() for t in (theta, angles, patches, weights)]
    if theta.device.type == "cpu":
        return _partials_plain(plan, *args, n_patches)
    return (_partials_wide_cuda if plan.wide else _partials_cuda)(plan, *args, n_patches)


def reduce_partials(partials: torch.Tensor, patch_dim: int, n_angles: int):
    """-> (dW (patch_dim, n_angles), db (n_angles,)): the partials summed
    over their rows in row order."""
    if partials.device.type == "cpu":
        total = partials.sum(0)
    else:
        total = torch.empty(partials.shape[1], dtype=torch.float32, device=partials.device)
        lib = K._lib("vqc_dense_grad")
        with torch.cuda.device(partials.device):
            rc = lib.vqc_dense_reduce_launch(K._ptr(partials), partials.shape[0],
                                             partials.shape[1], K._ptr(total),
                                             K._stream(partials.device))
        K._check_launch(lib, rc, "dense-gradient reduction")
        K._count("dense_reduce")
    return total[: patch_dim * n_angles].view(patch_dim, n_angles), total[patch_dim * n_angles:]
