"""Fused VQC statevector kernels for Hopper — the DQuLearn compute hot-spot.

The data plane executes millions of small circuits (5–7 qubits, 10–30
gates): the parameter-shift circuit banks.  Each circuit is simulated whole
inside one kernel, from |0...0> to the ancilla readout; up to 14 qubits
the statevector never touches device memory.  Five CUDA kernels (``csrc/``) replace the
five Pallas kernels of ``repro/kernels/vqc_statevector.py`` that the
training path reaches, with device-memory routes beside three of them:

  * ``vqc_fused.cu`` ``fidelity_kernel`` replaces ``_fidelity_kernel``
    (launched from ``_grid_call``): evolve the full n-qubit state, write the
    ancilla P(0).  Materialized banks and per-worker row batches.
  * ``vqc_fused.cu`` ``state_kernel`` replaces ``_state_kernel``: the
    same evolution, writes the final (re, im) state.
  * ``vqc_fused.cu`` ``fidelity_dmem_kernel`` and ``state_dmem_kernel``
    are the same two functions' device-memory route, for rows of 15 or
    more qubits, whose state no block's shared memory holds: the state in
    device memory, the op table in passes over 64 KB chunks of it
    (``dmem_plan``), one thread-block cluster per circuit
    (``_fidelity_dmem_cuda``, ``_state_dmem_cuda``).
  * ``vqc_shiftbank.cu`` ``shiftbank_kernel`` replaces ``_shiftbank_kernel``
    (the single-sweep branch of ``vqc_shift_fidelity``): prefix reuse on
    the two m-qubit registers of the SWAP-test product structure.
  * ``vqc_spill.cu`` ``shift_forward_kernel`` and ``shift_tile_kernel``
    replace ``_shift_forward_kernel`` and ``_shift_tile_kernel`` (the
    spilled branch): when the checkpoints do not fit one block's shared
    memory, the forward pass writes one boundary prefix state per depth
    tile to device memory and one backward launch sweeps every tile.
  * ``vqc_shift_dmem.cu`` ``shift_dmem_kernel`` is the spilled branch's
    device-memory route, for registers of 13 qubits and more, where not
    one sample of the tile kernel fits a block: the walk in passes over
    64 KB chunks (``_shift_dmem_walk``), one block a sample
    (``_shift_dmem_cuda``) holding three chunks, its checkpoints in device
    memory (at m = 13 chi stays in shared memory and the checkpoints move
    by TMA bulk copies on the staging plan, ``_shift_dmem_stage``).

Design, shared by all five:

  * The spec is data: ``spec.ops`` (or the shift plan) becomes an int32
    table of ``(gate, q0, q1, q2, param_kind, param_idx)`` rows plus a
    float32 column of constant angles, cached on the device per spec, so
    one build serves every circuit.
  * One warp owns one circuit (or sample).  Its state is the warp's slice
    of shared memory; each gate is one pass of the 32 lanes over its
    amplitude pairs, ended by ``__syncwarp``, and inner products end in a
    warp reduction.  Blocks hold a few warps, so a batch of hundreds of
    circuits spreads over every SM.  The shift-walk kernels (shift bank,
    spill forward and tile) stage the plan tables in shared memory once
    per block and share the walk (``ShiftWalk`` in ``statevector.cuh``).
  * What bounds them on an H100: per circuit the kernels read (P + D)
    angle floats and write one float per requested row (the state kernel
    its 2**n amplitudes), so device memory is rarely the limit; the
    float32 arithmetic of the gate applications is (``chip_smoke.py``
    computes both bounds per launch).  In practice each gate is a
    read-modify-write pass over the state in shared memory and a sample's
    gates are a chain of dependent steps, so latency dominates.  The design
    keeps the state out of device memory and leaves tensor-core
    formulations to later work.

Lane independence: each circuit's result depends only on its own angles,
never on its position or the batch around it (the multibank per-lane bit
identity depends on this).  Every kernel evaluates a gate with the same
arithmetic, rounding included (``rot1``/``rot2`` in ``statevector.cuh``),
so a spilled sample's checkpoints, re-derived by the tile kernel from a
boundary the forward kernel wrote, do not depend on where its depth tiles
start, and the single sweep and the spill pair give the same bits.  On the
CPU every wrapper takes the plain PyTorch version beside its kernel; on a
CUDA tensor it launches the kernel through the runtime (``_build.launch``)
or raises.

The host half (``ShiftPlan`` .. ``multibank_stats``) is the reference's,
with the TPU tile policy (``LANES = 128``, ``kernel_tb``, a 14 MB VMEM
budget) replaced by one Hopper memory model of 227 KB a block: each kernel
takes its launch geometry from one function (``fused_geometry`` for the
fidelity and state kernels, ``shift_geometry`` for the single sweep,
``forward_geometry`` and ``spill_tiling`` for the spill pair,
``shift_dmem_geometry`` for the shift walk's device-memory route), and
``_shift_route`` picks single sweep, spill pair or device-memory walk from
those launches' blocks (``SWEEP_MIN_WARPS``); the kernel wrappers,
``shift_execution_info`` and the launch observer all read them.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.shift_rule import shift_values
from repro_torch.core.sim import CircuitSpec
from repro_torch.kernels._build import launch, launch_counts, on_device, ptr, sm_count

# ------------------------------------------------------------ tile policy
#: a warp: multibank lane segments pad to it, and it is the reference's
#: default block for ``plan_depth_tiles``.
LANES = 32
#: dynamic shared memory one block may use on an H100 (227 KB of the SM's
#: 256 KB; above 48 KB only after cudaFuncSetAttribute, done per launch).
SMEM_BUDGET_BYTES = 227 * 1024
#: live non-checkpoint states the reference's single-sweep kernel holds;
#: ``plan_depth_tiles`` (the reference's) reserves this many out of the
#: budget it is given.
_RESERVED_STATES = 4
#: live non-checkpoint states a sample of the shift walk holds, in the
#: single sweep and in the spill tile kernel alike: the running state (the
#: tile kernel loads each tile's boundary into it, when the tile starts:
#: no prefetch), chi (the single sweep computes the data state into it) and
#: one shifted variant.
_WALK_STATES = 3
#: the spill forward kernel's states: the data state and the running state.
_FORWARD_STATES = 2

#: warps (= circuits) per block of the fidelity and state kernels where the
#: states fit and the batch fills a block (``fused_geometry``).
FUSED_WARPS = 8
#: samples (warps) per block of the single-sweep shift kernel where the
#: checkpoints fit (``shift_geometry``).
SHIFT_WARPS = 4
#: samples (warps) per block of the spill forward and tile kernels where
#: the states fit (``forward_geometry``, ``spill_tiling``).
SPILL_LAUNCH_WARPS = 4
#: the single sweep is taken when a block of at least this many samples
#: holds its checkpoints, else the spill pair where it fits
#: (``_shift_route``).  Timed on an H100 at B = 576 (PERF.md): where both
#: block 4 samples the sweep wins by the forward launch (13q-3l, 15q-3l,
#: 17q-1l); a sweep block of 2 against the pair's 4 lost at 17q-3l
#: (0.337 / 0.294 ms) and tied at 19q-1l (0.226 / 0.232), one of 1 lost
#: at 19q-3l (0.987 / 0.578).
SWEEP_MIN_WARPS = 4

#: threads a block of the device-memory route (``dmem_geometry``: a
#: cluster of blocks per circuit, each block taking its share of a pass's
#: chunks).  The kernels are bounded at 1,024 threads (at most 64 registers
#: a thread), so 512 fits two blocks an SM.
DMEM_THREADS = 512
#: local qubits of a device-memory chunk (``dmem_plan``): 2**13 (re, im)
#: float32 amplitudes, 64 KB of a block's shared memory.
DMEM_LOCAL_QUBITS = 13
#: lowest-order qubits every pass keeps local: 2**3 float32 amplitudes are
#: one 32-byte sector, so a chunk's loads and stores cover whole sectors.
DMEM_SECTOR_QUBITS = 3
#: the largest thread-block cluster of the device-memory route (the
#: portable cluster size on Hopper).
DMEM_MAX_CLUSTER = 8
#: device memory the fidelity kernel's device-memory route holds for its
#: circuits' states at once: a batch runs in chunks of at most this many
#: bytes of states (a chunk of one circuit where one state is larger).
#: Chunks small enough for the 50 MB L2 were slower on an H100 (PERF.md:
#: 32 states of 17q, 1.9x the time of one launch of 256), since a chunk
#: of k circuits keeps only k SMs busy.
DMEM_WORKSPACE_BYTES = 1 << 30

#: kernel launches per wrapper; counted only where a CUDA kernel launches
#: (``fidelity_dmem`` / ``state_dmem``: the device-memory route of the
#: fidelity and state kernels; ``shift_dmem``: the shift walk's;
#: ``dense_grad`` and ``dense_reduce``: the dense layer's register kernel,
#: ``dense_grad.py``, and the reduction of its partials; ``dense_wide_psi``
#: and ``dense_wide``: the wide route's psi build and kernel, whose partials
#: ``dense_reduce`` sums too).  ``launch`` counts them under the runtime's lock.
LAUNCHES = launch_counts("fidelity", "state", "shiftbank", "shift_forward", "shift_tile",
                         "fidelity_dmem", "state_dmem", "shift_dmem", "dense_grad",
                         "dense_reduce", "dense_wide_psi", "dense_wide")


def _state_bytes(m: int, tb: int) -> int:
    """Bytes of one (re, im) m-qubit state for ``tb`` circuits."""
    return 2 * 4 * (2**m) * tb


def _warp_block(cap: int, sample_bytes: int, fixed_bytes: int, smem_budget: int):
    """(warps, shared-memory bytes) of a one-warp-per-sample block: the
    largest power of two up to ``cap`` whose ``sample_bytes`` each, plus
    ``fixed_bytes``, fit ``smem_budget``; (0, 0) when not even one fits."""
    w = cap
    while w >= 1 and fixed_bytes + w * sample_bytes > smem_budget:
        w //= 2
    return (w, fixed_bytes + w * sample_bytes) if w else (0, 0)


def fused_geometry(
    n: int, c: int, smem_budget: int = SMEM_BUDGET_BYTES
) -> tuple[int, int]:
    """(warps per block, shared-memory bytes) of the fidelity and state
    kernels for a batch of ``c`` circuits of ``n`` qubits: one warp per
    circuit, the largest power of two up to FUSED_WARPS whose states fit
    ``smem_budget``, shrunk to the batch's power-of-two envelope.  (0, 0)
    when not even one circuit's state fits (from n = 15 at 227 KB): such
    batches take the device-memory route (``_fidelity_dmem_cuda``,
    ``_state_dmem_cuda``).  The only source of those kernels' launch
    geometry and route: ``_fidelity_cuda``, ``_state_cuda``, the
    materialize branch of ``shift_execution_info`` and the serving layer's
    per-block memory model read it."""
    w, _ = _warp_block(FUSED_WARPS, _state_bytes(n, 1), 0, smem_budget)
    w = min(w, 1 << (max(c, 1) - 1).bit_length())
    return w, _state_bytes(n, w)


# ----------------------------------------------------------- gate micro-ops
# Plain PyTorch transcription of the reference's structured micro-ops: each
# helper works on (re, im) tensors of shape (2**n, TB) and per-lane angle
# vectors of shape (TB,).  Qubit q is the q-th MOST significant bit of the
# basis (row) index, matching repro_torch.core.sim.


def _split1(x, q: int, n: int):
    """-> (x0, x1) halves along qubit q's bit; each (2**q, 2**(n-q-1), TB)."""
    t = x.reshape(2**q, 2, 2 ** (n - q - 1), x.shape[-1])
    return t[:, 0], t[:, 1]


def _merge1(x0, x1, n: int):
    return torch.stack([x0, x1], dim=1).reshape(2**n, x0.shape[-1])


def _rot1(re, im, q, n, c, s, kind):
    """Apply RX/RY/RZ with per-lane cos/sin (c, s) on qubit q."""
    r0, r1 = _split1(re, q, n)
    i0, i1 = _split1(im, q, n)
    if kind == "ry":  # [[c,-s],[s,c]] real
        nr0, ni0 = c * r0 - s * r1, c * i0 - s * i1
        nr1, ni1 = s * r0 + c * r1, s * i0 + c * i1
    elif kind == "rx":  # [[c,-is],[-is,c]]
        nr0, ni0 = c * r0 + s * i1, c * i0 - s * r1
        nr1, ni1 = c * r1 + s * i0, c * i1 - s * r0
    elif kind == "rz":  # diag(e^{-it/2}, e^{it/2})
        nr0, ni0 = c * r0 + s * i0, c * i0 - s * r0
        nr1, ni1 = c * r1 - s * i1, c * i1 + s * r1
    else:
        raise ValueError(kind)
    return _merge1(nr0, nr1, n), _merge1(ni0, ni1, n)


def _split2(x, qa, qb, n):
    """-> 2x2 blocks b[ba][bb] over qubits qa < qb."""
    t = x.reshape(2**qa, 2, 2 ** (qb - qa - 1), 2, 2 ** (n - qb - 1), x.shape[-1])
    return ((t[:, 0, :, 0], t[:, 0, :, 1]), (t[:, 1, :, 0], t[:, 1, :, 1]))


def _merge2(b, n):
    t = torch.stack(
        [torch.stack([b[0][0], b[0][1]], dim=2), torch.stack([b[1][0], b[1][1]], dim=2)],
        dim=1,
    )
    return t.reshape(2**n, b[0][0].shape[-1])


def _rot2(re, im, qa, qb, n, c, s, kind):
    """RYY / RZZ / CRY / CRZ with per-lane (c, s); qa < qb required."""
    R = _split2(re, qa, qb, n)
    I = _split2(im, qa, qb, n)  # noqa: E741
    r00, r01, r10, r11 = R[0][0], R[0][1], R[1][0], R[1][1]
    i00, i01, i10, i11 = I[0][0], I[0][1], I[1][0], I[1][1]
    if kind == "rzz":  # e^{-it/2} on |00>,|11>; e^{+it/2} on |01>,|10>
        nr00, ni00 = c * r00 + s * i00, c * i00 - s * r00
        nr11, ni11 = c * r11 + s * i11, c * i11 - s * r11
        nr01, ni01 = c * r01 - s * i01, c * i01 + s * r01
        nr10, ni10 = c * r10 - s * i10, c * i10 + s * r10
    elif kind == "ryy":  # couples (00,11) with +i s, (01,10) with -i s
        nr00, ni00 = c * r00 - s * i11, c * i00 + s * r11
        nr11, ni11 = c * r11 - s * i00, c * i11 + s * r00
        nr01, ni01 = c * r01 + s * i10, c * i01 - s * r10
        nr10, ni10 = c * r10 + s * i01, c * i10 - s * r01
    elif kind == "cry":  # RY on qb within qa=1 block
        nr00, ni00, nr01, ni01 = r00, i00, r01, i01
        nr10, ni10 = c * r10 - s * r11, c * i10 - s * i11
        nr11, ni11 = s * r10 + c * r11, s * i10 + c * i11
    elif kind == "crz":  # RZ on qb within qa=1 block
        nr00, ni00, nr01, ni01 = r00, i00, r01, i01
        nr10, ni10 = c * r10 + s * i10, c * i10 - s * r10
        nr11, ni11 = c * r11 - s * i11, c * i11 + s * r11
    else:
        raise ValueError(kind)
    return (
        _merge2(((nr00, nr01), (nr10, nr11)), n),
        _merge2(((ni00, ni01), (ni10, ni11)), n),
    )


def _h(re, im, q, n):
    inv = 0.7071067811865476
    r0, r1 = _split1(re, q, n)
    i0, i1 = _split1(im, q, n)
    return (
        _merge1((r0 + r1) * inv, (r0 - r1) * inv, n),
        _merge1((i0 + i1) * inv, (i0 - i1) * inv, n),
    )


def _cswap(re, im, qa, qb, qc_, n):
    """Fredkin: control qa, swap qb<->qc_ (qa < qb < qc_)."""
    outs = []
    for x in (re, im):
        t = x.reshape(
            2**qa, 2, 2 ** (qb - qa - 1), 2, 2 ** (qc_ - qb - 1), 2,
            2 ** (n - qc_ - 1), x.shape[-1],
        ).clone()
        # within control=1 block, swap the (qb, qc_) bit pair (0,1)<->(1,0)
        a01 = t[:, 1, :, 0, :, 1].clone()
        t[:, 1, :, 0, :, 1] = t[:, 1, :, 1, :, 0]
        t[:, 1, :, 1, :, 0] = a01
        outs.append(t.reshape(2**n, x.shape[-1]))
    return outs[0], outs[1]


def op_angle(op, theta_t, data_t, delta: float = 0.0):
    """Per-lane angle vector for a parameterized op (+ static shift delta)."""
    kind, j = op.param
    if kind == "theta":
        ang = theta_t[j]
    elif kind == "data":
        ang = data_t[j]
    elif kind == "const":
        ang = torch.tensor(j, dtype=torch.float32, device=theta_t.device)
    else:
        raise ValueError(op.param)
    return ang + delta if delta else ang


def apply_cs(op, re, im, n, c, s):
    """Apply one gate given the per-lane cos / sin of its half angle
    (ignored by H and CSWAP, which are self-inverse)."""
    if op.gate == "h":
        return _h(re, im, op.qubits[0], n)
    if op.gate == "cswap":
        return _cswap(re, im, *op.qubits, n)
    if op.gate in ("rx", "ry", "rz"):
        return _rot1(re, im, op.qubits[0], n, c, s, op.gate)
    qa, qb = sorted(op.qubits)  # op_row rejected descending cry/crz
    return _rot2(re, im, qa, qb, n, c, s, op.gate)


def apply_one(op, re, im, n, theta_t, data_t, delta: float = 0.0, invert: bool = False):
    """Apply one gate (optionally angle-shifted by ``delta`` or inverted).
    ``theta_t`` / ``data_t`` are (P, TB) / (D, TB) angle blocks."""
    if op.gate in ("h", "cswap"):
        return apply_cs(op, re, im, n, None, None)
    ang = op_angle(op, theta_t, data_t, delta)
    if invert:  # rotation: g(t)^dagger = g(-t)
        ang = -ang
    return apply_cs(op, re, im, n, torch.cos(ang / 2), torch.sin(ang / 2))


def zero_tile(dim: int, tb: int, device):
    re = torch.zeros((dim, tb), dtype=torch.float32, device=device)
    re[0] = 1.0
    return re, torch.zeros((dim, tb), dtype=torch.float32, device=device)


def _rowsum(x):
    """Sum over the amplitude rows in a fixed sequential order, so a lane's
    result never depends on how a reduction is split across the batch."""
    acc = x[0]
    for a in range(1, x.shape[0]):
        acc = acc + x[a]
    return acc


def _halving_sum(x):
    """Sum over the amplitude rows of ``x`` (2**k, B) in float64 by halves,
    rounded once: elementwise, so no lane depends on the batch."""
    acc = x.double()
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = acc[:h] + acc[h:]
    return acc[0].float()


def _inner_fidelity(chi, phi):
    """|<chi|phi>|^2 per lane; chi/phi are (re, im) pairs of (dim, TB)."""
    cre, cim = chi
    pre, pim = phi
    ip_re = _rowsum(cre * pre + cim * pim)
    ip_im = _rowsum(cre * pim - cim * pre)
    return ip_re * ip_re + ip_im * ip_im


# ------------------------------------------------------------- op tables
_GATE_CODE = {"h": 0, "cswap": 1, "rx": 2, "ry": 3, "rz": 4,
              "ryy": 5, "rzz": 6, "cry": 7, "crz": 8}
_PARAM_CODE = {"theta": 1, "data": 2, "const": 3}


def op_row(op) -> tuple[list[int], float]:
    """One op -> its kernel-table row ``[gate, q0, q1, q2, kind, idx]`` and
    constant angle.  Rejects, before any launch, exactly what the
    reference's ``_apply_one`` cannot run: x and swap, descending cry/crz
    (descending ryy/rzz are symmetric and swapped to ascending), and a
    CSWAP whose qubits are not ascending."""
    if op.gate not in _GATE_CODE:
        raise NotImplementedError(op.gate)
    qs = list(op.qubits)
    if op.gate in ("ryy", "rzz", "cry", "crz") and qs[0] > qs[1]:
        if op.gate in ("cry", "crz"):
            raise NotImplementedError(
                f"{op.gate} requires ascending (control, target) qubits"
            )
        qs.reverse()
    if op.gate == "cswap" and not qs[0] < qs[1] < qs[2]:
        raise NotImplementedError("cswap requires ascending qubits")
    kind, idx, const = 0, 0, 0.0
    if op.param is not None:
        if op.param[0] not in _PARAM_CODE:
            raise ValueError(op.param)
        kind = _PARAM_CODE[op.param[0]]
        if op.param[0] == "const":
            const = float(op.param[1])
        else:
            idx = int(op.param[1])
    return [_GATE_CODE[op.gate], *qs, *[0] * (3 - len(qs)), kind, idx], const


def ops_table(ops) -> tuple[np.ndarray, np.ndarray]:
    rows = [op_row(op) for op in ops]
    ints = np.array([r for r, _ in rows], np.int32).reshape(-1, 6)
    return ints, np.array([c for _, c in rows], np.float32)


@functools.lru_cache(maxsize=None)
def _spec_table(spec: CircuitSpec):
    return ops_table(spec.ops)


def _prepare(spec: CircuitSpec, theta, data):
    """Validate a (C, P) / (C, D) batch and return float32 contiguous copies
    plus the device kind that decides the path ("cpu" -> plain version)."""
    if theta.dim() != 2 or data.dim() != 2 or theta.shape[0] != data.shape[0]:
        raise ValueError(
            f"expected theta (C, P) and data (C, D), got {tuple(theta.shape)} "
            f"and {tuple(data.shape)}"
        )
    if theta.shape[1] < spec.n_theta or data.shape[1] < spec.n_data:
        raise ValueError(
            f"spec needs {spec.n_theta} theta and {spec.n_data} data angles, "
            f"got {theta.shape[1]} and {data.shape[1]}"
        )
    if theta.device != data.device:
        raise ValueError(f"theta on {theta.device} but data on {data.device}")
    kind = theta.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no statevector kernel for device {theta.device}")
    return theta.to(torch.float32).contiguous(), data.to(torch.float32).contiguous(), kind


# ------------------------------------------- kernels 1 and 2: full circuits
def _fused_plain(spec: CircuitSpec, theta, data, want_state: bool):
    """Plain version of ``fidelity_kernel`` and ``state_kernel``: the whole
    circuit on a (2**n, C) tile.  Returns P0 (C,) or the final state
    (re, im), each (C, 2**n)."""
    n = spec.n_qubits
    re, im = zero_tile(2**n, theta.shape[0], theta.device)
    th, dt = theta.T, data.T
    for op in spec.ops:
        re, im = apply_one(op, re, im, n, th, dt)
    if want_state:
        return re.T.contiguous(), im.T.contiguous()
    half = 2 ** (n - 1)
    probs = re[:half] * re[:half] + im[:half] * im[:half]
    if fused_geometry(n, 1)[0]:
        return _rowsum(probs)
    # from 15 qubits (the device-memory route) one sequential float32 sum
    # over 2**14 or more amplitudes drifts by up to 1.6e-5, so sum in
    # float64 by halves and round once: the value the kernel's reduction is
    # held to.
    return _halving_sum(probs)


def _fidelity_cuda(spec: CircuitSpec, theta, data):
    c, n = theta.shape[0], spec.n_qubits
    warps, smem = fused_geometry(n, c)
    if warps == 0:
        return _fidelity_dmem_cuda(spec, theta, data)
    dev = theta.device
    ops_i, ops_f = on_device(spec, _spec_table(spec), dev)
    p0 = torch.empty((c,), dtype=torch.float32, device=dev)
    if c:
        launch("vqc_fused", "vqc_fidelity_launch", "fidelity", dev,
               ptr(theta), ptr(data), c, theta.shape[1], data.shape[1],
               ptr(ops_i), ptr(ops_f), len(spec.ops), n, ptr(p0), warps, smem,
               count="fidelity")
    return p0


def _state_cuda(spec: CircuitSpec, theta, data):
    c, n = theta.shape[0], spec.n_qubits
    warps, smem = fused_geometry(n, c)
    if warps == 0:
        return _state_dmem_cuda(spec, theta, data)
    dev = theta.device
    ops_i, ops_f = on_device(spec, _spec_table(spec), dev)
    re = torch.empty((c, 2**n), dtype=torch.float32, device=dev)
    im = torch.empty((c, 2**n), dtype=torch.float32, device=dev)
    if c:
        launch("vqc_fused", "vqc_state_launch", "state", dev,
               ptr(theta), ptr(data), c, theta.shape[1], data.shape[1],
               ptr(ops_i), ptr(ops_f), len(spec.ops), n, ptr(re), ptr(im), warps, smem,
               count="state")
    return re, im


# ------------------------------------ kernels 1 and 2: device-memory route
# From 15 qubits no block holds a circuit's state: it lives in device memory
# and the op table runs in passes (``dmem_plan``).  A pass's gates act on at
# most k local qubits, so the state splits into 2**(n - k) chunks of 2**k
# amplitudes (the local bits vary, the others are fixed); a block loads a
# chunk into shared memory, applies the pass's gates one after another with
# the per-gate arithmetic (``strided_apply``, as the warp kernels), and
# stores it back.  Amplitudes that no earlier pass had local are still 0:
# the first pass makes |0...0> in shared memory, and no pass reads such an
# amplitude or touches a chunk made only of them (the zero masks of
# ``_dmem_tables``).  ``_dmem_plain`` runs the same tables on the CPU.


@dataclasses.dataclass(frozen=True)
class DmemPass:
    """Ops [lo, hi) of the op table on the local qubits ``qubits``
    (ascending)."""

    lo: int
    hi: int
    qubits: tuple[int, ...]


#: qubits an op-table row acts on, by gate code (H, CSWAP, RX, RY, RZ, RYY,
#: RZZ, CRY, CRZ)
_ARITY = (1, 3, 1, 1, 1, 2, 2, 2, 2)


def dmem_plan(spec: CircuitSpec, k: int = DMEM_LOCAL_QUBITS) -> tuple[DmemPass, ...]:
    """The op table cut, in program order, into passes of at most k local
    qubits (k capped at n): a pass takes ops while their qubits and the
    DMEM_SECTOR_QUBITS lowest-order qubits fit k, then is padded to k with
    the lowest-order qubits it lacks, so a chunk's loads and stores cover
    whole 32-byte sectors.  At 17q-1l and k = 13: 3 passes (42 ops), where
    the per-gate scheme made 42."""
    n = spec.n_qubits
    k = min(k, n)
    if k < n and k < DMEM_SECTOR_QUBITS + 3:
        raise ValueError(f"k = {k}: a pass needs room for {DMEM_SECTOR_QUBITS} sector "
                         "qubits and a three-qubit gate")
    low = set(range(n - min(DMEM_SECTOR_QUBITS, k), n))

    def padded(qs: set) -> tuple[int, ...]:
        for q in range(n - 1, -1, -1):
            if len(qs) == k:
                break
            qs.add(q)
        return tuple(sorted(qs))

    passes, lo, held = [], 0, set(low)
    for i, op in enumerate(spec.ops):
        need = held | set(op.qubits)
        if len(need) > k:
            passes.append(DmemPass(lo, i, padded(held)))
            lo, need = i, low | set(op.qubits)
        held = need
    passes.append(DmemPass(lo, len(spec.ops), padded(held)))
    return tuple(passes)


def _halves(x: int) -> tuple[int, int]:
    return x & 0xFFFFFFFF, x >> 32


def _mask(row, at: int) -> int:
    """A 64-bit mask from its (low, high) 32-bit halves at ``row[at:at + 2]``."""
    return (int(row[at]) & 0xFFFFFFFF) | (int(row[at + 1]) & 0xFFFFFFFF) << 32


@functools.lru_cache(maxsize=None)
def _dmem_tables(spec: CircuitSpec, k: int = DMEM_LOCAL_QUBITS):
    """The device-memory kernels' tables: (pass rows (P, 6) int32 of op lo,
    op hi, local mask and zero mask, each mask as its (low, high) 32-bit
    halves; the op table with each op's qubits replaced by their rank among
    its pass's local qubits, as a kernel applies it to a chunk; the constant
    angles).  Masks are over amplitude-index bits (qubit q is bit n - 1 -
    q).  A pass's zero mask holds the bits no earlier pass had local (every
    bit for the first): an amplitude with one of them set is still 0."""
    n = spec.n_qubits
    ints, consts = _spec_table(spec)
    local_ops = ints.copy()
    rows, reached = [], 0
    for p in dmem_plan(spec, k):
        rank = {q: i for i, q in enumerate(p.qubits)}
        for r in range(p.lo, p.hi):
            a = _ARITY[int(ints[r, 0])]
            local_ops[r, 1:1 + a] = [rank[int(q)] for q in ints[r, 1:1 + a]]
        local = sum(1 << (n - 1 - q) for q in p.qubits)
        rows.append([p.lo, p.hi, *_halves(local), *_halves(((1 << n) - 1) & ~reached)])
        reached |= local
    table = np.array(rows, np.int64).astype(np.uint32).view(np.int32).reshape(-1, 6)
    return table, local_ops, consts


def _chunk_offsets(n: int, local: int) -> np.ndarray:
    """Amplitude index of each local index 0 .. 2**k - 1 of a chunk with
    its fixed bits at 0: local bit j is the j-th lowest bit of ``local``."""
    bits = [b for b in range(n) if local >> b & 1]
    lidx = np.arange(1 << len(bits), dtype=np.int64)
    out = np.zeros_like(lidx)
    for j, b in enumerate(bits):
        out |= (lidx >> j & 1) << b
    return out


def _chunk_bases(n: int, local: int) -> np.ndarray:
    """The fixed bits of each chunk, in chunk order: chunk ch's bit j is
    the j-th lowest bit outside ``local``."""
    return _chunk_offsets(n, ((1 << n) - 1) & ~local)


def _dmem_chunks(spec: CircuitSpec, k: int, want_state: bool):
    """Per pass: (pass row, chunk bases, chunk offsets, live chunks, last),
    where a live chunk is one the kernel loads and computes: not under the
    zero mask and, in the fidelity's last pass, with the ancilla (the most
    significant bit) at 0 (the ancilla-1 half adds nothing to P(0))."""
    n = spec.n_qubits
    rows = _dmem_tables(spec, k)[0]
    for p, row in enumerate(rows):
        local, zero = _mask(row, 2), _mask(row, 4)
        bases, offs = _chunk_bases(n, local), _chunk_offsets(n, local)
        last = p == len(rows) - 1
        live = (bases & zero) == 0
        if last and not want_state:
            live &= (bases >> (n - 1) & 1) == 0
        yield row, bases, offs, live, last


def dmem_traffic_bytes(spec: CircuitSpec, want_state: bool,
                       k: int = DMEM_LOCAL_QUBITS) -> tuple[int, int]:
    """(passes, bytes of state one circuit moves through device memory on
    the device-memory route): each live chunk's loads (none in the first
    pass, none under the zero mask) and stores (none in the fidelity's last
    pass, which stores and reads one partial sum a chunk instead); the
    state's last pass also writes the zeros of the chunks it skips."""
    n_pass, total = 0, 0
    for row, _, offs, live, last in _dmem_chunks(spec, k, want_state):
        n_pass += 1
        zero, n_live = _mask(row, 4), int(live.sum())
        if n_pass > 1:
            total += 8 * n_live * int(((offs & zero) == 0).sum())
        if last and not want_state:
            total += 8 * n_live
        else:
            total += 8 * (live.size if last else n_live) * offs.size
    return n_pass, total


def _dmem_plain(spec: CircuitSpec, theta, data, want_state: bool,
                k: int = DMEM_LOCAL_QUBITS):
    """The device-memory kernels' order in plain PyTorch, for the CPU tests:
    the same tables, passes, chunks and zero masks, each pass's ops applied
    to a chunk as a k-qubit state with ``apply_one``'s arithmetic.  Its
    state equals ``_fused_plain``'s (each amplitude meets the same gates in
    the same order; a skipped chunk holds zeros); P0 sums in float64."""
    n, c = spec.n_qubits, theta.shape[0]
    _, local_ops, _ = _dmem_tables(spec, k)
    # device memory: NaN where nothing was written, so a read of it shows
    re = torch.full((2**n, c), float("nan"), dtype=torch.float32)
    im = torch.full((2**n, c), float("nan"), dtype=torch.float32)
    p0 = torch.zeros(c, dtype=torch.float64)
    th, dt = theta.T, data.T
    for p, (row, bases, offs, live, last) in enumerate(_dmem_chunks(spec, k, want_state)):
        zero, kk = _mask(row, 4), int(offs.size).bit_length() - 1
        ops = [dataclasses.replace(
            spec.ops[r], qubits=tuple(int(q) for q in local_ops[r, 1:1 + len(spec.ops[r].qubits)]))
            for r in range(row[0], row[1])]
        keep = torch.from_numpy((offs & zero) == 0)[:, None]
        for base, is_live in zip(bases, live):
            idx = torch.from_numpy(base | offs)
            if not is_live:
                if last and want_state:
                    re[idx], im[idx] = 0.0, 0.0
                continue
            if p == 0:
                cre, cim = zero_tile(offs.size, c, theta.device)
            else:
                cre = torch.where(keep, re[idx], 0.0)
                cim = torch.where(keep, im[idx], 0.0)
            for op in ops:
                cre, cim = apply_one(op, cre, cim, kk, th, dt)
            if last and not want_state:
                anc0 = torch.from_numpy(((base | offs) >> (n - 1) & 1) == 0)
                p0 += (cre[anc0].double() ** 2 + cim[anc0].double() ** 2).sum(0)
            else:
                re[idx], im[idx] = cre, cim
    if want_state:
        return re.T.contiguous(), im.T.contiguous()
    return p0.float()


def dmem_max_qubits(device) -> int:
    """The widest circuit whose (re, im) float32 state fits the device
    memory of ``device``'s card: the device-memory route's limit."""
    total = torch.cuda.get_device_properties(device).total_memory
    return (total // _state_bytes(0, 1)).bit_length() - 1


def _require_card(n: int, device) -> None:
    limit = dmem_max_qubits(device)
    if n > limit:
        raise NotImplementedError(
            f"one circuit's state of {n} qubits ({_state_bytes(n, 1)} bytes) exceeds the "
            f"device memory of {torch.cuda.get_device_name(device)}: the device-memory "
            f"route runs up to {limit} qubits there"
        )


def _dmem_smem(spec: CircuitSpec, k: int = DMEM_LOCAL_QUBITS) -> int:
    """Shared memory of a device-memory block: a chunk's (re, im), every
    op's cos and sin (rounded up to 8 bytes), the chunk's two deposit
    tables (256 + 64 amplitude offsets of 8 bytes) and one partial sum a
    warp."""
    kk = min(k, spec.n_qubits)
    return 8 * 2**kk + 8 * len(spec.ops) + 8 * (256 + 64) + 4 * 32


def dmem_geometry(spec: CircuitSpec, c: int, sm_count: int,
                  k: int = DMEM_LOCAL_QUBITS) -> tuple[int, int]:
    """(blocks a circuit, shared-memory bytes) of a device-memory launch of
    ``c`` circuits: one thread-block cluster a circuit, its blocks taking a
    pass's chunks in turn, of the largest power of two up to
    DMEM_MAX_CLUSTER and to the chunks of a pass whose ``c`` clusters the
    card holds at once (``1024 // DMEM_THREADS`` blocks an SM, the
    kernels' register bound).  One block a circuit once the batch fills the
    card (C = 256 at 17 qubits); P(0) and the state do not depend on it."""
    per_sm = max(1, 1024 // DMEM_THREADS)
    chunks = 2 ** (spec.n_qubits - min(k, spec.n_qubits))
    cs = 1
    while (2 * cs <= min(DMEM_MAX_CLUSTER, chunks)
           and max(c, 1) * 2 * cs <= sm_count * per_sm):
        cs *= 2
    return cs, _dmem_smem(spec, k)


def _dmem_launch(spec: CircuitSpec, theta, data, want_state: bool, re, im, stride, p0):
    """One launch of ``fidelity_dmem_kernel`` or ``state_dmem_kernel`` over
    the rows of ``theta``: circuit c's state at re + c * stride (and im),
    its P(0) (fidelity) into p0[c].  The kernels move four amplitudes at a
    time, so a circuit needs 3 qubits at least (the route takes 15 and
    more)."""
    if spec.n_qubits < DMEM_SECTOR_QUBITS:
        raise NotImplementedError(f"the device-memory route needs {DMEM_SECTOR_QUBITS} "
                                  f"qubits or more, got {spec.n_qubits}")
    dev, c, k = theta.device, theta.shape[0], DMEM_LOCAL_QUBITS
    rows, local_ops, consts = _dmem_tables(spec, k)
    passes, ops_i, ops_f = on_device(("dmem", spec, k), (rows, local_ops, consts), dev)
    cs, smem = dmem_geometry(spec, c, sm_count(dev), k)
    launch("vqc_fused", "vqc_dmem_launch",
           f"device-memory {'state' if want_state else 'fidelity'}", dev,
           int(want_state), ptr(theta), ptr(data), c, theta.shape[1], data.shape[1],
           ptr(ops_i), ptr(ops_f), len(spec.ops), ptr(passes), len(rows), spec.n_qubits,
           min(k, spec.n_qubits), ptr(re), ptr(im), stride, ptr(p0), cs, DMEM_THREADS, smem,
           count="state_dmem" if want_state else "fidelity_dmem")


def _fidelity_dmem_cuda(spec: CircuitSpec, theta, data):
    """Launch ``fidelity_dmem_kernel`` (a cluster of blocks per circuit,
    its state in a device-memory workspace) over the batch in chunks whose
    states take at most DMEM_WORKSPACE_BYTES (one circuit a chunk where one
    state is larger): -> P0 (C,)."""
    c, n, dev = theta.shape[0], spec.n_qubits, theta.device
    _require_card(n, dev)
    p0 = torch.empty((c,), dtype=torch.float32, device=dev)
    if c:
        chunk = max(1, DMEM_WORKSPACE_BYTES // _state_bytes(n, 1))
        work = torch.empty((min(chunk, c), 2, 2**n), dtype=torch.float32, device=dev)
        for c0 in range(0, c, chunk):
            k = min(chunk, c - c0)
            _dmem_launch(spec, theta[c0:c0 + k], data[c0:c0 + k], False, work[:, 0],
                         work[:, 1], 2 * 2**n, p0[c0:])
    return p0


def _state_dmem_cuda(spec: CircuitSpec, theta, data):
    """Launch ``state_dmem_kernel``: a cluster of blocks per circuit, each
    evolving its state in its own rows of the output (re, im), each
    (C, 2**n)."""
    c, n, dev = theta.shape[0], spec.n_qubits, theta.device
    _require_card(n, dev)
    re = torch.empty((c, 2**n), dtype=torch.float32, device=dev)
    im = torch.empty((c, 2**n), dtype=torch.float32, device=dev)
    if c:
        _dmem_launch(spec, theta, data, True, re, im, 2**n, None)
    return re, im


def vqc_p0(spec: CircuitSpec, theta: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Batched ancilla-P0 for a circuit bank. theta: (C,P), data: (C,D) -> (C,).

    On the card, circuits whose state fits a block's shared memory (up to 14
    qubits, ``fused_geometry``) run one warp each; wider ones run one
    cluster of blocks each with the state in device memory (``dmem_plan``),
    at most DMEM_WORKSPACE_BYTES (1 GiB) of states at a time, up to the
    widest state the card holds (``dmem_max_qubits``: 33 qubits on an 80 GB
    card)."""
    _spec_table(spec)  # rejects unsupported gates on every device
    theta, data, kind = _prepare(spec, theta, data)
    if kind == "cpu":
        return _fused_plain(spec, theta, data, want_state=False)
    return _fidelity_cuda(spec, theta, data)


def vqc_state(spec: CircuitSpec, theta: torch.Tensor, data: torch.Tensor):
    """Batched final statevector (re, im), each (C, 2**n).  Routes as
    ``vqc_p0``; on the device-memory route each circuit evolves in its own
    output rows, so the output is the whole workspace."""
    _spec_table(spec)
    theta, data, kind = _prepare(spec, theta, data)
    if kind == "cpu":
        return _fused_plain(spec, theta, data, want_state=True)
    return _state_cuda(spec, theta, data)


# ----------------------------------------------- shift-structured execution
#
# The parameter-shift bank's (1 + 2P) * B rows differ from the B base rows
# by exactly ONE angle each.  For the QuClassi circuit family — encoding on
# the data register, the variational stack on the trainable register, then
# the SWAP-test tail — fidelity = |<psi_d|psi_t>|^2, so the shift kernel
# evolves the two 2**m-dim register states instead of the full state:
#
#   1. data register: ONE pass (theta-independent, shared by every variant);
#   2. trainable register FORWARD pass with base angles, checkpointing the
#      prefix state just before each anchored parameter's FIRST gate;
#   3. BACKWARD pass holding chi_k = (U_suffix_k)^dagger psi_d: a variant of
#      parameter j replays its [first, last] span from the checkpoint with
#      the shift added to each of its gates, then takes |<chi|psi>|^2.
#
# Circuits without that structure return ``None`` from ``build_shift_plan``;
# plans whose replay cost exceeds the materialized bank's route to the
# materialized path (``use_shift_plan``, priced by ``shift_cost_info``).

ROT_GATES = ("rx", "ry", "rz", "ryy", "rzz", "cry", "crz")


@dataclasses.dataclass(frozen=True)
class ShiftPlan:
    """Static execution plan for the prefix-reuse shift kernel.

    ``data_ops`` / ``train_ops`` are the body ops remapped to register-local
    qubit indices (register width ``m``); ``theta_positions[j]`` is the
    ascending tuple of indices into ``train_ops`` of parameter j's dependent
    gates — empty when the parameter drives no gate, length > 1 for
    multi-use parameters (executed by suffix replay over [first, last]).
    """

    m: int
    data_ops: tuple
    train_ops: tuple
    theta_positions: tuple[tuple[int, ...], ...]

    def replay_depth(self, j: int) -> int:
        """Gates a shift variant of parameter j replays from its checkpoint."""
        ps = self.theta_positions[j]
        return (ps[-1] - ps[0] + 1) if ps else 0


def _remap_op(op, mapping):
    return dataclasses.replace(op, qubits=tuple(mapping[q] for q in op.qubits))


@functools.lru_cache(maxsize=None)
def build_shift_plan(spec: CircuitSpec) -> ShiftPlan | None:
    """Verify the SWAP-test product structure; None -> caller must fall back."""
    ops = spec.ops
    # --- tail: H(anc), m CSWAP(anc, d_i, t_i), H(anc)
    if len(ops) < 3 or ops[-1].gate != "h":
        return None
    anc = ops[-1].qubits[0]
    k = len(ops) - 2
    pairs = []
    while k >= 0 and ops[k].gate == "cswap":
        a, d, t = ops[k].qubits
        if a != anc:
            return None
        pairs.append((d, t))
        k -= 1
    if k < 0 or ops[k].gate != "h" or ops[k].qubits != (anc,) or not pairs:
        return None
    pairs.reverse()
    data_q = [d for d, _ in pairs]
    train_q = [t for _, t in pairs]
    m = len(pairs)
    regs = set(data_q) | set(train_q) | {anc}
    if len(regs) != 2 * m + 1 or regs != set(range(spec.n_qubits)):
        return None
    data_map = {q: i for i, q in enumerate(data_q)}
    train_map = {q: i for i, q in enumerate(train_q)}

    # --- body: every op entirely inside one register; theta only on train
    data_ops, train_ops = [], []
    theta_pos: dict[int, list[int]] = {}
    for op in ops[:k]:
        qs = set(op.qubits)
        is_theta = op.param is not None and op.param[0] == "theta"
        if qs <= set(data_q):
            if is_theta or op.gate == "cswap":
                return None
            data_ops.append(_remap_op(op, data_map))
        elif qs <= set(train_q):
            if op.gate == "cswap":
                return None
            if is_theta:
                j = op.param[1]
                if op.gate not in ROT_GATES:
                    return None  # no shift rule for non-rotation theta gates
                theta_pos.setdefault(j, []).append(len(train_ops))
            train_ops.append(_remap_op(op, train_map))
        else:
            return None  # op straddles registers / touches ancilla
    # descending cry/crz cannot run; reject here instead of at launch
    for op in data_ops + train_ops:
        if op.gate in ("cry", "crz") and op.qubits[0] > op.qubits[1]:
            return None
    pos = tuple(tuple(theta_pos.get(j, ())) for j in range(spec.n_theta))
    return ShiftPlan(
        m=m,
        data_ops=tuple(data_ops),
        train_ops=tuple(train_ops),
        theta_positions=pos,
    )


def _collect_variants(plan: ShiftPlan, shifts, groups, n_params: int):
    """Map ANCHOR train-op position -> [(group, param, shift)].

    A variant anchors at its parameter's LAST dependent gate; position -1
    collects groups whose parameter drives no gate (their shifted fidelity
    is the base fidelity)."""
    wanted = set(groups)
    variants = {}
    for s_idx, s in enumerate(shifts):
        for j in range(n_params):
            g = 1 + s_idx * n_params + j
            if g not in wanted:
                continue
            ps = plan.theta_positions[j]
            variants.setdefault(ps[-1] if ps else -1, []).append((g, j, s))
    return variants


def _replay_variant(plan: ShiftPlan, j: int, s: float, state, theta_t, data_t):
    """Suffix replay for one shift variant: parameter j's [first, last] span
    of train ops applied to its checkpoint, shift ``s`` on its own gates."""
    first, last = plan.theta_positions[j][0], plan.theta_positions[j][-1]
    re, im = state
    for k in range(first, last + 1):
        op = plan.train_ops[k]
        delta = s if op.param == ("theta", j) else 0.0
        re, im = apply_one(op, re, im, plan.m, theta_t, data_t, delta=delta)
    return re, im


def walk_smem_bytes(m: int, n_ckpt: int, tb: int) -> int:
    """Shared memory of the states of ``tb`` samples of the shift walk
    (the single sweep or the spill tile kernel) over an m-qubit register:
    ``n_ckpt`` checkpoints and ``_WALK_STATES`` live states each."""
    return (n_ckpt + _WALK_STATES) * _state_bytes(m, tb)


def _merge_spans(plan: ShiftPlan, positions):
    """Merge variant anchor positions into atomic (first, n_checkpoints)
    segments: each anchor drags its parameter's [first, last] replay span
    along, and overlapping spans fuse (a tile boundary inside a span would
    strand a replay's checkpoint in the previous tile)."""
    first_of = {ps[-1]: ps[0] for ps in plan.theta_positions if ps}
    segments: list[list] = []  # [lo, hi_anchor, {checkpoint positions}]
    for f, k in sorted((first_of.get(k, k), k) for k in positions):
        if segments and f <= segments[-1][1]:
            segments[-1][1] = max(segments[-1][1], k)
            segments[-1][2].add(f)
        else:
            segments.append([f, k, {f}])
    return [(seg[0], len(seg[2])) for seg in segments]


def plan_depth_tiles(
    plan: ShiftPlan, positions, tb: int = LANES, smem_budget: int = SMEM_BUDGET_BYTES
):
    """Cut variant anchor positions into depth tiles that fit the budget.

    Returns None when every checkpoint fits one sweep, else a tuple of
    (lo, hi) train-op ranges; ``tb`` samples each hold the checkpoints and
    ``_RESERVED_STATES`` live states.  The reference's, unchanged: the port
    plans the spill tile kernel's tiles with it (``spill_tiling``).
    Multi-use replay spans are atomic: a segment never straddles a tile
    boundary.
    """
    positions = sorted(positions)
    if not positions:
        return None
    cap = max(1, smem_budget // _state_bytes(plan.m, tb) - _RESERVED_STATES)
    segments = _merge_spans(plan, positions)
    if sum(n for _, n in segments) <= cap:
        return None
    chunks: list[list] = []
    cur, cur_n = [], 0
    for lo, n in segments:
        if cur and cur_n + n > cap:
            chunks.append(cur)
            cur, cur_n = [], 0
        cur.append((lo, n))
        cur_n += n
    if cur:
        chunks.append(cur)
    bounds = [c[0][0] for c in chunks] + [len(plan.train_ops)]
    return tuple(zip(bounds[:-1], bounds[1:]))


def plan_gate_apps(plan: ShiftPlan, shifts, groups, n_params: int) -> int:
    """Per-lane gate applications of the prefix-reuse execution for the
    requested groups: data pass + forward pass + backward walk down to the
    shallowest anchor + every variant's suffix replay."""
    variants = _collect_variants(plan, shifts, groups, n_params)
    anchors = [k for k in variants if k >= 0]
    total = len(plan.data_ops) + len(plan.train_ops)
    if not anchors:
        return total
    total += len(plan.train_ops) - min(anchors)
    for k in anchors:
        for _, j, _ in variants[k]:
            total += plan.replay_depth(j)
    return total


@functools.lru_cache(maxsize=None)
def shift_cost_info(
    spec: CircuitSpec,
    four_term: bool = False,
    groups: tuple[int, ...] | None = None,
) -> dict:
    """Analytic per-lane cost of executing the requested groups of a shift
    bank implicitly (prefix reuse + suffix replay) vs materialized (a
    full-circuit row per group).  The route is the bank's, not the
    request's: ``use_shift_plan``."""
    n_shifts = 4 if four_term else 2
    n_groups = 1 + n_shifts * spec.n_theta
    if groups is None:
        groups = tuple(range(n_groups))
    materialized = len(spec.ops) * len(groups)
    plan = build_shift_plan(spec)
    if plan is None:
        return {
            "gate_apps_implicit": None,
            "gate_apps_materialized": materialized,
            "replay_depth_max": 0,
        }
    shifts = tuple(float(s) for s in shift_values(four_term))
    implicit = plan_gate_apps(plan, shifts, groups, spec.n_theta)
    depth = max((plan.replay_depth(j) for j in range(spec.n_theta)), default=0)
    return {
        "gate_apps_implicit": implicit,
        "gate_apps_materialized": materialized,
        "replay_depth_max": depth,
    }


def use_shift_plan(spec: CircuitSpec, four_term: bool = False) -> bool:
    """True when the implicit prefix-reuse path analytically beats
    materializing the whole bank (requires a plan to exist).

    The route is decided per bank, never per request: the reference decides
    on the requested groups, so a request of one group (group 1 of 5q-1l:
    13 gate applications implicit, 12 materialized) ran on the fidelity
    kernel while the rest of its bank ran the prefix-reuse sweep, and the
    two round differently.  The serving layer coalesces any subset of a
    bank's groups into a launch, so a group's bits then depended on which
    groups shared its batch.  Decided here, every group of a bank takes one
    route, and ``vqc_fidelity_shiftgroups(..., groups)`` gives the rows of
    the whole bank's call bit for bit."""
    cost = shift_cost_info(spec, four_term)
    implicit = cost["gate_apps_implicit"]
    return implicit is not None and implicit < cost["gate_apps_materialized"]


def walk_table_bytes(plan: ShiftPlan, n_variants: int) -> int:
    """Shared memory of the plan tables the shift-walk kernels stage once
    per block (``_WalkTable``'s ints up to the variants' end and every
    float), rounded up to 32 words so the states after them start on
    bank 0."""
    n_data, n_train = len(plan.data_ops), len(plan.train_ops)
    ints = (n_data + n_train) * 6 + 2 * n_train + 5 * n_variants
    floats = n_data + n_train + n_variants
    return 4 * (-(-(ints + floats) // 32) * 32)


def shift_geometry(
    plan: ShiftPlan, n_ckpt: int, n_variants: int, smem_budget: int = SMEM_BUDGET_BYTES
) -> tuple[int, int]:
    """(samples per block, shared-memory bytes) of the single-sweep shift
    kernel for a plan whose requested variants (``n_variants`` rows) need
    ``n_ckpt`` checkpoints: one warp per sample, the largest power of two
    up to SHIFT_WARPS whose states fit ``smem_budget`` beside the staged
    tables; (0, 0) when not even one sample's fit.  The only source of that
    kernel's geometry: ``_shiftbank_cuda``, ``_shift_route`` and the fused
    branch of ``shift_execution_info`` read it (through ``_WalkTable``)."""
    return _warp_block(SHIFT_WARPS, walk_smem_bytes(plan.m, n_ckpt, 1),
                       walk_table_bytes(plan, n_variants), smem_budget)


def forward_geometry(
    plan: ShiftPlan, n_variants: int, smem_budget: int = SMEM_BUDGET_BYTES
) -> tuple[int, int]:
    """(samples per block, shared-memory bytes) of the spill forward
    kernel: one warp per sample, up to SPILL_LAUNCH_WARPS, each holding the
    data and running states beside the staged tables; (0, 0) when not even
    one sample's fit (from m = 14 at 227 KB).  Its only geometry source."""
    return _warp_block(SPILL_LAUNCH_WARPS, _FORWARD_STATES * _state_bytes(plan.m, 1),
                       walk_table_bytes(plan, n_variants), smem_budget)


@dataclasses.dataclass(frozen=True)
class SpillTiling:
    """Geometry of the spill tile kernel's launch: the (lo, hi) train-op
    depth tiles in ascending order, the checkpoints each tile holds, the
    samples (warps) a block and the shared memory a block asks for (the
    staged tables and ``tb`` samples' states for the fullest tile)."""

    tiles: tuple[tuple[int, int], ...]
    n_ckpt: tuple[int, ...]
    tb: int
    smem_bytes: int


def spill_tiling(
    plan: ShiftPlan, positions, n_variants: int, smem_budget: int = SMEM_BUDGET_BYTES
):
    """The spill tile kernel's launch block and depth tiles for the variant
    anchor ``positions`` (``n_variants`` variant rows): blocks of
    SPILL_LAUNCH_WARPS samples, halved until the fullest tile fits
    ``smem_budget`` beside the staged tables; None when not even one
    sample's does.  The only source of the tile kernel's geometry.

    ``plan_depth_tiles`` is the reference's, unchanged, and takes
    ``_RESERVED_STATES`` out of the budget it is given; it gets the budget
    less the tables and what the walk holds besides checkpoints, with that
    reserve added back, so its tiles fill exactly what the launch asks for.
    Where everything fits one tile it returns None, and the one tile spans
    the shallowest checkpoint to the end."""
    positions = sorted(positions)
    if not positions:
        return None
    table = walk_table_bytes(plan, n_variants)
    first_of = {ps[-1]: ps[0] for ps in plan.theta_positions if ps}
    firsts = [first_of.get(k, k) for k in positions]
    tb = SPILL_LAUNCH_WARPS
    while tb >= 1:
        s = _state_bytes(plan.m, tb)
        budget = smem_budget - table - walk_smem_bytes(plan.m, 0, tb) + _RESERVED_STATES * s
        tiles = plan_depth_tiles(plan, positions, tb, budget) or (
            (min(firsts), len(plan.train_ops)),
        )
        n_ckpt = tuple(
            len({f for k, f in zip(positions, firsts) if lo <= k < hi}) for lo, hi in tiles
        )
        smem = table + walk_smem_bytes(plan.m, max(n_ckpt), tb)
        if smem <= smem_budget:
            return SpillTiling(tiles, n_ckpt, tb, smem)
        tb //= 2
    return None


@functools.lru_cache(maxsize=None)
def _shift_route(
    spec: CircuitSpec, four_term: bool, groups: tuple[int, ...], smem_budget: int
) -> "_WalkTable":
    """How an implicit shift bank runs, as the table of the kernel(s) that
    run it (``route``): the single sweep ("sweep", no tiles) when a block
    of at least SWEEP_MIN_WARPS samples holds its checkpoints, else the
    spill pair ("pair") where its tile launch fits, else the single sweep
    where one sample's block fits, else the device-memory walk ("dmem",
    ``_shift_dmem_walk``: from m = 13 at 227 KB, where one checkpoint and
    the walk's three states take 256 KB), whose block holds three 64 KB
    chunks and its tables whatever the budget (``_shift_dmem_smem``).  A
    function of the plan and the budget alone (not of the batch), so
    per-bank and multibank launches take the same route; the wrapper,
    ``shift_execution_info`` and through it the launch observer all read
    this."""
    sweep = _walk_table(spec, four_term, groups, smem_budget, False)
    if sweep.tb >= SWEEP_MIN_WARPS:
        return sweep
    spill = _walk_table(spec, four_term, groups, smem_budget, True)
    if spill.tb:
        return spill
    if sweep.tb:
        return sweep
    return _shift_dmem_walk(spec, four_term, groups)


def shift_plan_fits(
    spec: CircuitSpec,
    four_term: bool = False,
    groups: tuple[int, ...] | None = None,
    smem_budget: int = SMEM_BUDGET_BYTES,
    device=None,
) -> bool:
    """True unless the bank's shift plan has no route.  Every plan whose
    register holds DMEM_SECTOR_QUBITS qubits or more has one (from m = 13
    the device-memory walk, whatever the shared-memory budget), so this is
    False only where that route refuses: one sample's scratch beyond the
    device memory of ``device``'s card (checked where a CUDA ``device`` is
    given), or a register too narrow for it that no block of the
    shared-memory routes holds.  The serving layer refuses exactly these
    banks at admission."""
    if groups is None:
        groups = tuple(range(1 + (4 if four_term else 2) * spec.n_theta))
    groups = tuple(groups)
    if build_shift_plan(spec) is None or not use_shift_plan(spec, four_term):
        return True  # the materialized rows run on the fidelity kernel's routes
    try:
        tab = _shift_route(spec, four_term, groups, smem_budget)
    except NotImplementedError:
        return False
    if tab.route != "dmem" or device is None or torch.device(device).type != "cuda":
        return True
    sample = shift_dmem_geometry(tab, 1)[2]
    return sample <= torch.cuda.get_device_properties(device).total_memory


def shift_execution_info(
    spec: CircuitSpec,
    n_samples: int,
    *,
    four_term: bool = False,
    groups: tuple[int, ...] | None = None,
    smem_budget: int = SMEM_BUDGET_BYTES,
) -> dict:
    """Static execution-mode report: which path a shift bank takes, the
    block size its launch gets and the shared memory it asks for.  ``mode``
    is "materialize" (the fidelity kernel over the n_samples x G rows),
    "fused" (single-sweep shift kernel, ``route`` "sweep") or "spill", as
    the reference reports every plan whose checkpoints do not fit one
    block, with ``route`` "pair" (the spill pair: one forward launch, then
    one tile launch over every depth tile, deepest first; ``tb`` /
    ``smem_bytes`` are the tile launch's, ``forward_tb`` /
    ``forward_smem_bytes`` the forward launch's) or "dmem" (the
    device-memory walk, no depth tiles: ``launches`` of at most
    ``samples_per_launch`` samples, one block of ``smem_bytes`` a sample,
    ``scratch_bytes`` of device memory a launch, ``passes`` passes, of
    which ``one_sweep_passes`` sweep the state in shared memory once, and
    ``sweeps`` sweeps a sample: ``shift_dmem_sweeps``).
    ``tb`` counts circuits (samples) per block, one warp each on the
    shared-memory routes."""
    plan = build_shift_plan(spec)
    n_shifts = 4 if four_term else 2
    if groups is None:
        groups = tuple(range(1 + n_shifts * spec.n_theta))
    groups = tuple(groups)
    cost = shift_cost_info(spec, four_term, groups)
    base = {
        "gate_apps_implicit": cost["gate_apps_implicit"],
        "gate_apps_materialized": cost["gate_apps_materialized"],
        "replay_depth_max": cost["replay_depth_max"],
        "smem_budget": smem_budget,
    }
    if plan is None or not use_shift_plan(spec, four_term):
        warps, smem = fused_geometry(spec.n_qubits, n_samples * len(groups), smem_budget)
        return {"mode": "materialize", "launches": 1, "n_tiles": 0, "tb": warps,
                "smem_bytes": smem, **base}
    tab = _shift_route(spec, four_term, groups, smem_budget)
    if tab.route == "sweep":
        return {"mode": "fused", "route": "sweep", "launches": 1, "n_tiles": 0, "tb": tab.tb,
                "smem_bytes": tab.smem_bytes, **base}
    if tab.route == "dmem":
        _, smem, sample, per = shift_dmem_geometry(tab, n_samples)
        sweeps, one = shift_dmem_sweeps(tab)
        return {"mode": "spill", "route": "dmem", "launches": -(-max(n_samples, 1) // per),
                "n_tiles": 0, "tiles": (), "tb": 1, "smem_bytes": smem,
                "scratch_bytes": sample * per, "samples_per_launch": per,
                "passes": len(tab.passes), "sweeps": sweeps, "one_sweep_passes": one, **base}
    return {
        "mode": "spill",
        "route": "pair",
        "launches": 2,
        "n_tiles": len(tab.tiles),
        "tiles": tab.tiles,
        "tb": tab.tb,
        "smem_bytes": tab.smem_bytes,
        "spill_buffer_bytes": _state_bytes(plan.m, tab.tb),
        "forward_tb": tab.forward_tb,
        "forward_smem_bytes": tab.forward_smem_bytes,
        **base,
    }


# ------------------------------------------------- kernel 3: shift groups
def _shiftbank_plain(plan: ShiftPlan, shifts, groups, n_params: int, theta, data):
    """Plain version of ``shiftbank_kernel``: (G, B) rows in ``groups``
    order; group 0 is the base fidelity, group 1 + s*P + j is shift s of
    param j (bank order)."""
    dim, b = 2**plan.m, theta.shape[0]
    th, dt = theta.T, data.T

    # 1. data register: one theta-independent pass, shared by every variant.
    d_re, d_im = zero_tile(dim, b, theta.device)
    for op in plan.data_ops:
        d_re, d_im = apply_one(op, d_re, d_im, plan.m, th, dt)

    wanted = set(groups)
    variants = _collect_variants(plan, shifts, groups, n_params)
    anchors = sorted(k for k in variants if k >= 0)
    firsts = {plan.theta_positions[j][0] for a in anchors for (_, j, _) in variants[a]}

    # 2. forward pass with base angles, checkpointing before each anchored
    #    parameter's FIRST dependent gate.
    checkpoints = {}
    t_re, t_im = zero_tile(dim, b, theta.device)
    for k, op in enumerate(plan.train_ops):
        if k in firsts:
            checkpoints[k] = (t_re, t_im)
        t_re, t_im = apply_one(op, t_re, t_im, plan.m, th, dt)

    rows = {}
    f0 = _inner_fidelity((d_re, d_im), (t_re, t_im))
    if 0 in wanted:
        rows[0] = f0
    for g, _, _ in variants.get(-1, ()):  # shifting an unused param is a no-op
        rows[g] = f0

    # 3. backward pass: chi = (suffix)^dagger psi_d, one suffix replay + one
    #    inner product per variant; chi below the shallowest anchor is unused.
    lowest = anchors[0] if anchors else len(plan.train_ops)
    c_re, c_im = d_re, d_im
    for k in range(len(plan.train_ops) - 1, lowest - 1, -1):
        op = plan.train_ops[k]
        for g, j, s in variants.get(k, ()):
            first = plan.theta_positions[j][0]
            v = _replay_variant(plan, j, s, checkpoints[first], th, dt)
            rows[g] = _inner_fidelity((c_re, c_im), v)
        if k > lowest:
            c_re, c_im = apply_one(op, c_re, c_im, plan.m, th, dt, invert=True)
    return torch.stack([rows[g] for g in groups], dim=0)


@dataclasses.dataclass(frozen=True, eq=False)
class _WalkTable:
    """The shift plan as kernel data, for one route, with that route's
    launch geometry.  ``ints`` holds, in order: data ops and train ops (6
    ints each); per train op the tile whose boundary is the state just
    before it (-1 for none); per train op its checkpoint slot within its
    tile (-1 for none); the variants as (row, param, first, last, anchor)
    in the order the backward walk meets them (anchor descending); then,
    left in device memory, the tiles deepest first as (lo, hi, last, tile),
    ``last`` the tile's deepest checkpoint, and the output rows that take
    the base fidelity.  ``floats`` holds the data-op and train-op constant
    angles and one float32 shift per variant.  The single sweep's table
    has no tiles and one checkpoint slot per checkpoint; ``tb`` /
    ``smem_bytes`` are its launch (``shift_geometry``) or the tile
    launch's (``spill_tiling``), 0 where no block fits.  Compared by
    identity: ``_walk_table`` caches one per request, and the device copies
    are keyed on it."""

    ints: np.ndarray
    floats: np.ndarray
    m: int
    n_data_ops: int
    n_train_ops: int
    n_variants: int
    n_f0_rows: int
    n_rows: int
    lowest: int
    variant_rows: tuple[int, ...]
    tiles: tuple[tuple[int, int], ...]
    n_ckpt: tuple[int, ...]
    tb: int
    smem_bytes: int
    forward_tb: int
    forward_smem_bytes: int
    smem_budget: int

    @property
    def n_tiles(self) -> int:
        return len(self.tiles)

    @property
    def route(self) -> str:
        return "pair" if self.tiles else "sweep"


def _variant_table(plan: ShiftPlan, variants, groups):
    """Variant rows (row, param, first, last, anchor) in the order the
    backward walk meets them (anchor descending), their float32 shifts, and
    the output rows that take the base fidelity."""
    rows_of: dict[int, list[int]] = {}
    for i, g in enumerate(groups):
        rows_of.setdefault(g, []).append(i)
    var_ints, var_shifts = [], []
    for k in sorted((k for k in variants if k >= 0), reverse=True):
        for g, j, s in variants[k]:
            ps = plan.theta_positions[j]
            for r in rows_of[g]:
                var_ints += [r, j, ps[0], ps[-1], k]
                var_shifts.append(s)
    f0_groups = {g for g, _, _ in variants.get(-1, ())} | ({0} & set(groups))
    f0_rows = [i for i, g in enumerate(groups) if g in f0_groups]
    return var_ints, var_shifts, f0_rows


@functools.lru_cache(maxsize=None)
def _walk_table(
    spec: CircuitSpec, four_term: bool, groups: tuple[int, ...], smem_budget: int, spill: bool
) -> _WalkTable:
    """The table and launch geometry of the single sweep, or with ``spill``
    of the spill pair (tiles from ``spill_tiling``; none and ``tb`` 0 where
    its tile launch does not fit).  ``_shift_route`` picks between them."""
    plan = build_shift_plan(spec)
    variants = _collect_variants(plan, shift_values(four_term), groups, spec.n_theta)
    positions = sorted(k for k in variants if k >= 0)
    var_ints, var_shifts, f0_rows = _variant_table(plan, variants, groups)
    nt = len(plan.train_ops)
    if spill:
        tiling = spill_tiling(plan, positions, len(var_shifts), smem_budget)
        tiles = tiling.tiles if tiling else ()
        geometry = (tiling.tb, tiling.smem_bytes) if tiling else (0, 0)
        fwd = forward_geometry(plan, len(var_shifts), smem_budget)
    else:
        tiles, fwd = (), (0, 0)
    bnd_of, ckpt, tile_rows, n_ckpt = [-1] * nt, [-1] * nt, [], []
    for t, (lo, hi) in enumerate(tiles or ((0, nt),)):  # the sweep: one span, no boundary
        firsts = sorted({plan.theta_positions[j][0] for k in range(lo, hi)
                         for (_, j, _) in variants.get(k, ())})
        for i, f in enumerate(firsts):
            ckpt[f] = i
        n_ckpt.append(len(firsts))
        if tiles:
            bnd_of[lo] = t
            tile_rows.append([lo, hi, firsts[-1], t])
    if not spill:
        geometry = shift_geometry(plan, n_ckpt[0], len(var_shifts), smem_budget)
    d_i, d_f = ops_table(plan.data_ops)
    t_i, t_f = ops_table(plan.train_ops)
    tiles_flat = [x for row in reversed(tile_rows) for x in row]
    ints = np.concatenate(
        [d_i.ravel(), t_i.ravel(),
         np.array(bnd_of + ckpt + var_ints + tiles_flat + f0_rows, np.int32)]
    ).astype(np.int32)
    floats = np.concatenate([d_f, t_f, np.array(var_shifts, np.float32)]).astype(np.float32)
    return _WalkTable(
        ints, floats, plan.m, len(plan.data_ops), nt, len(var_shifts), len(f0_rows),
        len(groups), positions[0] if positions else nt, tuple(sorted(set(var_ints[0::5]))),
        tiles, tuple(n_ckpt), *geometry, *fwd, smem_budget,
    )


def _require_block(tab: _WalkTable, tb: int, kernel: str) -> None:
    if tb == 0:
        raise NotImplementedError(
            f"not even one sample of this {tab.m}-qubit register plan fits the "
            f"{tab.smem_budget}-byte shared-memory budget of one block of the {kernel}"
        )


def _shiftbank_cuda(tab: _WalkTable, theta, data):
    """Launch ``shiftbank_kernel`` for the single sweep's table: -> (G, B)."""
    _require_block(tab, tab.tb, "single-sweep shift kernel")
    b, dev = theta.shape[0], theta.device
    ints, floats = on_device(tab, (tab.ints, tab.floats), dev)
    out = torch.empty((tab.n_rows, b), dtype=torch.float32, device=dev)
    if b:
        launch("vqc_shiftbank", "vqc_shiftbank_launch", "shift-bank", dev,
               ptr(theta), ptr(data), b, theta.shape[1], data.shape[1],
               ptr(ints), ptr(floats), tab.m, tab.n_data_ops, tab.n_train_ops,
               tab.n_variants, tab.n_f0_rows, tab.lowest, ptr(out), tab.tb, tab.smem_bytes,
               count="shiftbank")
    return out


# ------------------------------------- kernels 4 and 5: spilled shift groups
#
# When the single sweep's checkpoints do not fit a block of SWEEP_MIN_WARPS
# samples (``_shift_route``), the train-op sequence is cut into depth tiles
# (``spill_tiling``).  The forward kernel runs the data pass and the train
# forward pass once, writes f0, the data-register state
# (the seed of chi) and each tile's boundary prefix state to device memory,
# layout [tile][re/im][amp][sample].  The tile kernel then sweeps every
# tile, deepest first: it loads the tile's boundary, re-derives the tile's
# checkpoints from it, and walks chi down through the tile, replaying each
# variant anchored there; chi carries into the next tile in shared memory.
# Per lane the gates apply in the same order as the single sweep, so the
# plain pair below is bit-identical to ``_shiftbank_plain``.


def _tile_plan(plan: ShiftPlan, variants, tiles):
    """((tile, lo, hi, rows_t), ...) deepest tile first, each ``rows_t`` the
    tile's (group, param, shift, anchor) in descending anchor order."""
    return tuple(
        (t, lo, hi, tuple((g, j, s, k) for k in range(hi - 1, lo - 1, -1)
                          for (g, j, s) in variants.get(k, ())))
        for t, (lo, hi) in reversed(list(enumerate(tiles)))
    )


def _shift_forward_plain(plan: ShiftPlan, tile_los, theta, data):
    """Plain version of ``shift_forward_kernel``: -> f0 (B,), the data-
    register state (2*dim, B) and the boundary prefix states (2*n_tiles*dim,
    B), each state a [re; im] stack."""
    dim, b = 2**plan.m, theta.shape[0]
    th, dt = theta.T, data.T
    d_re, d_im = zero_tile(dim, b, theta.device)
    for op in plan.data_ops:
        d_re, d_im = apply_one(op, d_re, d_im, plan.m, th, dt)
    los = {lo: t for t, lo in enumerate(tile_los)}
    bnd = [None] * len(tile_los)
    t_re, t_im = zero_tile(dim, b, theta.device)
    for k, op in enumerate(plan.train_ops):
        if k in los:
            bnd[los[k]] = (t_re, t_im)
        t_re, t_im = apply_one(op, t_re, t_im, plan.m, th, dt)
    f0 = _inner_fidelity((d_re, d_im), (t_re, t_im))
    return f0, torch.cat([d_re, d_im]), torch.cat([x for state in bnd for x in state])


def _shift_tile_plain(plan: ShiftPlan, tile_plan, theta, data, chi, boundaries):
    """Plain version of ``shift_tile_kernel``: every tile of ``tile_plan``
    (see ``_tile_plan``) in order, chi seeded from ``chi`` (2*dim, B).
    Returns one row per (group, param, shift, anchor) of the tile plan, in
    its order, (R, B)."""
    dim = 2**plan.m
    th, dt = theta.T, data.T
    c_re, c_im = chi[:dim], chi[dim:]
    out_rows = []
    for pos, (t, lo, hi, rows_t) in enumerate(tile_plan):
        # re-derive this tile's checkpoints from its boundary prefix state
        firsts = {plan.theta_positions[j][0] for (_, j, _, _) in rows_t}
        last = max(firsts)
        re = boundaries[2 * t * dim : (2 * t + 1) * dim]
        im = boundaries[(2 * t + 1) * dim : (2 * t + 2) * dim]
        checkpoints = {}
        for k in range(lo, last + 1):
            if k in firsts:
                checkpoints[k] = (re, im)
            if k < last:
                re, im = apply_one(plan.train_ops[k], re, im, plan.m, th, dt)
        # chi walk + per-variant suffix replay, the single sweep's order; chi
        # at lo seeds the next (shallower) tile.
        rows = {}
        for k in range(hi - 1, lo - 1, -1):
            for g, j, s, anchor in rows_t:
                if anchor == k:
                    v = _replay_variant(plan, j, s, checkpoints[plan.theta_positions[j][0]], th, dt)
                    rows[g] = _inner_fidelity((c_re, c_im), v)
            if k > lo or pos + 1 < len(tile_plan):
                c_re, c_im = apply_one(plan.train_ops[k], c_re, c_im, plan.m, th, dt, invert=True)
        out_rows.extend(rows[g] for g, _, _, _ in rows_t)
    return torch.stack(out_rows, dim=0)


def _spilled_rows(variants, groups, tile_plan, f0, rows):
    """The (G, B) result in ``groups`` order from the forward kernel's f0 and
    the tile kernel's rows (in ``tile_plan`` order)."""
    by_group = {g: f0 for g, _, _ in variants.get(-1, ())}
    if 0 in groups:
        by_group[0] = f0
    flat = [r for (_, _, _, rows_t) in tile_plan for r in rows_t]
    for i, (g, _, _, _) in enumerate(flat):
        by_group[g] = rows[i]
    return torch.stack([by_group[g] for g in groups], dim=0)


def _shift_spilled_plain(plan: ShiftPlan, shifts, groups, n_params: int, tiles, theta, data):
    """The plain pair orchestrated like the kernels: one forward pass, then
    one backward pass over every tile, deepest first.  -> (G, B)."""
    variants = _collect_variants(plan, shifts, groups, n_params)
    tile_plan = _tile_plan(plan, variants, tiles)
    f0, d_state, boundaries = _shift_forward_plain(plan, [lo for lo, _ in tiles], theta, data)
    rows = _shift_tile_plain(plan, tile_plan, theta, data, d_state, boundaries)
    return _spilled_rows(variants, groups, tile_plan, f0, rows)


def _shift_forward_cuda(tab: _WalkTable, theta, data, out):
    """Launch ``shift_forward_kernel`` for a spill table: f0 into the
    base-fidelity rows of ``out`` (G, B); returns the data-register state
    (2*dim, B) and the tile boundaries (2*n_tiles*dim, B), layout
    [tile][re/im][amp][sample]."""
    _require_block(tab, tab.forward_tb, "spill forward kernel")
    b, dim, dev = theta.shape[0], 2**tab.m, theta.device
    n_tiles = tab.n_tiles
    d_state = torch.empty((2 * dim, b), dtype=torch.float32, device=dev)
    boundaries = torch.empty((2 * n_tiles * dim, b), dtype=torch.float32, device=dev)
    if b:
        ints, floats = on_device(tab, (tab.ints, tab.floats), dev)
        launch("vqc_spill", "vqc_shift_forward_launch", "spill forward", dev,
               ptr(theta), ptr(data), b, theta.shape[1], data.shape[1],
               ptr(ints), ptr(floats), tab.m, tab.n_data_ops, tab.n_train_ops,
               n_tiles, tab.n_variants, tab.n_f0_rows, ptr(out), ptr(d_state),
               ptr(boundaries), tab.forward_tb, tab.forward_smem_bytes,
               count="shift_forward")
    return d_state, boundaries


def _shift_tile_cuda(tab: _WalkTable, theta, data, chi, boundaries, out):
    """Launch ``shift_tile_kernel`` over every tile of a spill table,
    deepest first, chi seeded from ``chi`` (2*dim, B): writes the variant
    rows of ``out``."""
    _require_block(tab, tab.tb, "spill tile kernel")
    b, dim, dev = theta.shape[0], 2**tab.m, theta.device
    n_tiles = tab.n_tiles
    for name, t, rows in (("chi", chi, 2 * dim), ("boundaries", boundaries, 2 * n_tiles * dim)):
        if (t.shape != (rows, b) or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 ({rows}, {b}) tensor on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if b:
        ints, floats = on_device(tab, (tab.ints, tab.floats), dev)
        launch("vqc_spill", "vqc_shift_tile_launch", "spill tile", dev,
               ptr(theta), ptr(data), b, theta.shape[1], data.shape[1],
               ptr(ints), ptr(floats), tab.m, tab.n_data_ops, tab.n_train_ops,
               n_tiles, tab.n_variants, ptr(chi), ptr(boundaries), ptr(out),
               tab.tb, tab.smem_bytes, count="shift_tile")
    return out


def _shift_spilled_cuda(tab: _WalkTable, theta, data):
    """The spill pair for a spill table: -> (G, B)."""
    out = torch.empty((tab.n_rows, theta.shape[0]), dtype=torch.float32, device=theta.device)
    d_state, boundaries = _shift_forward_cuda(tab, theta, data, out)
    return _shift_tile_cuda(tab, theta, data, d_state, boundaries, out)


# ------------------------- kernels 4 and 5 at m >= 13: the device-memory route
#
# From m = 13 (27-qubit QuClassi) no block holds one sample of either
# shift-walk kernel: one checkpoint and the walk's three live states take
# 256 KB.  The walk then keeps its checkpoints in device memory
# (``vqc_shift_dmem.cu``, one block a sample): the host cuts it into a
# program of passes (``_shift_dmem_walk``), each a run of gates over chunks
# of at most DMEM_LOCAL_QUBITS local qubits, cut as ``dmem_plan`` cuts a
# circuit; ``_shift_dmem_plain`` runs the same program on the CPU.  The
# block's shared memory holds three chunks: at m = k chi and two whole
# states, moved by the staging plan (``_shift_dmem_stage``); at m = k + 1
# chi resident and one chunk; wider, two chunks in turn and chi's chunk.

#: scratch slots of a sample besides its checkpoints (slot 2 + i): chi
#: (seeded with the data state) and the variant of a multi-pass replay.
_DMEM_CHI, _DMEM_VARIANT, _DMEM_FIRST_CKPT = 0, 1, 2
#: a pass row's output row that stands for every base-fidelity row
_ALL_F0_ROWS = -2
#: device memory the route's scratch takes at once: a batch whose samples
#: need more runs in launches of fewer samples (1 GiB holds 212 samples of
#: 27q-3l; 8 GiB all 1,152 of a training step).
SHIFT_DMEM_WORKSPACE_BYTES = 8 << 30


@dataclasses.dataclass(frozen=True, eq=False)
class _DmemWalk:
    """The shift walk as a program of device-memory passes.  ``passes``
    rows are (source slot or -1 for |0...0>, destination slot or -1, output
    row or -1 (``_ALL_F0_ROWS``: every base-fidelity row), first and end
    index into the pass ops, local mask as its (low, high) 32-bit halves),
    the mask over amplitude bits of the m-qubit register (qubit q is bit m
    - 1 - q).  ``pass_ops`` are op-table rows with each qubit replaced by
    its rank among the pass's local qubits (``local_ops`` the same as
    ``Op``s, for the plain version), ``pass_refs`` 2 * (angle index) + 1
    where the op is inverted, ``stage`` the kernel's staging plan, a row a
    pass (``_shift_dmem_stage``; None where m > k).  The per-sample
    angle table holds the base angle of each of ``ops`` (data ops, then
    train ops: ``base_ops`` / ``base_consts``) and, after them,
    theta[var_param[v]] + var_shift[v] for each variant v.  Compared by
    identity: ``_shift_dmem_walk`` caches one per request, and the device
    copies are keyed on it."""

    passes: np.ndarray
    pass_ops: np.ndarray
    pass_refs: np.ndarray
    stage: np.ndarray | None
    local_ops: tuple
    base_ops: np.ndarray
    base_consts: np.ndarray
    ops: tuple
    var_param: np.ndarray
    var_shift: np.ndarray
    f0_rows: np.ndarray
    m: int
    k: int
    n_rows: int
    n_slots: int

    route = "dmem"
    tiles = ()
    tb = 1

    @property
    def n_angles(self) -> int:
        return len(self.ops) + len(self.var_param)

    @property
    def max_pass_ops(self) -> int:
        return int((self.passes[:, 4] - self.passes[:, 3]).max())

    @property
    def smem_bytes(self) -> int:
        return shift_dmem_geometry(self, 1)[1]


def _dmem_low_slot(m: int, k: int) -> int:
    """The first slot the walk keeps in device memory: the checkpoints at
    m = k (chi in shared memory, no multi-pass replay), the variant slot at
    m = k + 1 (chi resident), else chi."""
    return _DMEM_FIRST_CKPT if m == k else _DMEM_VARIANT if m == k + 1 else _DMEM_CHI


def _shift_dmem_smem(walk: _DmemWalk) -> tuple[int, bool]:
    """(shared-memory bytes a block, whether the program's tables are among
    them): three chunks' (re, im), two mbarriers, two partial sums a warp,
    then at m = k each pass op's cos / sin (built once a sample), else the
    deposit tables, the angle table and a pass's cos / sin; then the
    passes, staging plan and pass ops (and, m > k, the angle references)
    where they fit the SMEM_BUDGET_BYTES a block may use (else the kernel
    reads them from device memory)."""
    n_ops = len(walk.pass_refs)
    if walk.stage is not None:
        base = 4 * (6 * 2**walk.k + 64 + 2 * n_ops) + 8 * 2
        tables = 4 * ((7 + _STAGE_FIELDS) * len(walk.passes) + 6 * n_ops)
    else:
        base = (4 * (6 * 2**walk.k + 64 + 2 * walk.n_angles + 2 * walk.max_pass_ops)
                + 8 * (2 + 256 + 64))
        tables = 4 * (7 * len(walk.passes) + (6 + 1) * n_ops)
    fits = base + tables <= SMEM_BUDGET_BYTES
    return base + tables * fits, fits


def shift_dmem_geometry(walk: _DmemWalk, n_samples: int) -> tuple[int, int, int, int]:
    """(blocks a sample, shared-memory bytes a block, scratch bytes a
    sample, samples a launch) of the shift walk's device-memory route: one
    block of 512 threads a sample; its shared memory three chunks'
    (re, im) (chi and two states at m = k, chi resident and a chunk at
    m = k + 1, else two chunks and chi's), two mbarriers, two partial sums
    a warp, at m = k each pass op's cos / sin, else the two deposit tables
    (256 + 64 offsets of 8 bytes), the sample's angle table and a pass's
    cos / sin, and the program's tables where they fit
    (``_shift_dmem_smem``: 226,160 B at 27q-3l); its
    scratch the slots from ``_dmem_low_slot`` on (the checkpoints alone at
    m = k); as many samples a launch as SHIFT_DMEM_WORKSPACE_BYTES holds, at
    least one.  The only source of the route's geometry: the wrapper,
    ``shift_execution_info`` and the serving layer's per-block memory model
    read it."""
    smem = _shift_dmem_smem(walk)[0]
    sample = (walk.n_slots - _dmem_low_slot(walk.m, walk.k)) * _state_bytes(walk.m, 1)
    per = SHIFT_DMEM_WORKSPACE_BYTES // max(sample, 1)
    return 1, smem, sample, max(1, min(max(n_samples, 1), per))


def _append_run(prog, ops, refs, m: int, k: int, src: int, dst: int, row: int) -> None:
    """Append one run of gates (``ops`` in register qubits, ``refs`` their
    angle references) from slot ``src`` to ``dst`` (and/or into output
    ``row``) to ``prog`` = (passes, pass_ops, pass_refs, local_ops): cut by
    ``dmem_plan`` into passes of at most k local qubits, the first reading
    ``src``, the others the run's destination (the variant slot where the
    run ends in an inner product only)."""
    passes, pass_ops, pass_refs, local_ops = prog
    mid = dst if dst >= 0 else _DMEM_VARIANT
    cut = dmem_plan(CircuitSpec(m, tuple(ops), 0, 0), k)
    for i, p in enumerate(cut):
        last = i == len(cut) - 1
        rank = {q: r for r, q in enumerate(p.qubits)}
        lo = len(pass_ops)
        for op, ref in zip(ops[p.lo:p.hi], refs[p.lo:p.hi]):
            local = dataclasses.replace(op, qubits=tuple(rank[q] for q in op.qubits))
            pass_ops.append(op_row(local)[0])
            pass_refs.append(ref)
            local_ops.append(local)
        mask = sum(1 << (m - 1 - q) for q in p.qubits)
        passes.append([src if i == 0 else mid, dst if last else mid, row if last else -1,
                       lo, len(pass_ops), *_halves(mask)])


#: fields of a staging-plan row (``_shift_dmem_stage``)
_STAGE_FIELDS = 9
#: a one-chunk pass's form (staging-plan field 7): its gates one sweep of
#: the state each (``chunk_gates``); all of them in registers over orbits of
#: its qubits, the state read and written once; or its one gate's result on
#: each amplitude computed where the inner product reads it, nothing written
_PER_GATE, _ORBIT, _ELEMENT = 0, 1, 2
#: gates the one-sweep forms apply (every gate of the shift walk but CSWAP)
_SWEEP_GATES = frozenset(("h", "rx", "ry", "rz", "ryy", "rzz", "cry", "crz"))


def _coupled_qubits(op) -> tuple[int, ...]:
    """The qubits across which ``op`` mixes amplitudes: none for the
    diagonal gates (RZ, RZZ, CRZ), CRY's target, RYY's two, else its one."""
    if op.gate in ("rz", "rzz", "crz"):
        return ()
    return op.qubits[1:] if op.gate == "cry" else op.qubits


def _pass_form(src: int, dst: int, row: int, ops, k: int) -> tuple[int, int]:
    """(form, orbit mask) of a one-chunk pass from its own shape: one gate
    ending in an inner product on a staged checkpoint takes ``_ELEMENT``;
    any other pass whose gates mix amplitudes across at most two amplitude
    bits from 2 up (local qubit q is bit k - 1 - q; RYY on neighbouring
    qubits) takes ``_ORBIT``: its orbit bits 0 and 1 (a float4's own), those
    bits and, up to two, the lowest others from bit 5 (below 5 they would
    meet in the shared-memory banks); the rest (the data run)
    ``_PER_GATE``.  A two-qubit gate's qubits must ascend, as
    ``chunk_gates`` has them."""
    if k < 4 or any(op.gate not in _SWEEP_GATES or list(op.qubits) != sorted(op.qubits)
                    for op in ops):
        return _PER_GATE, 0
    if row != -1 and dst < 0 and src >= 0 and len(ops) == 1:
        return _ELEMENT, 0
    high = {k - 1 - q for op in ops for q in _coupled_qubits(op)} - {0, 1}
    if len(high) > 2 or any(op.gate == "ryy" and op.qubits[1] != op.qubits[0] + 1 for op in ops):
        return _PER_GATE, 0
    pad = [b for b in [*range(5, k), *range(2, min(5, k))] if b not in high]
    return _ORBIT, sum(1 << b for b in sorted(high) + pad[:2 - len(high)]) | 0b11


def _shift_dmem_stage(rows, forms) -> np.ndarray:
    """The kernel's staging plan for a one-chunk walk (m = k), a row a pass
    of ``rows`` = (source, destination, output row) with its ``forms`` =
    (form, orbit mask): (work region, fetch region, fetch slot, wait
    region, read region, load region, load slot, form, orbit mask), -1 for
    none.  Region 0 holds chi for the whole walk (the data run builds it
    there, chi's runs apply in place); regions 1 and 2 hold states.  Before
    its gates a pass fetches its checkpoint (a bulk load issued then, and
    waited for), waits for one issued ahead, or finds it still staged, and
    issues the load ahead, if any; it reads its read region (-1: |0...0>)
    and writes its work region (in place where the two are one).  An
    ``_ELEMENT`` pass writes nothing (work region -1) and leaves its
    checkpoint staged.  Any other pass whose checkpoint the next pass that
    needs a region replays too (f0 and the deepest parameter's, on the
    other forms) writes the other region and leaves the checkpoint staged;
    so does a pass whose checkpoint the pass before it stored from that
    region (a forward run after a forward run), so the store drains while
    it computes.  A checkpoint stored and not staged is loaded into the
    region no pass needs before it, at the first pass where one is free and
    no pass in between needs a free region.  Raises ValueError on a pass
    that reads or writes the variant slot, or chi into another slot: a
    one-chunk walk has none."""
    rows = [tuple(int(x) for x in r[:3]) for r in rows]
    n = len(rows)

    def in_buffer(i):
        return rows[i][0] != _DMEM_CHI and rows[i][1] != _DMEM_CHI

    nxt, after = [None] * n, None  # the next pass that works in region 1 or 2
    for i in range(n - 1, -1, -1):
        nxt[i] = after
        if in_buffer(i):
            after = i
    stored = {}
    for i, (_, d, _) in enumerate(rows):
        stored.setdefault(d, i)

    def keeps(i):  # the next region pass replays from this pass's checkpoint
        return rows[i][0] >= _DMEM_FIRST_CKPT and nxt[i] is not None \
            and rows[nxt[i]][0] == rows[i][0]

    def needs_free(i):  # the pass writes a region its checkpoint is not staged in
        return rows[i][0] == -1 or (forms[i][0] != _ELEMENT and keeps(i))

    held, loading = {1: None, 2: None}, {1: False, 2: False}
    plan = np.full((n, _STAGE_FIELDS), -1, np.int32)
    for i, (src, dst, row) in enumerate(rows):
        plan[i, 7:9] = forms[i]
        if _DMEM_VARIANT in (src, dst):
            raise ValueError(f"pass {i} of a one-chunk walk uses the variant slot")
        if not in_buffer(i):
            if dst != _DMEM_CHI or src not in (-1, _DMEM_CHI) or row != -1:
                raise ValueError(f"pass {i} ({src}, {dst}, {row}) moves chi out of its region")
            plan[i, 0], plan[i, 4] = 0, src
            continue
        if src >= 0:
            b = next((r for r in (1, 2) if held[r] == src), None)
            if b is None:  # not staged: fetch it now
                b = min((r for r in (1, 2) if not loading[r]),
                        key=lambda r: held[r] is not None)
                plan[i, 1:3] = b, src
                held[b], loading[b] = src, True
            if loading[b]:
                plan[i, 3], loading[b] = b, False
            plan[i, 4] = b
            other = 3 - b
            drains = i > 0 and rows[i - 1][1] == src and plan[i - 1, 0] == b
            if forms[i][0] == _ELEMENT:
                work = b
            elif (keeps(i) or drains) and not loading[other]:
                plan[i, 0] = work = other
            else:
                plan[i, 0] = work = b
                held[b] = None
        else:
            want = rows[nxt[i]][0] if nxt[i] is not None else None
            work = min((r for r in (1, 2) if not loading[r]),
                       key=lambda r: (held[r] is not None, held[r] == want))
            plan[i, 0] = work
        if plan[i, 0] >= 0:
            held[work] = dst if dst >= 0 else None
        # the next checkpoint to come, loaded ahead into a free region
        q = next((j for j in range(i + 1, n) if in_buffer(j) and rows[j][0] >= 0
                  and rows[j][0] not in held.values()), None)
        if q is None or stored.get(rows[q][0], n) >= i:
            continue
        if any(needs_free(r) for r in range(i + 1, q) if in_buffer(r)):
            continue  # a pass before it needs the free region
        needed = {rows[r][0] for r in range(i + 1, q) if in_buffer(r)}
        free = [r for r in (1, 2) if r != work and not loading[r] and held[r] not in needed
                and r != plan[i, 4]]
        if free:
            plan[i, 5:7] = free[0], rows[q][0]
            held[free[0]], loading[free[0]] = rows[q][0], True
    return plan


def _gate_sweeps(ops, k: int) -> int:
    """Sweeps of a chunk that ``chunk_gates`` makes for ``ops``: one a gate,
    but one for a run of one-qubit rotations of one qubit, and for a run of
    one-qubit gates (H too) of local bit 0 or 1."""
    n = j = 0
    while j < len(ops):
        op, j1 = ops[j], j + 1
        low, q = op.qubits[-1] > k - 3, op.qubits[0]
        joins = ("rx", "ry", "rz", "h") if low else ("rx", "ry", "rz")
        if op.gate in joins:
            while j1 < len(ops) and ops[j1].gate in joins and ops[j1].qubits[0] == q:
                j1 += 1
        n, j = n + 1, j1
    return n


def shift_dmem_sweeps(walk) -> tuple[int, int]:
    """(sweeps, one-sweep passes) of a sample of the device-memory walk,
    from its host plan: the block's sweeps over a whole state in shared
    memory (|0...0> made or a state copied in, each gate sweep, each inner
    product; at m > k, where a pass goes chunk by chunk, a chunk's fill
    and its drain count too, and no pass is one sweep), and the passes that
    make exactly one.  At m = k an ``_ORBIT`` pass is one sweep (one more
    where it ends in an inner product), an ``_ELEMENT`` pass one."""
    sweeps = one = 0
    for i, (src, dst, row, lo, hi, *_) in enumerate(walk.passes.tolist()):
        ops, ip = walk.local_ops[lo:hi], row != -1
        if walk.stage is None:
            sweeps += 1 + _gate_sweeps(ops, walk.k) + (dst >= 0) + ip
            continue
        work, rd, form = (int(x) for x in walk.stage[i, [0, 4, 7]])
        n = (1 if form == _ELEMENT else 1 + ip if form == _ORBIT
             else (rd != work) + _gate_sweeps(ops, walk.k) + ip)
        sweeps, one = sweeps + n, one + (n == 1)
    return sweeps, one


@functools.lru_cache(maxsize=None)
def _shift_dmem_walk(spec: CircuitSpec, four_term: bool, groups: tuple[int, ...]) -> _DmemWalk:
    """The shift walk of the requested groups as device-memory passes, in
    ``_shiftbank_plain``'s order: the data run into chi; the forward runs
    between checkpoints, each into the next checkpoint's slot, the last
    ending in f0 (where a base-fidelity row is asked for); then, anchor by
    anchor in descending order, chi's inverse run down to the anchor and
    each variant's replay of its parameter's span from its checkpoint, the
    shift on that parameter's gates, ending in |<chi|v>|^2.  Raises
    NotImplementedError below DMEM_SECTOR_QUBITS register qubits (a chunk
    moves four amplitudes at a time)."""
    plan = build_shift_plan(spec)
    m = plan.m
    if m < DMEM_SECTOR_QUBITS:
        raise NotImplementedError(
            f"the shift walk's device-memory route needs a register of {DMEM_SECTOR_QUBITS} "
            f"qubits or more, got {m}")
    k = min(DMEM_LOCAL_QUBITS, m)
    shifts = shift_values(four_term)
    variants = _collect_variants(plan, shifts, groups, spec.n_theta)
    var_ints, var_shifts, f0_rows = _variant_table(plan, variants, groups)
    var_rows = [var_ints[i:i + 5] for i in range(0, len(var_ints), 5)]
    nd, nt = len(plan.data_ops), len(plan.train_ops)
    train = plan.train_ops
    firsts = sorted({first for _, _, first, _, _ in var_rows})
    slot = {f: _DMEM_FIRST_CKPT + i for i, f in enumerate(firsts)}
    prog = ([], [], [], [])

    _append_run(prog, plan.data_ops, [2 * i for i in range(nd)], m, k, -1, _DMEM_CHI, -1)
    lo, src = 0, -1
    for f in firsts:
        _append_run(prog, train[lo:f], [2 * (nd + q) for q in range(lo, f)], m, k, src, slot[f], -1)
        lo, src = f, slot[f]
    if f0_rows:
        _append_run(prog, train[lo:], [2 * (nd + q) for q in range(lo, nt)], m, k, src, -1,
                    _ALL_F0_ROWS)
    top = nt  # chi = (train ops top .. nt - 1)^dagger psi_d
    for vi, (row, j, first, last, anchor) in enumerate(var_rows):
        if anchor + 1 < top:
            down = range(top - 1, anchor, -1)
            _append_run(prog, [train[q] for q in down], [2 * (nd + q) + 1 for q in down], m, k,
                        _DMEM_CHI, _DMEM_CHI, -1)
            top = anchor + 1
        shifted = 2 * (nd + nt + vi)
        refs = [shifted if train[q].param == ("theta", j) and var_shifts[vi] != 0.0
                else 2 * (nd + q) for q in range(first, last + 1)]
        _append_run(prog, train[first:last + 1], refs, m, k, slot[first], -1, row)

    passes, pass_ops, pass_refs, local_ops = prog
    d_i, d_f = ops_table(plan.data_ops)
    t_i, t_f = ops_table(plan.train_ops)
    stage = None
    if m == k:
        stage = _shift_dmem_stage(passes, [
            _pass_form(src, dst, row, local_ops[lo:hi], k)
            for src, dst, row, lo, hi, *_ in passes])
    return _DmemWalk(
        np.array(passes, np.int64).astype(np.uint32).view(np.int32).reshape(-1, 7),
        np.array(pass_ops, np.int32).reshape(-1, 6), np.array(pass_refs, np.int32), stage,
        tuple(local_ops), np.concatenate([d_i, t_i]).astype(np.int32),
        np.concatenate([d_f, t_f]).astype(np.float32), tuple(plan.data_ops) + tuple(train),
        np.array(var_ints[1::5], np.int32), np.array(var_shifts, np.float32),
        np.array(f0_rows, np.int32), m, k, len(groups), _DMEM_FIRST_CKPT + len(firsts),
    )


def shift_dmem_traffic_bytes(walk: _DmemWalk) -> int:
    """Bytes of state one sample moves through device memory on the route.
    At m = k the staging plan's checkpoint loads and the forward runs'
    stores, chi never; else per chunk of each pass its load (none from
    |0...0>), its store, and chi's chunk where the pass takes an inner
    product, the slots below ``_dmem_low_slot`` (resident chi at m = k + 1)
    moving none."""
    chunk = _state_bytes(walk.k, 1)
    low = _dmem_low_slot(walk.m, walk.k)
    if walk.m == walk.k:
        loads = int((walk.stage[:, 1] >= 0).sum() + (walk.stage[:, 5] >= 0).sum())
        return chunk * (loads + int((walk.passes[:, 1] >= low).sum()))
    total = 0
    for src, dst, row, *_ in walk.passes.tolist():
        total += (src >= low) + (dst >= low) + (row != -1 and _DMEM_CHI >= low)
    return total * chunk * 2 ** (walk.m - walk.k)


def _shift_dmem_plain(walk: _DmemWalk, theta, data):
    """Plain version of ``shift_dmem_kernel``: the same program of passes,
    chunks and angle table, each pass's gates applied to a chunk as a
    k-qubit state with ``apply_one``'s arithmetic, each inner product
    summed chunk by chunk in chunk order (a chunk's share in float64 by
    halves, rounded once, for the kernel's block reduction).  -> (G, B)."""
    m, k, b = walk.m, walk.k, theta.shape[0]
    th, dt = theta.T, data.T
    table = [None if op.param is None else op_angle(op, th, dt) for op in walk.ops]
    table += [th[int(j)] + float(s) for j, s in zip(walk.var_param, walk.var_shift)]
    table = [None if a is None else (torch.cos(a / 2), torch.sin(a / 2)) for a in table]
    slots: dict[int, tuple] = {}
    out = torch.full((walk.n_rows, b), float("nan"), dtype=torch.float32, device=theta.device)
    for src, dst, row, lo, hi, *mask in walk.passes.tolist():
        local = _mask(mask, 0)
        bases = _chunk_bases(m, local)
        offs = torch.from_numpy(_chunk_offsets(m, local)).to(theta.device)
        acc_re = acc_im = torch.zeros(b, dtype=torch.float32, device=theta.device)
        if dst >= 0 and dst not in slots:
            slots[dst] = tuple(torch.full((2**m, b), float("nan"), dtype=torch.float32,
                                          device=theta.device) for _ in range(2))
        for base in bases.tolist():
            idx = offs | base
            if src < 0:
                re, im = zero_tile(2**k, b, theta.device)
                if base:
                    re[0] = 0.0
            else:
                re, im = slots[src][0][idx], slots[src][1][idx]
            for i in range(lo, hi):
                ref = int(walk.pass_refs[i])
                cs = table[ref >> 1]
                c, s = cs if cs is not None else (None, None)
                if ref & 1 and s is not None:
                    s = -s
                re, im = apply_cs(walk.local_ops[i], re, im, k, c, s)
            if dst >= 0:
                slots[dst][0][idx], slots[dst][1][idx] = re, im
            if row != -1:
                cre, cim = slots[_DMEM_CHI][0][idx], slots[_DMEM_CHI][1][idx]
                acc_re = acc_re + _halving_sum(cre * re + cim * im)
                acc_im = acc_im + _halving_sum(cre * im - cim * re)
        if row != -1:
            f = acc_re * acc_re + acc_im * acc_im
            for r in (walk.f0_rows.tolist() if row == _ALL_F0_ROWS else [row]):
                out[r] = f
    return out


def _require_scratch(walk: _DmemWalk, device) -> None:
    """Raise where one sample's scratch exceeds the device memory of
    ``device``'s card: the route's only limit."""
    _, _, sample, _ = shift_dmem_geometry(walk, 1)
    total = torch.cuda.get_device_properties(device).total_memory
    if sample > total:
        raise NotImplementedError(
            f"one sample's scratch of this {walk.m}-qubit register plan ({sample} bytes: "
            f"{walk.n_slots} states) exceeds the device memory of "
            f"{torch.cuda.get_device_name(device)} ({total} bytes)"
        )


def _shift_dmem_cuda(walk: _DmemWalk, theta, data):
    """Launch ``shift_dmem_kernel`` for a device-memory walk, one block a
    sample, in launches of at most ``shift_dmem_geometry``'s samples (the
    scratch they share allocated once): -> (G, B)."""
    b, dev = theta.shape[0], theta.device
    _require_scratch(walk, dev)
    out = torch.empty((walk.n_rows, b), dtype=torch.float32, device=dev)
    if not b:
        return out
    _, smem, sample, per = shift_dmem_geometry(walk, b)
    in_smem = _shift_dmem_smem(walk)[1]
    tables = on_device(walk, (walk.passes, walk.stage, walk.pass_ops, walk.pass_refs,
                               walk.base_ops, walk.base_consts, walk.var_param, walk.var_shift,
                               walk.f0_rows), dev)
    (passes, stage, pass_ops, pass_refs, base_ops, base_consts, var_param, var_shift,
     f0_rows) = tables
    scratch = torch.empty((per, sample // 4), dtype=torch.float32, device=dev)
    for b0 in range(0, b, per):
        n = min(per, b - b0)
        launch("vqc_shift_dmem", "vqc_shift_dmem_launch", "device-memory shift", dev,
               ptr(theta[b0:b0 + n]), ptr(data[b0:b0 + n]), n, theta.shape[1], data.shape[1],
               ptr(base_ops), ptr(base_consts), len(walk.ops), ptr(var_param),
               ptr(var_shift), len(walk.var_param), ptr(passes), len(walk.passes),
               ptr(stage), ptr(pass_ops), ptr(pass_refs), walk.max_pass_ops, ptr(f0_rows),
               len(walk.f0_rows), walk.m, walk.k, ptr(scratch), sample // 4, ptr(out), b, b0,
               int(in_smem), smem, count="shift_dmem")
    return out


def vqc_shift_fidelity(
    spec: CircuitSpec,
    theta: torch.Tensor,
    data: torch.Tensor,
    *,
    four_term: bool = False,
    groups: tuple[int, ...] | None = None,
    smem_budget: int = SMEM_BUDGET_BYTES,
) -> torch.Tensor:
    """Prefix-reuse shift-bank fidelities. theta: (B,P), data: (B,D).

    Returns (G, B) where G = len(groups) (default: every group of the bank,
    1 + 2P or 1 + 4P rows); flattening in group-major order reproduces the
    materialized bank's fidelity vector.  When a block of SWEEP_MIN_WARPS
    samples' checkpoints exceeds ``smem_budget`` (the counterpart of the
    reference's ``vmem_budget``) the bank runs as depth tiles through the
    spill pair, and where not one sample of the spill pair's tile launch
    fits either (registers of 13 qubits and more at 227 KB), as the
    device-memory walk (``_shift_route``), on the CPU (plain versions) as
    on the card.  Raises ValueError when the spec doesn't match the
    SWAP-test product structure, and NotImplementedError where one sample's
    scratch exceeds the card's memory (or a register of fewer than 3 qubits
    fits no block).
    """
    plan = build_shift_plan(spec)
    if plan is None:
        raise ValueError(
            "circuit does not match the SWAP-test product "
            "structure; use the materialized-bank path"
        )
    n_groups = 1 + (4 if four_term else 2) * spec.n_theta
    if groups is None:
        groups = tuple(range(n_groups))
    groups = tuple(int(g) for g in groups)
    if not groups or not all(0 <= g < n_groups for g in groups):
        raise ValueError(f"groups out of range for {n_groups}-group bank: {groups}")
    tab = _shift_route(spec, four_term, groups, smem_budget)  # rejects unsupported gates
    theta, data, kind = _prepare(spec, theta, data)
    if kind == "cpu":
        shifts = tuple(float(s) for s in shift_values(four_term))
        if tab.route == "sweep":
            return _shiftbank_plain(plan, shifts, groups, spec.n_theta, theta, data)
        if tab.route == "dmem":
            return _shift_dmem_plain(tab, theta, data)
        return _shift_spilled_plain(plan, shifts, groups, spec.n_theta, tab.tiles, theta, data)
    if tab.route == "sweep":
        return _shiftbank_cuda(tab, theta, data)
    if tab.route == "dmem":
        return _shift_dmem_cuda(tab, theta, data)
    return _shift_spilled_cuda(tab, theta, data)


# ------------------------------------------------------- analytic counters
def shift_bank_stats(spec: CircuitSpec, n_samples: int, four_term: bool = False) -> dict:
    """Analytic gate-application and angle-traffic counts, implicit vs
    materialized."""
    p, d = spec.n_theta, spec.n_data
    n_groups = 1 + (4 if four_term else 2) * p
    mat_gates = n_groups * len(spec.ops) * n_samples
    mat_angle_floats = n_groups * n_samples * (p + d)
    if not use_shift_plan(spec, four_term):  # fallback executes the same work
        impl_gates = mat_gates
        impl_angle_floats = mat_angle_floats
    else:
        impl_gates = shift_cost_info(spec, four_term)["gate_apps_implicit"] * n_samples
        impl_angle_floats = n_samples * (p + d)
    return {
        "n_groups": n_groups,
        "gate_apps_materialized": mat_gates,
        "gate_apps_implicit": impl_gates,
        "gate_apps_ratio": round(mat_gates / impl_gates, 1),
        "angle_bytes_materialized": 4 * mat_angle_floats,
        "angle_bytes_implicit": 4 * impl_angle_floats,
        "angle_bytes_ratio": round(mat_angle_floats / impl_angle_floats, 1),
    }


def multibank_stats(
    spec: CircuitSpec,
    bank_sizes,
    four_term: bool = False,
    smem_budget: int = SMEM_BUDGET_BYTES,
) -> dict:
    """Launch-count and lane accounting for a fused multi-bank shift
    execution of K same-spec banks vs K per-bank launches.  Each bank takes
    a LANES-padded lane segment of the fused launch."""
    k = len(bank_sizes)
    occupied = sum(bank_sizes)
    padded = sum(-(-b // LANES) * LANES for b in bank_sizes)
    info = shift_execution_info(
        spec, max(bank_sizes), four_term=four_term, smem_budget=smem_budget
    )
    per_bank_launches = k * info["launches"]
    fused_info = shift_execution_info(
        spec, padded, four_term=four_term, smem_budget=smem_budget
    )
    fused_launches = fused_info["launches"]
    return {
        "n_banks": k,
        "bank_sizes": list(bank_sizes),
        "mode": fused_info["mode"],
        "launches_per_bank_path": per_bank_launches,
        "launches_fused": fused_launches,
        "launch_ratio": round(per_bank_launches / fused_launches, 2),
        "occupied_lanes": occupied,
        "padded_lanes": padded,
        "lane_fill": round(occupied / padded, 4),
    }
