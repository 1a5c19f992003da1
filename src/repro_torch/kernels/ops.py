"""Public wrappers around the statevector kernels.

These are the executors the co-Manager data plane and ``shift_rule`` use.
Each wrapper runs on the device of its input tensors: the CUDA kernels on
the GPU, their plain PyTorch versions on the CPU.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.api.capabilities import declare
from repro_torch.core import shift_rule
from repro_torch.core.sim import CircuitSpec
from repro_torch.kernels import vqc_statevector as K


def vqc_p0(spec: CircuitSpec, theta: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return K.vqc_p0(spec, theta, data)


def vqc_fidelity(spec: CircuitSpec, theta: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Fused SWAP-test fidelity for a circuit bank: (C,P),(C,D) -> (C,)."""
    return torch.clamp(2.0 * K.vqc_p0(spec, theta, data) - 1.0, 0.0, 1.0)


def vqc_state(spec: CircuitSpec, theta: torch.Tensor, data: torch.Tensor):
    return K.vqc_state(spec, theta, data)


def kernel_executor(spec: CircuitSpec):
    """shift_rule.Executor backed by the fused statevector kernel."""
    return lambda theta_bank, data_bank: vqc_fidelity(spec, theta_bank, data_bank)


# ----------------------------------------------- kernel profiling observer
#: module-level launch observer: when set, every shift-group launch entering
#: through the public wrappers reports its static ``shift_execution_info``
#: (mode fused/spill/materialize, launches, block size, shared memory) plus
#: the lane/bank shape.  None (default) costs one global read per launch.
_launch_observer = None
_observer_lock = threading.Lock()


def set_launch_observer(fn):
    """Install ``fn(info: dict)`` as the shift-launch observer (None
    disables).  Returns the previous observer so callers can restore it.
    The swap is atomic under a lock; launches read the observer once, so a
    launch from another thread reports to the old or the new one, never to
    none.  The observer itself must be thread-safe (``TraceRecorder`` is)."""
    global _launch_observer
    with _observer_lock:
        prev = _launch_observer
        _launch_observer = fn
    return prev


def _notify_launch(spec, n_lanes, four_term, groups, banks=1):
    obs = _launch_observer
    if obs is None:
        return
    info = dict(K.shift_execution_info(spec, n_lanes, four_term=four_term, groups=groups))
    info["lanes"] = n_lanes
    info["banks"] = banks
    obs(info)
    if info["mode"] != "spill":
        return
    # spill path: the summary event above is the forward launch; then one
    # event per depth tile of the single tile launch, in the order it runs
    # them (deepest first).  Each tile's boundary is loaded into the one
    # boundary buffer when the tile starts, after the previous tile is done.
    tiles = info["tiles"]
    for order, (lo, hi) in enumerate(reversed(tiles)):
        obs(
            {
                "mode": "spill_tile",
                "tile": len(tiles) - 1 - order,
                "tile_order": order,
                "ops": (lo, hi),
                "boundary_bytes": info["spill_buffer_bytes"],
                "lanes": n_lanes,
                "banks": banks,
            }
        )


# ------------------------------------------------- shift-structured banks
def _shiftgroups(spec, theta, data, four_term=False, groups=None) -> torch.Tensor:
    if K.use_shift_plan(spec, four_term):
        return torch.clamp(
            K.vqc_shift_fidelity(spec, theta, data, four_term=four_term, groups=groups),
            0.0,
            1.0,
        )
    descs = shift_rule.group_descriptors(theta.shape[1], four_term)
    if groups is None:
        groups = tuple(range(len(descs)))
    blocks = []
    for g in groups:
        j, s = descs[g]
        if j < 0:
            blocks.append(theta)
        else:
            t = theta.clone()
            t[:, j] += s
            blocks.append(t)
    b = theta.shape[0]
    theta_bank = torch.cat(blocks, 0)
    data_bank = data.repeat(len(groups), 1)
    return vqc_fidelity(spec, theta_bank, data_bank).reshape(len(groups), b)


def vqc_fidelity_shiftgroups(
    spec: CircuitSpec,
    theta: torch.Tensor,
    data: torch.Tensor,
    four_term: bool = False,
    groups: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Shift-bank fidelities for the requested groups, (G, B).

    ``theta (B, P)`` / ``data (B, D)`` are the IMPLICIT bank — base angles
    only.  Uses the prefix-reuse kernel when the circuit matches the
    SWAP-test product structure AND the analytic suffix-replay cost beats
    materializing the whole bank (``K.use_shift_plan``); otherwise
    materializes just the requested groups and runs the fused kernel.  The
    route is the bank's whichever groups are asked for, so each row equals
    the whole bank's row bit for bit.
    """
    _notify_launch(spec, theta.shape[0], four_term, groups)
    return _shiftgroups(spec, theta, data, four_term, groups)


def vqc_fidelity_shiftbank(
    spec: CircuitSpec, theta: torch.Tensor, data: torch.Tensor, four_term: bool = False
) -> torch.Tensor:
    """Whole implicit bank -> flat (C,) fidelities in materialized-bank order."""
    return vqc_fidelity_shiftgroups(spec, theta, data, four_term).reshape(-1)


def _pack_banks(thetas, datas):
    """Pad each bank's samples to a LANES multiple and concatenate along the
    lane axis.  Returns (theta_cat, data_cat, segments) with ``segments[k] =
    (lane_offset, n_samples_k)``."""
    t_parts, d_parts, segments = [], [], []
    off = 0
    for t, d in zip(thetas, datas):
        b = t.shape[0]
        pad = (-b) % K.LANES
        t_parts.append(torch.nn.functional.pad(t.to(torch.float32), (0, 0, 0, pad)))
        d_parts.append(torch.nn.functional.pad(d.to(torch.float32), (0, 0, 0, pad)))
        segments.append((off, b))
        off += b + pad
    return torch.cat(t_parts, 0), torch.cat(d_parts, 0), tuple(segments)


def vqc_fidelity_shiftgroups_multibank(
    spec: CircuitSpec, thetas, datas, four_term: bool, group_sets: tuple
) -> tuple:
    """FUSED multi-bank shift execution: K same-spec implicit banks in ONE
    prefix-reuse kernel launch.

    Each bank occupies its own LANES-padded lane segment; base angles are
    per lane, so different banks share the one launch, which computes the
    union of the requested groups.  Returns a tuple of
    (len(group_sets[k]), B_k) fidelity blocks, each bit-identical per lane
    to the per-bank path and to the whole bank's call.  Circuits without
    the product structure (or whose bank's replay cost exceeds
    materializing it) run per bank.
    """
    union = tuple(sorted({g for gs in group_sets for g in gs}))
    if _launch_observer is not None:
        lanes = sum(t.shape[0] + (-t.shape[0]) % K.LANES for t in thetas)
        _notify_launch(spec, lanes, four_term, union, banks=len(thetas))
    if not K.use_shift_plan(spec, four_term):
        return tuple(
            _shiftgroups(spec, t, d, four_term, tuple(gs))
            for t, d, gs in zip(thetas, datas, group_sets)
        )
    theta_cat, data_cat, segments = _pack_banks(thetas, datas)
    out = torch.clamp(
        K.vqc_shift_fidelity(spec, theta_cat, data_cat, four_term=four_term, groups=union),
        0.0,
        1.0,
    )
    row = {g: i for i, g in enumerate(union)}
    return tuple(
        torch.stack([out[row[g], off : off + b] for g in gs], dim=0)
        for (off, b), gs in zip(segments, group_sets)
    )


def multibank_executor(spec: CircuitSpec):
    """A bank-set executor (declared ``multibank`` capability): runs a
    sequence of same-spec ``ShiftBank``s as one fused multi-bank launch and
    returns the per-bank flat fidelity vectors in bank order."""

    def run(banks):
        four = {b.four_term for b in banks}
        if len(four) > 1:
            raise ValueError("banks in one fused set must share four_term")
        outs = vqc_fidelity_shiftgroups_multibank(
            spec,
            tuple(b.theta for b in banks),
            tuple(b.data for b in banks),
            four.pop(),
            tuple(tuple(range(b.n_groups)) for b in banks),
        )
        return [o.reshape(-1) for o in outs]

    return declare(run, multibank=True)


def shiftbank_executor(spec: CircuitSpec):
    """A ``shift_rule.Executor`` that consumes implicit ``ShiftBank``s
    directly (declared ``shiftbank`` capability) via the prefix-reuse
    kernel; plain ``(theta_bank, data_bank)`` calls run the fused kernel."""

    def run(bank, data_bank=None):
        if data_bank is not None:
            return vqc_fidelity(spec, bank, data_bank)
        return vqc_fidelity_shiftbank(spec, bank.theta, bank.data, bank.four_term)

    return declare(run, shiftbank=True)
