"""Roofline analysis from dry-run records.

Three terms per (arch x shape x mesh), all PER-DEVICE seconds:

    compute_s    = flops_per_device / peak_flops
    memory_s     = bytes_accessed_per_device / hbm_bw
    collective_s = collective_bytes_per_device / link_bw

against a chip's ``Hardware`` peaks: the reference's TPU v5e (its default:
197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI) or the H100 SXM (989
TFLOP/s bf16 dense on the tensor cores, 67 TFLOP/s float32, 3.35 TB/s
HBM3, NVLink 450 GB/s a direction).

``collective_bytes`` parses optimized HLO text: sums the output-shape
bytes of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute op (cost_analysis does not attribute collective traffic).
"""
from __future__ import annotations

import dataclasses
import re

PEAK_FLOPS = 197e12        # bf16 / chip (TPU v5e)
HBM_BW = 819e9             # bytes/s / chip (TPU v5e)
ICI_BW = 50e9              # bytes/s / link (TPU v5e)


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # the dense peak of the dtype the step runs in
    hbm_bw: float              # bytes/s
    link_bw: float             # bytes/s of one chip-to-chip link, one direction
    peak_f32_flops: float = 0.0


TPU_V5E = Hardware("TPU v5e", PEAK_FLOPS, HBM_BW, ICI_BW)
#: NVIDIA H100 SXM data sheet: bf16 dense (tensor cores), float32 outside
#: the tensor cores, HBM3, NVLink 4 (900 GB/s both directions)
H100 = Hardware("NVIDIA H100 SXM", 989e12, 3.35e12, 450e9, peak_f32_flops=67e12)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# matches e.g.:  %all-gather.5 = bf16[8,4096,1152]{2,1,0} all-gather(
_OP_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+\[[\d,]*\](?:\{[^}]*\})?))\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Sum output bytes of every collective op in optimized HLO text."""
    by_kind: dict[str, int] = {k: 0 for k in _COLL_KINDS}
    counts: dict[str, int] = {k: 0 for k in _COLL_KINDS}
    for m in _OP_RE.finditer(hlo_text):
        tuple_shapes, single_shape, kind = m.group(1), m.group(2), m.group(3)
        shape_str = tuple_shapes if tuple_shapes is not None else single_shape
        b = _shape_bytes(shape_str)
        by_kind[kind] += b
        counts[kind] += 1
    return {"total": int(sum(by_kind.values())),
            "by_kind": {k: int(v) for k, v in by_kind.items() if v},
            "counts": {k: v for k, v in counts.items() if v}}


def roofline_terms(record: dict, hw: Hardware = TPU_V5E) -> dict:
    """record = dryrun JSON.  Returns the 3 terms + dominant + ratios."""
    compute_s = record["flops_per_device"] / hw.peak_flops
    memory_s = record["bytes_accessed_per_device"] / hw.hbm_bw
    collective_s = record["collective_bytes_per_device"] / hw.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get).replace("_s", "")
    bound_s = max(compute_s, memory_s, collective_s)
    return {**terms, "dominant": dominant, "bound_s": bound_s,
            "compute_fraction_of_bound": compute_s / bound_s if bound_s else 0.0}


def model_flops(n_params_active: int, n_tokens: int, kind: str) -> float:
    """6*N*D for training; 2*N*D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * n_tokens


def useful_compute_ratio(record: dict, n_params_active: int, n_tokens: int,
                         kind: str, chips: int) -> float:
    """MODEL_FLOPS / total counted FLOPs — catches remat/redundancy."""
    total_hlo = record["flops_per_device"] * chips
    if total_hlo <= 0:
        return 0.0
    return model_flops(n_params_active, n_tokens, kind) / total_hlo
