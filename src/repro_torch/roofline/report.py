"""Render the roofline table from the dry-run's records.

Usage:  PYTHONPATH=src python -m repro_torch.roofline.report [--mesh 16x16] [--md]
            [--hw h100|tpu-v5e]

The reference's ``roofline/report.py`` on the same record schema.  A field
the port's dry-run does not compute (``memory.temp_size_bytes``) reads as
None.  The three terms are against ``--hw``'s peaks, the reference's TPU
v5e by default.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.roofline import analysis

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")

SHAPE_TOKENS = {"train_4k": ("train", 256 * 4096),
                "prefill_32k": ("prefill", 32 * 32768),
                "decode_32k": ("decode", 128),
                "long_500k": ("decode", 1)}

HARDWARE = {"tpu-v5e": analysis.TPU_V5E, "h100": analysis.H100}


def load_records(mesh: str = "16x16") -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(DRYRUN_DIR, f"*__{mesh}.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def active_params(rec: dict) -> int:
    """Active-per-token params: from config when MoE, else total (the
    model built shape-only on ``meta``)."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.models import transformer
    cfg = cfg_base.get(rec["arch"])
    return transformer.active_param_count(cfg, transformer.Model(cfg, device="meta"))


def rows(mesh: str = "16x16", with_model_flops: bool = True,
         hw: analysis.Hardware = analysis.TPU_V5E) -> list[dict]:
    cache: dict[str, int] = {}
    out = []
    for rec in load_records(mesh):
        t = analysis.roofline_terms(rec, hw)
        kind, n_tokens = SHAPE_TOKENS[rec["shape"]]
        temp = rec["memory"]["temp_size_bytes"]
        row = {
            "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "compute_ms": t["compute_s"] * 1e3,
            "memory_ms": t["memory_s"] * 1e3,
            "collective_ms": t["collective_s"] * 1e3,
            "dominant": t["dominant"],
            "hbm_gb_per_dev": None if temp is None else temp / 1e9,
        }
        if with_model_flops:
            if rec["arch"] not in cache:
                cache[rec["arch"]] = active_params(rec)
            mf = analysis.model_flops(cache[rec["arch"]], n_tokens, kind)
            total_hlo = rec["flops_per_device"] * rec["chips"]
            row["model_flops"] = mf
            row["useful_ratio"] = mf / total_hlo if total_hlo else 0.0
        out.append(row)
    return out


def _fmt(v) -> str:
    return "n/a" if v is None else f"{v:.2f}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--md", action="store_true", help="markdown table")
    ap.add_argument("--hw", choices=sorted(HARDWARE), default="tpu-v5e")
    args = ap.parse_args(argv)
    table = rows(args.mesh, hw=HARDWARE[args.hw])
    if args.md:
        print("| arch | shape | compute ms | memory ms | collective ms | "
              "dominant | HBM GB/dev | useful FLOP ratio |")
        print("|---|---|---|---|---|---|---|---|")
        for r in table:
            print(f"| {r['arch']} | {r['shape']} | {r['compute_ms']:.2f} | "
                  f"{r['memory_ms']:.2f} | {r['collective_ms']:.2f} | "
                  f"**{r['dominant']}** | {_fmt(r['hbm_gb_per_dev'])} | "
                  f"{r.get('useful_ratio', 0):.2f} |")
    else:
        hdr = ("arch", "shape", "compute_ms", "memory_ms", "collective_ms",
               "dominant", "hbm_gb_per_dev", "useful_ratio")
        print(",".join(hdr))
        for r in table:
            print(",".join(f"{r.get(k, '')}" if not isinstance(r.get(k), float)
                           else f"{r[k]:.3f}" for k in hdr))


if __name__ == "__main__":
    main()
