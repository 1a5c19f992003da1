"""Static 'profile' of a saved dry-run module (the XLA HLO text the
reference's dry-run writes): the top flops / bytes / collective
contributors, trip-count weighted.  A copy of the reference's
``roofline/profile_hlo.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.profile_hlo \
      experiments/dryrun/smollm-360m__prefill_32k__16x16.hlo.gz [--top 15]
"""
from __future__ import annotations

import argparse
import gzip
import re

from repro_torch.roofline import hlo_analyzer as H


def instruction_costs(hlo: str):
    """Yield (flops, bytes, coll_bytes, trips, computation, instr) rows."""
    comps = H.parse_module(hlo)
    m = re.search(r"^ENTRY\s+%?([\w.\-]+)", hlo, re.MULTILINE)
    entry = m.group(1)

    # multiplier per computation = product of trip counts on the call path
    mult: dict[str, float] = {entry: 1.0}
    order = [entry]
    seen = {entry}
    while order:
        name = order.pop(0)
        comp = comps[name]
        for inst in comp.instrs.values():
            if inst.opcode == "while":
                cond, body = H.while_parts(inst)
                trips = H.trip_count(comps, cond, inst) if cond else 1
                for c in (body, cond):
                    if c in comps:
                        mult[c] = mult.get(c, 0.0) + mult[name] * trips
                        if c not in seen:
                            seen.add(c)
                            order.append(c)
            elif inst.opcode in ("call", "custom-call", "conditional"):
                for c in H.called_computations(inst):
                    if c in comps:
                        mult[c] = mult.get(c, 0.0) + mult[name]
                        if c not in seen:
                            seen.add(c)
                            order.append(c)

    rows = []
    for name, m_ in mult.items():
        comp = comps[name]
        for inst in comp.instrs.values():
            op = inst.opcode
            if op in H._FREE_OPS or op in ("while", "call", "conditional"):
                continue
            flops = bytes_ = coll = 0.0
            if op == "fusion":
                for c in H.called_computations(inst):
                    if c in comps:
                        flops += H._flops_in_fusion(comps[c], comps)
                dus = any(
                    comps[c].instrs.get(comps[c].root or "") is not None
                    and comps[c].instrs[comps[c].root].opcode == "dynamic-update-slice"
                    for c in H.called_computations(inst) if c in comps)
                if dus:
                    ob = [H.shape_bytes(comp.instrs[o].shape_str)
                          for o in inst.operands if o in comp.instrs]
                    bytes_ = 2 * (sum(ob) - max(ob)) if ob else 0
                else:
                    bytes_ = inst.out_bytes() + H.operand_bytes(inst, comp)
            elif op == "dynamic-update-slice":
                upd = (H.shape_bytes(comp.instrs[inst.operands[1]].shape_str)
                       if len(inst.operands) > 1 and inst.operands[1] in comp.instrs
                       else inst.out_bytes())
                bytes_ = 2 * upd
            else:
                base = op[:-6] if op.endswith("-start") else op
                if base in H.COLL_KINDS:
                    coll = inst.out_bytes()
                    bytes_ = coll + H.operand_bytes(inst, comp)
                elif base.endswith("-done") or base in ("copy-start", "copy-done"):
                    continue
                else:
                    if op in ("dot", "convolution"):
                        flops = H.dot_flops(inst, comp, comps)
                    bytes_ = inst.out_bytes() + H.operand_bytes(inst, comp)
            rows.append((flops * m_, bytes_ * m_, coll * m_, m_, name, inst))
    return rows


def describe(inst: H.Instr) -> str:
    meta = re.search(r'op_name="([^"]+)"', inst.raw)
    src = meta.group(1) if meta else ""
    return f"{inst.opcode:22s} {inst.shape_str[:46]:46s} {src[:70]}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--sort", choices=("bytes", "flops", "coll"), default="bytes")
    args = ap.parse_args()
    opener = gzip.open if args.path.endswith(".gz") else open
    with opener(args.path, "rt") as f:
        hlo = f.read()
    rows = instruction_costs(hlo)
    key = {"flops": 0, "bytes": 1, "coll": 2}[args.sort]
    rows.sort(key=lambda r: -r[key])
    tot = [sum(r[i] for r in rows) for i in range(3)]
    print(f"total: {tot[0]:.3e} flops, {tot[1]:.3e} bytes, {tot[2]:.3e} coll bytes")
    print(f"{'flops':>10s} {'bytes':>10s} {'coll':>10s} {'xtrips':>7s}  instruction")
    for fl, by, co, m_, comp, inst in rows[: args.top]:
        print(f"{fl:10.2e} {by:10.2e} {co:10.2e} {m_:7.0f}  {describe(inst)}")


if __name__ == "__main__":
    main()
