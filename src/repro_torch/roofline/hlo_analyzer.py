"""Trip-count-aware static analysis of optimized HLO text (a copy of the
reference's ``roofline/hlo_analyzer.py``: the port keeps it to read the
reference's dry-run artifacts, ``*.hlo.gz``; its own dry-run counts a torch
step with ``roofline/op_counter.py``).

WHY: ``compiled.cost_analysis()`` counts a ``while`` body ONCE, regardless of
trip count (verified empirically: a scan of 10 matmuls reports the flops of
one).  Every model here scans over layer periods (and the train step scans
over microbatches), so raw cost_analysis under-reports flops/bytes/collective
traffic by 1-3 orders of magnitude.  This module parses ``compiled.as_text()``
into computations, extracts while-loop trip counts from their condition
computations, and walks the call graph multiplying costs by trip counts.

Cost model per instruction (HBM-level, fusion-aware):
  flops       : dot/convolution = 2 * prod(output_shape) * contraction size
                (counted INSIDE fused computations too — XLA fuses dots into
                output fusions);
  bytes       : for a top-level instruction, output bytes + operand bytes.
                A ``fusion`` op counts only its operands + outputs (fused
                interiors never touch HBM — that is what fusion means).
                parameter/constant/gte/tuple/bitcast count zero.
  collectives : output bytes of all-gather / all-reduce / reduce-scatter /
                all-to-all / collective-permute(+ -start variants), attributed
                to the computation they appear in (so loop collectives get
                multiplied by trip count).

This is a static-analysis approximation of XLA's own cost model, NOT a
simulator; its purpose is relative roofline terms, and it is validated
against hand-computable modules in tests/test_hlo_analyzer.py.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "s4": 1, "u4": 1, "pred": 1, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

#: ops that move no HBM bytes themselves
_FREE_OPS = {"parameter", "constant", "get-tuple-element", "tuple", "bitcast",
             "after-all", "partition-id", "replica-id", "iota"}

_SHAPE_TOKEN = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


@dataclasses.dataclass
class Instr:
    name: str
    opcode: str
    shape_str: str            # full result type string (may be a tuple)
    operands: list
    raw: str

    def out_bytes(self) -> int:
        return shape_bytes(self.shape_str)


@dataclasses.dataclass
class Computation:
    name: str
    instrs: dict
    root: Optional[str] = None

    def instr(self, name: str) -> Optional[Instr]:
        return self.instrs.get(name)


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)

    def __iadd__(self, other: "Cost"):
        self.flops += other.flops
        self.bytes += other.bytes
        self.coll_bytes += other.coll_bytes
        for k, v in other.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0.0) + v
        return self

    def scaled(self, m: float) -> "Cost":
        return Cost(self.flops * m, self.bytes * m, self.coll_bytes * m,
                    {k: v * m for k, v in self.coll_by_kind.items()})


def shape_bytes(shape_str: str) -> int:
    """Total bytes of every typed array in a (possibly tuple) type string."""
    total = 0
    for m in _SHAPE_TOKEN.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def shape_dims(shape_str: str) -> list[int]:
    m = _SHAPE_TOKEN.search(shape_str)
    if not m or not m.group(2):
        return []
    return [int(d) for d in m.group(2).split(",") if d]


# --------------------------------------------------------------- parsing
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*->.*{\s*$")
_INSTR_HEAD = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*")
_OPCODE = re.compile(r"\s*([\w\-]+)\(")
_OPERAND = re.compile(r"%([\w.\-]+)")


def _split_type_opcode(rest: str):
    """``rest`` starts at the result type.  Returns (type_str, opcode, tail)
    or None.  Handles tuple types with nested parens/braces and embedded
    ``/*index=N*/`` comments, and scalar types like ``bf16[2,3]{1,0}``."""
    if rest.startswith("("):
        depth = 0
        for i, ch in enumerate(rest):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    type_str = rest[:i + 1]
                    m = _OPCODE.match(rest[i + 1:])
                    if not m:
                        return None
                    tail_start = i + 1 + m.end()
                    return type_str, m.group(1), rest[tail_start:]
        return None
    # scalar/array type: ends at whitespace not inside brackets
    depth = 0
    for i, ch in enumerate(rest):
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == " " and depth == 0:
            type_str = rest[:i]
            m = _OPCODE.match(rest[i:])
            if not m:
                return None
            return type_str, m.group(1), rest[i + m.end():]
    return None


def parse_module(hlo: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in hlo.splitlines():
        stripped = line.rstrip()
        if not stripped:
            continue
        # computation headers have no " = " before the arrow (instruction
        # lines do); tuple params may contain /*index=N*/ comments, so test
        # for the spaced form only.
        if (stripped.endswith("{") and "->" in stripped
                and " = " not in stripped.split("->")[0]):
            m = _COMP_HDR.match(stripped.strip())
            if m:
                cur = Computation(m.group(1), {})
                comps[cur.name] = cur
                continue
        if stripped.strip() == "}":
            cur = None
            continue
        if cur is None:
            continue
        m = _INSTR_HEAD.match(stripped)
        if not m:
            continue
        name = m.group(1)
        parts = _split_type_opcode(stripped[m.end():])
        if parts is None:
            continue
        shape_str, opcode, tail = parts
        # operand names: up to the closing paren of the operand list
        depth, end = 1, len(tail)
        for i, ch in enumerate(tail):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        ops = _OPERAND.findall(tail[:end])
        inst = Instr(name, opcode, shape_str, ops, stripped)
        cur.instrs[name] = inst
        if stripped.lstrip().startswith("ROOT"):
            cur.root = name
    return comps


_CALLED = re.compile(r"(?:condition|body|to_apply|calls|branch_computations)="
                     r"(?:{([^}]*)}|%?([\w.\-]+))")
_TRIP_CONST = re.compile(r"constant\((\d+)\)")


def called_computations(instr: Instr) -> list[str]:
    out = []
    for m in _CALLED.finditer(instr.raw):
        if m.group(1) is not None:
            out += [x.strip().lstrip("%") for x in m.group(1).split(",")]
        else:
            out.append(m.group(2))
    return out


def while_parts(instr: Instr) -> tuple[Optional[str], Optional[str]]:
    cond = re.search(r"condition=%?([\w.\-]+)", instr.raw)
    body = re.search(r"body=%?([\w.\-]+)", instr.raw)
    return (cond.group(1) if cond else None, body.group(1) if body else None)


_KNOWN_TRIPS = re.compile(r'"known_trip_count":{"n":"(\d+)"}')


def trip_count(comps: dict, cond_name: str,
               while_instr: Optional[Instr] = None) -> int:
    """Loop bound: prefer the compiler's own ``known_trip_count`` backend
    config on the while op; fall back to the largest integer constant in the
    condition computation (scan lowers to ``compare(%induction, %constant),
    direction=LT`` with init 0, step 1)."""
    if while_instr is not None:
        m = _KNOWN_TRIPS.search(while_instr.raw)
        if m:
            return int(m.group(1))
    comp = comps.get(cond_name)
    if comp is None:
        return 1
    consts = []
    for inst in comp.instrs.values():
        for m in _TRIP_CONST.finditer(inst.raw):
            consts.append(int(m.group(1)))
    return max(consts) if consts else 1


# ------------------------------------------------------------- cost walk
def dot_flops(instr: Instr, comp: Computation, comps: dict) -> float:
    """2 * prod(out) * contracted size.  Contracted size from an operand's
    shape and the lhs_contracting_dims annotation."""
    out_dims = shape_dims(instr.shape_str)
    m = re.search(r"lhs_contracting_dims={([0-9,]*)}", instr.raw)
    lhs = _operand_shape(instr, 0, comp, comps)
    if m is None or lhs is None:
        return 2.0 * _prod(out_dims)
    contract = 1
    for d in m.group(1).split(","):
        if d and int(d) < len(lhs):
            contract *= lhs[int(d)]
    # batch dims are shared between out and lhs; out already includes them
    return 2.0 * _prod(out_dims) * contract


def _prod(dims) -> float:
    p = 1.0
    for d in dims:
        p *= d
    return p


def _operand_shape(instr: Instr, idx: int, comp: Computation, comps: dict):
    if idx >= len(instr.operands):
        return None
    name = instr.operands[idx]
    target = comp.instr(name)
    if target is None:
        return None
    return shape_dims(target.shape_str)


def operand_bytes(instr: Instr, comp: Computation) -> int:
    total = 0
    for name in instr.operands:
        t = comp.instr(name)
        if t is not None:
            total += shape_bytes(t.shape_str)
    return total


def _flops_in_fusion(comp: Computation, comps: dict) -> float:
    f = 0.0
    for inst in comp.instrs.values():
        if inst.opcode in ("dot", "convolution"):
            f += dot_flops(inst, comp, comps)
        elif inst.opcode == "fusion":
            for c in called_computations(inst):
                if c in comps:
                    f += _flops_in_fusion(comps[c], comps)
    return f


def computation_cost(comps: dict, name: str, memo: dict) -> Cost:
    if name in memo:
        return memo[name]
    comp = comps[name]
    cost = Cost()
    for inst in comp.instrs.values():
        op = inst.opcode
        if op in _FREE_OPS:
            continue
        if op == "while":
            cond, body = while_parts(inst)
            trips = trip_count(comps, cond, inst) if cond else 1
            if body in comps:
                cost += computation_cost(comps, body, memo).scaled(trips)
            if cond in comps:
                cost += computation_cost(comps, cond, memo).scaled(trips)
            continue
        if op in ("conditional",):
            # count the most expensive branch once
            branches = [computation_cost(comps, c, memo)
                        for c in called_computations(inst) if c in comps]
            if branches:
                cost += max(branches, key=lambda c: c.flops + c.bytes)
            continue
        if op in ("call", "custom-call") :
            for c in called_computations(inst):
                if c in comps:
                    cost += computation_cost(comps, c, memo)
            cost.bytes += inst.out_bytes() + operand_bytes(inst, comp)
            continue
        if op == "fusion":
            dus_root = False
            for c in called_computations(inst):
                if c in comps:
                    cost.flops += _flops_in_fusion(comps[c], comps)
                    root = comps[c].instrs.get(comps[c].root or "")
                    if root is not None and root.opcode == "dynamic-update-slice":
                        dus_root = True
            if dus_root:
                # in-place scatter into a carried buffer (scan stacking):
                # the big buffer is aliased, traffic = the small operands
                # (the update slice) read + written, NOT the whole buffer.
                ob = [shape_bytes(comp.instrs[o].shape_str)
                      for o in inst.operands if o in comp.instrs]
                cost.bytes += 2 * (sum(ob) - max(ob)) if ob else 0
            else:
                cost.bytes += inst.out_bytes() + operand_bytes(inst, comp)
            continue

        base = op[:-len("-start")] if op.endswith("-start") else op
        if base in COLL_KINDS:
            b = inst.out_bytes()
            cost.coll_bytes += b
            cost.coll_by_kind[base] = cost.coll_by_kind.get(base, 0.0) + b
            cost.bytes += b + operand_bytes(inst, comp)
            continue
        if base.endswith("-done") or base in ("copy-start", "copy-done"):
            continue
        if op == "dynamic-update-slice":
            # in-place: read + write the update slice only (operand 1)
            upd = (shape_bytes(comp.instrs[inst.operands[1]].shape_str)
                   if len(inst.operands) > 1 and inst.operands[1] in comp.instrs
                   else inst.out_bytes())
            cost.bytes += 2 * upd
            continue
        if op in ("dot", "convolution"):
            cost.flops += dot_flops(inst, comp, comps)
        cost.bytes += inst.out_bytes() + operand_bytes(inst, comp)
    memo[name] = cost
    return cost


def analyze(hlo: str) -> Cost:
    """Whole-module cost, trip-count aware, starting from ENTRY."""
    comps = parse_module(hlo)
    entry = None
    m = re.search(r"^ENTRY\s+%?([\w.\-]+)", hlo, re.MULTILINE)
    if m:
        entry = m.group(1)
    if entry is None or entry not in comps:
        # fall back: computation named like main
        entry = next((n for n in comps if "main" in n), None)
    if entry is None:
        raise ValueError("could not find ENTRY computation")
    # computations reachable via fusions shouldn't be double counted; the
    # memoized walk only follows explicit calls from ENTRY.
    return computation_cost(comps, entry, {})
