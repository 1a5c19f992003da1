#!/usr/bin/env python3
"""In-turns timing of the redesigned kernels against the kernels they
replaced, on one GPU.

    mkdir -p build/parent
    git archive <old commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 tools/redesign_ab.py build/parent/src/repro_torch/kernels/csrc [PART ...]

PART is one or more of ``flash``, ``dmem``, ``dmem_shapes`` and
``shift_dmem`` (default: all).  Builds the old sources the parts need
(``flash_attn.cu``, ``vqc_fused.cu``, ``vqc_shift_dmem.cu``) with the
port's nvcc flags into ``build/parent_kernels/`` and gives old and new
kernels the same inputs:

  * flash, float32: the causal prefill shapes of ``chip_smoke.FLASH_SHAPES``
    (4 requests x 2048 tokens), each old and new against the plain version
    and timed old, new, new, old (CUDA events around back-to-back launches
    through the C entry points, and the kernel's device time from
    torch.profiler), beside one float32 ``scaled_dot_product_attention``
    call (timed only);
  * the device-memory route: 1-layer QuClassi P(0) and state at 15q
    (C = 256), 17q (C = 256 and C = 8) and 19q (C = 64), in the same turns;
    then the new route's launch shape alone: ``DMEM_THREADS`` 256 / 512 /
    1024, the cluster capped at 1 (one block a circuit) or not, and k = 12 /
    13 / 14 local qubits;
  * the shift walk's device-memory kernel (``shift_dmem_kernel``): QuClassi
    27q-1l, 27q-3l (B = 100 and 1,152), 29q-1l and 33q-1l (B = 100), each
    the whole bank and each worker's groups of the 2-worker round robin,
    old and new rows held equal bit for bit (``torch.equal``), the whole
    banks and every bank at B = 1,152 timed old, new, new, old.  The old
    kernel runs on its own geometry (one chunk of shared memory, every slot
    in scratch, 512 threads), its launches split by samples as its wrapper
    split them.

Prints a log and writes its records to ``chiprun_out/redesign_ab.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from chip_smoke import (  # noqa: E402
    FLASH_SHAPES, FLASH_TOL, PEAK_BYTES_PER_S, TOL, bound, device_ms, first_shift_traffic,
    flash_inputs, log, ptxas_spills, smi_line, time_ms)

DMEM_SHAPES = ((15, 256), (17, 256), (17, 8), (19, 64))
#: the shift walk's A/B: (label, qubits, layers, batch sizes)
SHIFT_SHAPES = (("27q-1l", 27, 1, (100,)), ("27q-3l", 27, 3, (100, 1152)),
                ("29q-1l", 29, 1, (100,)), ("33q-1l", 33, 1, (100,)))
#: the libraries each part needs from the parent
PARENT_LIBS = {"flash": ("flash_attn",), "dmem": ("vqc_fused",), "dmem_shapes": (),
               "shift_dmem": ("vqc_shift_dmem",)}


def build_parent(src_dir: Path, names) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
               str(src_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{text}")
        log(f"parent {name}: ptxas spills {ptxas_spills(text)}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        _build.declare(libs[name], src_dir / f"{name}.cu")
    return libs


def turns(old, new, kernel: str, iters: int) -> dict:
    """old, new, new, old: events ms each, then profiled device ms of each."""
    ms = [time_ms(f, iters=iters, warmup=2) for f in (old, new, new, old)]
    return {"old_ms": [ms[0], ms[3]], "new_ms": [ms[1], ms[2]],
            "old_device_ms": device_ms(old, kernel, iters=iters),
            "new_device_ms": device_ms(new, kernel, iters=iters)}


def flash_ab(libs, dev, card: str) -> list:
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for label, b, h, kv, s, hd in FLASH_SHAPES:
        g = h // kv
        q, k, v = (t.float() for t in flash_inputs(b * h, s, hd, torch.bfloat16, g, dev, 99))
        old_out = torch.empty_like(q)

        def old():
            rc = libs["flash_attn"].flash_attn_launch(
                _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(old_out), b * h, s, hd,
                g, 1, 0, _build.stream(dev))
            if rc:
                raise RuntimeError(f"old flash launch failed: {rc}")
            return old_out

        def new():
            return FA.flash_attention(q, k, v, groups=g)

        want = FA._flash_plain(q, k, v, groups=g)
        errs = [float((f().float() - want).abs().max()) for f in (old, new)]
        if max(errs) > FLASH_TOL[torch.float32]:
            raise AssertionError(f"flash {label}: max|diff| old/new {errs}")
        q4, k4, v4 = q.view(b, h, s, hd), k.view(b, kv, s, hd), v.view(b, kv, s, hd)
        library = lambda: sdpa(q4, k4, v4, is_causal=True, scale=1.0, enable_gqa=True)  # noqa: E731
        lib_err = float((library().reshape(b * h, s, hd) - want).abs().max())
        rec = {"shape": label, "bh": b * h, "s": s, "hd": hd, "groups": g,
               "max_abs_err_old": errs[0], "max_abs_err_new": errs[1],
               **turns(old, new, "flash_fwd_kernel", iters=10),
               "sdpa_f32_ms": time_ms(library, iters=10), "sdpa_f32_max_abs_diff": lib_err}
        flops = 4 * b * h * hd * s * (s + 1) // 2
        rec["bound_ms"], rec["bound_by"] = bound(flops, 4 * (2 * b * h + 2 * b * kv) * s * hd)
        out.append(rec)
        log(f"flash f32 {json.dumps(rec)} [{card}]")
    return out


def dmem_ab(libs, dev, card: str) -> list:
    from repro_torch.core import circuits
    from repro_torch.kernels import _build
    from repro_torch.kernels import vqc_statevector as K

    ptr, st = _build.ptr, _build.stream
    out = []
    for qc, c in DMEM_SHAPES:
        spec = circuits.build_quclassi_circuit(qc, 1)
        rng = np.random.default_rng(qc + c)
        th = torch.tensor(rng.uniform(-np.pi, np.pi, (c, spec.n_theta)), dtype=torch.float32,
                          device=dev)
        dt = torch.tensor(rng.uniform(0.0, np.pi, (c, spec.n_data)), dtype=torch.float32,
                          device=dev)
        ops_i, ops_f = (torch.from_numpy(a).to(dev) for a in K._spec_table(spec))
        n_ops, dim = len(spec.ops), 2**qc
        work = torch.empty((c, 2, dim), dtype=torch.float32, device=dev)
        p0_old = torch.empty((c,), dtype=torch.float32, device=dev)
        re_old = torch.empty((c, dim), dtype=torch.float32, device=dev)
        im_old = torch.empty_like(re_old)
        smem = 4 * (2 * n_ops + 1024 // 32)
        lib = libs["vqc_fused"]

        def old_p0():
            rc = lib.vqc_fidelity_dmem_launch(
                ptr(th), ptr(dt), c, th.shape[1], dt.shape[1], ptr(ops_i), ptr(ops_f), n_ops,
                qc, ptr(work), ptr(p0_old), 1024, smem, st(dev))
            if rc:
                raise RuntimeError(f"old fidelity_dmem launch failed: {rc}")
            return p0_old

        def old_state():
            rc = lib.vqc_state_dmem_launch(
                ptr(th), ptr(dt), c, th.shape[1], dt.shape[1], ptr(ops_i), ptr(ops_f), n_ops,
                qc, ptr(re_old), ptr(im_old), 1024, smem, st(dev))
            if rc:
                raise RuntimeError(f"old state_dmem launch failed: {rc}")
            return re_old, im_old

        def new_p0():
            return K.vqc_p0(spec, th, dt)

        def new_state():
            return K.vqc_state(spec, th, dt)

        want = K._fused_plain(spec, th, dt, False)
        pre, pim = K._fused_plain(spec, th, dt, True)
        err_p0 = [float((f() - want).abs().max()) for f in (old_p0, new_p0)]
        (ore, oim), (nre, nim) = old_state(), new_state()
        err_state = [max(float((a - pre).abs().max()), float((b - pim).abs().max()))
                     for a, b in ((ore, oim), (nre, nim))]
        same = bool(torch.equal(ore, nre) and torch.equal(oim, nim))
        if max(err_p0 + err_state) > TOL:
            raise AssertionError(f"{qc}q C={c}: P0 errs {err_p0}, state errs {err_state}")
        del pre, pim, ore, oim, nre, nim
        iters = 5 if qc < 19 else 3
        n_pass, p0_bytes = K.dmem_traffic_bytes(spec, False)
        _, state_bytes = K.dmem_traffic_bytes(spec, True)
        rec = {"q": qc, "C": c, "passes": n_pass,
               "cluster": K.dmem_geometry(spec, c, _build.sm_count(dev))[0],
               "p0_bytes": c * p0_bytes, "state_bytes": c * state_bytes,
               "p0_traffic_ms": c * p0_bytes / PEAK_BYTES_PER_S * 1e3,
               "err_p0": err_p0, "err_state": err_state, "state_equal_old": same,
               "fidelity": turns(old_p0, new_p0, "fidelity_dmem_kernel", iters),
               "state": turns(old_state, new_state, "state_dmem_kernel", iters)}
        out.append(rec)
        log(f"dmem {json.dumps(rec)} [{card}]")
    return out


def dmem_shapes(dev, card: str) -> list:
    """The new route alone at other launch shapes, P(0) at 17q C = 256 and
    C = 8 and 19q C = 64: every result the bits of the default shape."""
    from repro_torch.core import circuits
    from repro_torch.kernels import _build
    from repro_torch.kernels import vqc_statevector as K

    out = []
    defaults = (K.DMEM_THREADS, K.DMEM_MAX_CLUSTER, K.DMEM_LOCAL_QUBITS)
    for qc, c in ((17, 256), (17, 8), (19, 64)):
        spec = circuits.build_quclassi_circuit(qc, 1)
        rng = np.random.default_rng(qc)
        th = torch.tensor(rng.uniform(-np.pi, np.pi, (c, spec.n_theta)), dtype=torch.float32,
                          device=dev)
        dt = torch.tensor(rng.uniform(0.0, np.pi, (c, spec.n_data)), dtype=torch.float32,
                          device=dev)
        base = K.vqc_p0(spec, th, dt)
        for threads in (256, 512, 1024):
            for cap in (1, 8):
                for k in (12, 13, 14):
                    K.DMEM_THREADS, K.DMEM_MAX_CLUSTER, K.DMEM_LOCAL_QUBITS = threads, cap, k
                    got = K.vqc_p0(spec, th, dt)
                    err = float((got - base).abs().max())
                    ms = time_ms(lambda: K.vqc_p0(spec, th, dt), iters=5, warmup=1)
                    rec = {"q": qc, "C": c, "threads": threads, "cluster_cap": cap, "k": k,
                           "cluster": K.dmem_geometry(spec, c, _build.sm_count(dev), k)[0],
                           "passes": len(K.dmem_plan(spec, k)), "ms": ms,
                           "max_abs_diff_to_default": err}
                    out.append(rec)
                    log(f"dmem shape {json.dumps(rec)} [{card}]")
                    if err > TOL:
                        raise AssertionError(f"dmem shape {rec}: P0 off by {err}")
        K.DMEM_THREADS, K.DMEM_MAX_CLUSTER, K.DMEM_LOCAL_QUBITS = defaults
    return out


def old_shift_geometry(K, walk, b: int) -> tuple[int, int, int]:
    """The replaced kernel's (shared-memory bytes, scratch bytes a sample,
    samples a launch): one chunk, every slot in scratch."""
    smem = (4 * (2 * 2**walk.k + 2 * walk.n_angles + 2 * walk.max_pass_ops)
            + 8 * (256 + 64) + 4 * 32)
    sample = walk.n_slots * K._state_bytes(walk.m, 1)
    return smem, sample, max(1, min(b, K.SHIFT_DMEM_WORKSPACE_BYTES // sample))


def shift_dmem_ab(libs, dev, card: str) -> dict:
    from repro_torch.comanager import dataplane
    from repro_torch.core import circuits
    from repro_torch.kernels import _build
    from repro_torch.kernels import vqc_statevector as K

    ptr, st = _build.ptr, _build.stream
    lib = libs["vqc_shift_dmem"]
    rows = []
    for label, qc, nl, sizes in SHIFT_SHAPES:
        spec = circuits.build_quclassi_circuit(qc, nl)
        n_groups = 1 + 2 * spec.n_theta
        assign = dataplane.round_robin_assignment(n_groups, 2)
        sets = [tuple(range(n_groups))] + [
            tuple(g for g in range(n_groups) if assign[g] == w) for w in range(2)]
        for b in sizes:
            rng = np.random.default_rng(qc + nl + b)
            th = torch.tensor(rng.uniform(-np.pi, np.pi, (b, spec.n_theta)),
                              dtype=torch.float32, device=dev)
            dt = torch.tensor(rng.uniform(0.0, np.pi, (b, spec.n_data)), dtype=torch.float32,
                              device=dev)
            for gs in sets:
                walk = K._shift_route(spec, False, gs, K.SMEM_BUDGET_BYTES)
                tabs = _build.on_device(walk, (walk.passes, walk.stage, walk.pass_ops,
                                                walk.pass_refs, walk.base_ops,
                                                walk.base_consts, walk.var_param,
                                                walk.var_shift, walk.f0_rows), dev)
                passes, _, pass_ops, pass_refs, base_ops, base_consts, vp_, vs_, f0 = tabs
                smem, sample, per = old_shift_geometry(K, walk, b)
                scratch = torch.empty((per, sample // 4), dtype=torch.float32, device=dev)
                old_out = torch.empty((walk.n_rows, b), dtype=torch.float32, device=dev)

                def old(walk=walk, th=th, dt=dt, smem=smem, sample=sample, per=per,
                        scratch=scratch, old_out=old_out, passes=passes, pass_ops=pass_ops,
                        pass_refs=pass_refs, base_ops=base_ops, base_consts=base_consts,
                        vp_=vp_, vs_=vs_, f0=f0):
                    for b0 in range(0, th.shape[0], per):
                        n = min(per, th.shape[0] - b0)
                        rc = lib.vqc_shift_dmem_launch(
                            ptr(th[b0:b0 + n]), ptr(dt[b0:b0 + n]), n, th.shape[1],
                            dt.shape[1], ptr(base_ops), ptr(base_consts), len(walk.ops),
                            ptr(vp_), ptr(vs_), len(walk.var_param), ptr(passes),
                            len(walk.passes), ptr(pass_ops), ptr(pass_refs),
                            walk.max_pass_ops, ptr(f0), len(walk.f0_rows), walk.m, walk.k,
                            ptr(scratch), sample // 4, ptr(old_out), th.shape[0], b0, 512,
                            smem, st(dev))
                        if rc:
                            raise RuntimeError(f"old shift_dmem launch failed: {rc}")
                    return old_out

                def new(spec=spec, th=th, dt=dt, gs=gs):
                    return K.vqc_shift_fidelity(spec, th, dt, groups=gs)

                got_old, got_new = old().clone(), new()
                same = bool(torch.equal(got_old, got_new))
                rec = {"shape": label, "B": b, "G": len(gs), "m": walk.m,
                       "passes": len(walk.passes), "bit_equal": same,
                       "max_abs_diff": float((got_old - got_new).abs().max()),
                       "old_traffic_bytes": b * first_shift_traffic(K, walk),
                       "new_traffic_bytes": b * K.shift_dmem_traffic_bytes(walk),
                       "old_smem": smem, "new_smem": K.shift_dmem_geometry(walk, b)[1]}
                timed = b == 1152 or len(gs) == n_groups
                if timed:
                    rec.update(turns(old, new, "shift_dmem_kernel", iters=5 if b > 100 else 10))
                rows.append(rec)
                log(f"shift_dmem {json.dumps(rec)} [{card}]")
                if not same:
                    raise AssertionError(f"shift_dmem {label} B={b} G={len(gs)}: old and new "
                                         "rows differ")
                del scratch, old_out, got_old, got_new
    return {"rows": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("redesign_ab: CUDA is not available", file=sys.stderr)
        return 1
    parts = sys.argv[2:] or list(PARENT_LIBS)
    if len(sys.argv) < 2 or set(parts) - set(PARENT_LIBS):
        print(__doc__, file=sys.stderr)
        return 2
    dev, card = torch.device("cuda", 0), smi_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_parent(Path(sys.argv[1]), sorted({n for p in parts for n in PARENT_LIBS[p]}))
    result = {"card": card}
    if "flash" in parts:
        result["flash_f32"] = flash_ab(libs, dev, card)
    if "dmem" in parts:
        result["dmem"] = dmem_ab(libs, dev, card)
    if "dmem_shapes" in parts:
        result["dmem_shapes"] = dmem_shapes(dev, card)
    if "shift_dmem" in parts:
        result["shift_dmem"] = shift_dmem_ab(libs, dev, card)
    out = ROOT / "chiprun_out" / "redesign_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    log(f"wrote {out.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
