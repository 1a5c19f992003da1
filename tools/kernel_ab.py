#!/usr/bin/env python3
"""In-turns timing of the warp-per-sample statevector kernels against the
one-thread-per-sample kernels they replaced (commit 7c437f2), on one GPU.

    mkdir -p build/parent
    git archive 7c437f2 src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 tools/kernel_ab.py build/parent/src/repro_torch/kernels/csrc

Builds that commit's ``vqc_fused.cu``, ``vqc_shiftbank.cu`` and
``vqc_spill.cu`` with the port's nvcc flags into ``build/parent_kernels/``,
gives each old and new kernel the same inputs at the shape ``chip_smoke.py``
times it (``state`` 7q-3l, C = 4,176; ``shiftbank`` 7q-3l, B = 576, worker
0 of 4; ``shift_forward`` 13q-3l, B = 576, worker 0 of 2, the two depth
tiles the old footprint model cut), checks both against the plain version,
and times old, new, new, old through their C entry points: CUDA events
around 50 back-to-back launches, and the kernel's device time from
torch.profiler.  Then it times the new kernels at other samples a block
(``shiftbank`` 1-8 at 7q and at 13q-3l on 2 workers, ``shift_forward`` 1-8)
and the forward kernel at 1, 2 and 6 depth tiles (what the strided
[tile][re/im][amp][sample] boundary stores cost).  Prints a log and one JSON
line, also written to ``chiprun_out/kernel_ab.json``.
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
    TOL, device_ms, log, ptxas_spills, quclassi13, smi_line, time_ms)

ITERS = 50


def old_block(n_lanes: int, lane_bytes: int, budget: int) -> int:
    """The old kernels' circuits a block (their ``kernel_tb``): the largest
    power of two in [32, 1024] whose states fit, cut to the batch's
    power-of-two envelope."""
    tb = 1024
    while tb >= 32 and tb * lane_bytes > budget:
        tb //= 2
    if tb < 32:
        raise ValueError("a warp of the old kernel does not fit")
    return min(tb, max(32, 1 << (max(n_lanes, 1) - 1).bit_length()))


def build_parent(src_dir: Path) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("vqc_fused", "vqc_shiftbank", "vqc_spill"):
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
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    libs["vqc_fused"].vqc_state_launch.argtypes = (
        [vp, vp, i32, i32, i32, vp, vp, i32, i32, vp, vp, i32, i32, vp])
    libs["vqc_shiftbank"].vqc_shiftbank_launch.argtypes = (
        [vp, vp, i32, i32, i32, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp, i32, i32, vp])
    libs["vqc_spill"].vqc_shift_forward_launch.argtypes = (
        [vp, vp, i32, i32, i32, vp, vp, i32, i32, i32, i32, i32, i32, vp, vp, vp, i32, i32, vp])
    return libs


def split(tab) -> dict[str, np.ndarray]:
    """The segments of a walk table's int array."""
    sizes = {"data": 6 * tab.n_data_ops, "train": 6 * tab.n_train_ops,
             "bnd_of": tab.n_train_ops, "ckpt": tab.n_train_ops, "var": 5 * tab.n_variants,
             "tiles": 4 * tab.n_tiles, "f0": tab.n_f0_rows}
    out, at = {}, 0
    for name, size in sizes.items():
        out[name] = tab.ints[at : at + size]
        at += size
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs.quclassi_paper import get_quclassi
    from repro_torch.kernels import _build
    from repro_torch.kernels import vqc_statevector as K

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smi_line()
    log(f"device: {card}")
    old = build_parent(Path(sys.argv[1]).resolve())
    new = {name: K._lib(name) for name in ("vqc_fused", "vqc_shiftbank", "vqc_spill")}
    ptr, stream = _build.ptr, _build.stream(dev)
    rng = np.random.default_rng(0)
    budget = K.SMEM_BUDGET_BYTES

    def angles(spec, c):
        th = rng.uniform(-np.pi, np.pi, (c, spec.n_theta))
        dt = rng.uniform(0.0, np.pi, (c, spec.n_data))
        return (torch.tensor(th, dtype=torch.float32, device=dev),
                torch.tensor(dt, dtype=torch.float32, device=dev))

    def launched(rc: int) -> None:
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    def on_device(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    result = {"card": card}

    def compare(name, kernel, run_old, run_new, check):
        for run in (run_old, run_new):
            check(run)
        turns = [time_ms(run_old, ITERS), time_ms(run_new, ITERS), time_ms(run_new, ITERS),
                 time_ms(run_old, ITERS)]
        dev_turns = [device_ms(run_old, kernel, ITERS), device_ms(run_new, kernel, ITERS),
                     device_ms(run_new, kernel, ITERS), device_ms(run_old, kernel, ITERS)]
        log(f"compare {name}: events old {turns[0]:.4f} / {turns[3]:.4f} ms, new "
            f"{turns[1]:.4f} / {turns[2]:.4f} ms; device old {dev_turns[0]} / {dev_turns[3]}, "
            f"new {dev_turns[1]} / {dev_turns[2]} ms [{card}]")
        result[name] = {"old_ms": [turns[0], turns[3]], "new_ms": [turns[1], turns[2]],
                        "old_device_ms": [dev_turns[0], dev_turns[3]],
                        "new_device_ms": [dev_turns[1], dev_turns[2]]}

    def checker(out, want, rows=slice(None)):
        def check(run):
            out[rows] = float("nan")
            run()
            torch.cuda.synchronize()
            err = float((out[rows] - want).abs().max())
            if not err <= TOL:
                raise AssertionError(f"max|diff| to the plain version {err} > {TOL}")
        return check

    # ------------------------------------------------------------- state
    spec7 = get_quclassi("quclassi-7q-3l").spec
    c, n = 4176, spec7.n_qubits
    th, dt = angles(spec7, c)
    ops_i, ops_f = K._on_device(spec7, K._spec_table(spec7), dev)
    head = (ptr(th), ptr(dt), c, th.shape[1], dt.shape[1], ptr(ops_i), ptr(ops_f),
            len(spec7.ops), n)
    re, im = torch.empty((c, 2**n), device=dev), torch.empty((c, 2**n), device=dev)
    tb_old = old_block(c, K._state_bytes(n, 1), budget)
    warps, smem = K.fused_geometry(n, c)
    state_old = lambda: launched(old["vqc_fused"].vqc_state_launch(  # noqa: E731
        *head, ptr(re), ptr(im), tb_old, K._state_bytes(n, tb_old), stream))
    state_new = lambda: launched(new["vqc_fused"].vqc_state_launch(  # noqa: E731
        *head, ptr(re), ptr(im), warps, smem, stream))
    want_re, _ = K._fused_plain(spec7, th, dt, want_state=True)
    compare("state", "state_kernel", state_old, state_new, checker(re, want_re))

    # --------------------------------------------------------- shiftbank
    plan7 = K.build_shift_plan(spec7)
    shifts = K.shift_values(False)

    def shiftbank_case(spec, plan, groups, b):
        tab = K._walk_table(spec, False, groups, budget, False)
        seg = split(tab)
        old_ints = np.concatenate([seg["data"], seg["train"], seg["ckpt"], seg["var"], seg["f0"]])
        new_ints, floats, old_ints = on_device(tab.ints, tab.floats, old_ints)
        th, dt = angles(spec, b)
        out = torch.empty((len(groups), b), device=dev)
        n_ckpt = tab.n_ckpt[0]
        lane_old = (n_ckpt + 4) * K._state_bytes(plan.m, 1)
        tb = old_block(b, lane_old, budget) if 32 * lane_old <= budget else None
        common = (ptr(th), ptr(dt), b, th.shape[1], dt.shape[1])
        run_old = lambda: launched(old["vqc_shiftbank"].vqc_shiftbank_launch(  # noqa: E731
            *common, ptr(old_ints), ptr(floats), plan.m, tab.n_data_ops, tab.n_train_ops,
            n_ckpt, tab.n_variants, tab.n_f0_rows, tab.lowest, ptr(out), tb, tb * lane_old,
            stream))
        table = K.walk_table_bytes(plan, tab.n_variants)

        def run_new(w=tab.tb):
            launched(new["vqc_shiftbank"].vqc_shiftbank_launch(
                *common, ptr(new_ints), ptr(floats), plan.m, tab.n_data_ops, tab.n_train_ops,
                tab.n_variants, tab.n_f0_rows, tab.lowest, ptr(out), w,
                table + K.walk_smem_bytes(plan.m, n_ckpt, w), stream))
        want = K._shiftbank_plain(plan, shifts, groups, spec.n_theta, th, dt)
        # the launches take raw addresses: keep the tensors alive with them
        return run_old, run_new, checker(out, want), tb, (th, dt, out, new_ints, old_ints, floats)

    worker0 = tuple(range(0, 1 + 2 * spec7.n_theta, 4))
    run_old, run_new, check, tb, alive = shiftbank_case(spec7, plan7, worker0, 576)
    compare("shiftbank", "shiftbank_kernel", run_old, run_new, check)
    result["shiftbank"]["old_block"] = tb
    cfg13, _, worker_groups13 = quclassi13()
    spec13 = cfg13.spec
    plan13 = K.build_shift_plan(spec13)
    sweeps = {}
    for label, case in (("7q-3l", (spec7, plan7, worker0)),
                        ("13q-3l", (spec13, plan13, worker_groups13[0]))):
        _, run_new, check, _, alive = shiftbank_case(*case, 576)
        sweeps[label] = {}
        for w in (1, 2, 4, 8):
            check(lambda w=w: run_new(w))
            sweeps[label][w] = [time_ms(lambda w=w: run_new(w), ITERS)]
        for w in (8, 4, 2, 1):
            sweeps[label][w].append(time_ms(lambda w=w: run_new(w), ITERS))
        for w, ts in sweeps[label].items():
            log(f"  shiftbank {label} B=576, {w} samples a block: {ts[0]:.4f} / {ts[1]:.4f} ms "
                f"[{card}]")
    result["shiftbank"]["warps_sweep_ms"] = sweeps

    # ----------------------------------------------------- shift_forward
    groups = worker_groups13[0]
    sweep_tab = K._walk_table(spec13, False, groups, budget, False)
    table13 = K.walk_table_bytes(plan13, sweep_tab.n_variants)
    th, dt = angles(spec13, 576)
    dim = 2**plan13.m
    per_tiles = {}
    for n_ckpt in (16, 11, 3):  # 1, 2 (the old footprint model's) and 6 tiles
        tab = K._walk_table(spec13, False, groups, table13 + K.walk_smem_bytes(6, n_ckpt, 4), True)
        seg = split(tab)
        old_ints = np.concatenate([seg["data"], seg["train"], seg["bnd_of"], seg["ckpt"],
                                   seg["tiles"], seg["var"], seg["f0"]])
        new_ints, floats, old_ints = on_device(tab.ints, tab.floats, old_ints)
        out = torch.empty((len(groups), 576), device=dev)
        d_state = torch.empty((2 * dim, 576), device=dev)
        bnd = torch.empty((2 * tab.n_tiles * dim, 576), device=dev)
        common = (ptr(th), ptr(dt), 576, th.shape[1], dt.shape[1])
        tail = (plan13.m, tab.n_data_ops, tab.n_train_ops, tab.n_tiles, tab.n_variants,
                tab.n_f0_rows, ptr(out), ptr(d_state), ptr(bnd))
        tb = old_block(576, 2 * K._state_bytes(plan13.m, 1), budget)
        run_old = lambda: launched(old["vqc_spill"].vqc_shift_forward_launch(  # noqa: E731
            *common, ptr(old_ints), ptr(floats), *tail, tb, tb * 2 * K._state_bytes(6, 1),
            stream))

        def run_new(w=tab.forward_tb, tab=tab, new_ints=new_ints, floats=floats, common=common,
                    tail=tail):
            launched(new["vqc_spill"].vqc_shift_forward_launch(
                *common, ptr(new_ints), ptr(floats), *tail, w,
                table13 + 2 * K._state_bytes(6, w), stream))
        _, want_d, want_bnd = K._shift_forward_plain(plan13, [lo for lo, _ in tab.tiles], th, dt)
        check = checker(bnd, want_bnd)
        check_d = checker(d_state, want_d)
        if tab.n_tiles == 2:
            check_d(run_old)
            check_d(run_new)
            compare("shift_forward", "shift_forward_kernel", run_old, run_new, check)
            result["shift_forward"]["old_block"] = tb
            sweep = {}
            for w in (1, 2, 4, 8):
                check(lambda w=w: run_new(w))
                sweep[w] = [time_ms(lambda w=w: run_new(w), ITERS)]
            for w in (8, 4, 2, 1):
                sweep[w].append(time_ms(lambda w=w: run_new(w), ITERS))
            for w, ts in sweep.items():
                log(f"  shift_forward 13q-3l B=576, {w} samples a block: {ts[0]:.4f} / "
                    f"{ts[1]:.4f} ms [{card}]")
            result["shift_forward"]["warps_sweep_ms"] = sweep
        check(run_new)
        per_tiles[tab.n_tiles] = [time_ms(run_new, ITERS), device_ms(run_new,
                                                                      "shift_forward_kernel",
                                                                      ITERS)]
        log(f"  shift_forward 13q-3l B=576, {tab.n_tiles} tiles ({tab.n_tiles + 1} strided "
            f"state stores a sample): events {per_tiles[tab.n_tiles][0]:.4f} ms, device "
            f"{per_tiles[tab.n_tiles][1]} ms [{card}]")
    result["shift_forward"]["by_tiles_ms"] = per_tiles
    log(card)
    line = json.dumps({"kernel_ab": result})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_ab.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
