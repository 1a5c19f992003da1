#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — every CUDA kernel compiled from ``src/repro_torch/kernels/csrc``
               (one nvcc per source, all at once);
  3. kernels — each kernel against its plain PyTorch version on the card
               (max |diff| <= 1e-5) and against the dense simulator on a
               small input, then timed at the shape the training path gives
               it, beside the plain version and the analytic bound;
  4. train   — QuClassi Algorithm 1 on ``quclassi-7q-3l`` through the data
               plane's ``worker_batched_executor`` (4 workers, 3 steps of 64
               images), once with implicit banks (shift kernel) and once
               materialized (fused kernel), after one warm-up step each.
               Launch counts are zeroed just before each run and read just
               after; then one profiled gradient step per mode shows where
               the time goes.
The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  Needs CUDA; without it, or without the
repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = 1e-5  # float32 fidelities: the reference's own kernel tolerance
#: H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: float32 operations per amplitude of one gate application: a rotation
#: updates each amplitude with 2 products and 1 sum for re and for im; a
#: controlled rotation touches half the amplitudes; H is 1 sum and 1
#: product per component; CSWAP only moves data.
FLOPS_PER_AMP = {"rx": 6, "ry": 6, "rz": 6, "ryy": 6, "rzz": 6,
                 "cry": 3, "crz": 3, "h": 4, "cswap": 0}
INNER_FLOPS_PER_AMP = 8  # |<chi|phi>|^2: 4 products, 4 sums per amplitude


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ops_flops(ops, n: int) -> int:
    return sum(FLOPS_PER_AMP[op.gate] for op in ops) * 2**n


def shift_flops(K, plan, groups, n_params: int) -> int:
    """Per-sample flops of the shift kernel for ``groups``: the gate
    applications ``plan_gate_apps`` counts, each on 2**m amplitudes, plus
    one inner product for f0 and one per variant."""
    shifts = K.shift_values(False)
    variants = K._collect_variants(plan, shifts, groups, n_params)
    anchors = sorted(k for k in variants if k >= 0)
    ops = list(plan.data_ops) + list(plan.train_ops)
    n_inner = 1
    if anchors:
        ops += plan.train_ops[anchors[0]:]
        for k in anchors:
            for _, j, _ in variants[k]:
                ps = plan.theta_positions[j]
                ops += plan.train_ops[ps[0] : ps[-1] + 1]
                n_inner += 1
    assert len(ops) == K.plan_gate_apps(plan, shifts, groups, n_params)
    return ops_flops(ops, plan.m) + n_inner * INNER_FLOPS_PER_AMP * 2**plan.m


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.api.capabilities import capabilities_of, declare
        from repro_torch.comanager import dataplane
        from repro_torch.configs.quclassi_paper import get_quclassi
        from repro_torch.core import circuits, quclassi, shift_rule
        from repro_torch.core.trainer import train
        from repro_torch.data.mnist import make_pair_dataset, train_test_split
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.kernels import vqc_statevector as K
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing: {exc}", file=sys.stderr)
        return 1
    # strict float32, like the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = smi_line()

    # ------------------------------------------------------------ 1. device
    log(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{count} visible)")

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    report = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall for {len(report)} libraries")
    for name, rep in report.items():
        log(f"  {name}: {rep['seconds']:.2f} s")
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")

    # ----------------------------------------------------------- 3. kernels
    rng = np.random.default_rng(0)
    cfg = get_quclassi("quclassi-7q-3l")
    n_workers, batch = 4, 64
    spec7 = cfg.spec
    n_groups = 1 + 2 * cfg.n_theta
    samples = batch * cfg.n_patches                      # 576 per class and step
    rows_per_worker = samples * n_groups // n_workers    # 4176 materialized rows
    worker0_groups = tuple(range(0, n_groups, n_workers))  # round-robin worker 0
    specs = {
        "5q-1l": circuits.build_quclassi_circuit(5, 1),
        "7q-3l": spec7,
        "tied-7q-3l": circuits.build_tied_quclassi_circuit(7, 3),
    }

    def angles(spec, c):
        th = rng.uniform(-np.pi, np.pi, (c, spec.n_theta))
        dt = rng.uniform(0.0, np.pi, (c, spec.n_data))
        return (torch.tensor(th, dtype=torch.float32, device=dev),
                torch.tensor(dt, dtype=torch.float32, device=dev))

    errs = {"fidelity": 0.0, "state": 0.0, "shiftbank": 0.0}  # against plain only

    def check(kernel: str, label: str, got, want, tol: float = TOL, plain: bool = True):
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if plain:
            errs[kernel] = max(errs[kernel], err)
        log(f"  {kernel:9s} {label:40s} max|diff| = {err:.3e}")
        if not err <= tol:
            raise AssertionError(f"{kernel} {label}: max|diff| {err} > {tol}")

    log("checks: each CUDA kernel against its plain PyTorch version on the card")
    for name, spec in specs.items():
        for c in (100, rows_per_worker):  # 100 leaves the last block part-full
            th, dt = angles(spec, c)
            check("fidelity", f"{name} C={c}", K.vqc_p0(spec, th, dt),
                  K._fused_plain(spec, th, dt, want_state=False))
            re, im = K.vqc_state(spec, th, dt)
            pre, pim = K._fused_plain(spec, th, dt, want_state=True)
            check("state", f"{name} C={c} re", re, pre)
            check("state", f"{name} C={c} im", im, pim)
        th, dt = angles(spec, 32)  # the dense simulator, independent of both
        check("fidelity", f"{name} C=32 vs dense simulator",
              ops.vqc_fidelity(spec, th, dt), ref.vqc_fidelity_ref(spec, th, dt), plain=False)

    for name in ("7q-3l", "tied-7q-3l"):
        spec = specs[name]
        plan = K.build_shift_plan(spec)
        for four in (False, True):
            g_all = 1 + (4 if four else 2) * spec.n_theta
            shifts = tuple(K.shift_values(four))
            for groups in (tuple(range(g_all)), worker0_groups):
                for b in (100, samples):
                    th, dt = angles(spec, b)
                    check("shiftbank", f"{name} four={four} G={len(groups)} B={b}",
                          K.vqc_shift_fidelity(spec, th, dt, four_term=four, groups=groups),
                          K._shiftbank_plain(plan, shifts, groups, spec.n_theta, th, dt))
        bank = shift_rule.build_shift_bank(*angles(spec, 32))
        mat = bank.materialize()
        check("shiftbank", f"{name} B=32 vs dense simulator",
              ops.vqc_fidelity_shiftgroups(spec, bank.theta, bank.data).reshape(-1),
              ref.vqc_fidelity_ref(spec, mat.theta, mat.data), plain=False)
        # multibank: K = 4 banks of different sizes in one launch, per bank
        # against the plain version and bit-identical to per-bank launches
        banks = [angles(spec, b) for b in (samples, 100, 333, 64)]
        group_sets = (tuple(range(n_groups)), worker0_groups, (0, 1, 2), (5, 28))
        outs = ops.vqc_fidelity_shiftgroups_multibank(
            spec, tuple(t for t, _ in banks), tuple(d for _, d in banks), False, group_sets)
        for k, ((th, dt), gs, out) in enumerate(zip(banks, group_sets, outs)):
            plain = K._shiftbank_plain(plan, K.shift_values(False), gs, spec.n_theta, th, dt)
            check("shiftbank", f"{name} multibank bank {k} B={th.shape[0]}",
                  out, torch.clamp(plain, 0.0, 1.0))
            check("shiftbank", f"{name} multibank bank {k} vs per-bank", out,
                  ops.vqc_fidelity_shiftgroups(spec, th, dt, False, gs), tol=0.0, plain=False)

    # timing at the training path's shapes (quclassi-7q-3l, 4 workers)
    plan7 = K.build_shift_plan(spec7)
    p, d = spec7.n_theta, spec7.n_data
    th_rows, dt_rows = angles(spec7, rows_per_worker)
    th_smp, dt_smp = angles(spec7, samples)
    shifts2 = K.shift_values(False)
    timed = {
        "fidelity": (
            lambda: K.vqc_p0(spec7, th_rows, dt_rows),
            lambda: K._fused_plain(spec7, th_rows, dt_rows, want_state=False),
            rows_per_worker * (ops_flops(spec7.ops, 7) + 2 * 2**7),
            rows_per_worker * (4 * (p + d) + 4),
            f"C={rows_per_worker} circuits (one worker's row batch)",
        ),
        "state": (
            lambda: K.vqc_state(spec7, th_rows, dt_rows),
            lambda: K._fused_plain(spec7, th_rows, dt_rows, want_state=True),
            rows_per_worker * ops_flops(spec7.ops, 7),
            rows_per_worker * (4 * (p + d) + 8 * 2**7),
            f"C={rows_per_worker} circuits",
        ),
        "shiftbank": (
            lambda: K.vqc_shift_fidelity(spec7, th_smp, dt_smp, groups=worker0_groups),
            lambda: K._shiftbank_plain(plan7, shifts2, worker0_groups, p, th_smp, dt_smp),
            samples * shift_flops(K, plan7, worker0_groups, p),
            samples * (4 * (p + d) + 4 * len(worker0_groups)),
            f"B={samples} samples, G={len(worker0_groups)} groups (worker 0)",
        ),
    }
    records = {}
    for kname, (kern, plain, flops, nbytes, shape) in timed.items():
        ms = time_ms(kern)
        plain_ms = time_ms(plain, iters=5, warmup=1)
        bound_ms, bound_by = bound(flops, nbytes)
        records[kname] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}
        log(f"  time {kname:9s} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
    log("kernels: " + json.dumps(
        [{"name": k, "max_abs_err": errs[k], **records[k]} for k in records]))

    # ------------------------------------------------------------- 4. train
    x, y = make_pair_dataset(1, 5, n_per_class=128, seed=0)
    train_set, test_set = train_test_split(x, y)
    steps = len(train_set[1]) // batch
    init = quclassi.init_params(cfg, torch.Generator().manual_seed(0), dev)
    executors = {}
    for mode in ("implicit", "materialized"):
        n_units = n_groups if mode == "implicit" else samples * n_groups
        executors[mode] = dataplane.worker_batched_executor(
            spec7, dataplane.round_robin_assignment(n_units, n_workers), n_workers)
    # warm-up, one step per mode, so neither timed run pays first-call costs
    warm = (train_set[0][:batch], train_set[1][:batch])
    for mode, run in executors.items():
        train(cfg, warm, test_set, epochs=1, batch_size=batch, executor=run,
              bank_mode=mode, init_params=init, device=dev)

    launches = {k: 0 for k in K.LAUNCHES}
    first_fids = {}
    for mode, run in executors.items():
        seen = []

        def recording(*args, run=run, seen=seen):
            out = run(*args)
            if not seen:
                seen.append(out.detach().clone())
            return out

        executor = declare(recording, shiftbank=capabilities_of(run).shiftbank)
        torch.cuda.synchronize()
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        rep = train(cfg, train_set, test_set, epochs=1, batch_size=batch, lr=1e-3,
                    executor=executor, bank_mode=mode, seed=0, init_params=init,
                    device=dev)
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        for key in counts:
            launches[key] += counts[key]
        ep = rep.epochs[0]
        first_fids[mode] = seen[0]
        log(f"train {mode}: loss {ep.loss:.6f}, train acc {ep.train_accuracy:.4f}, "
            f"test acc {ep.test_accuracy:.4f}, {steps} steps in {ep.wall_seconds:.4f} s "
            f"({steps / ep.wall_seconds:.3f} steps/s, "
            f"{ep.circuits_executed / ep.wall_seconds:.1f} circuits/s), "
            f"launches {counts} [{card}]")
        if not math.isfinite(ep.loss):
            raise AssertionError(f"{mode}: loss {ep.loss} is not finite")
        if not all(torch.isfinite(v).all() for v in rep.params.values()):
            raise AssertionError(f"{mode}: parameters are not finite")
        want = "shiftbank" if mode == "implicit" else "fidelity"
        if counts[want] <= 0:
            raise AssertionError(f"{mode}: the {want} kernel was never launched")
    diff = float((first_fids["implicit"] - first_fids["materialized"]).abs().max())
    log(f"train: first-step fidelities, implicit vs materialized: max|diff| = {diff:.3e}")
    if not diff <= TOL:
        raise AssertionError(f"implicit and materialized first steps differ by {diff}")

    # where one gradient step's time goes (after the counts were read)
    xb = torch.as_tensor(train_set[0][:batch], device=dev)
    yb = torch.as_tensor(train_set[1][:batch], device=dev)
    cuda_kind = torch.autograd.DeviceType.CUDA
    for mode, run in executors.items():
        def step(run=run, mode=mode):
            loss, _, _ = quclassi.grad_shift(cfg, init, xb, yb, executor=run,
                                             implicit=mode == "implicit")
            return float(loss)

        step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages() if e.device_type == cuda_kind]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
        log(f"profile {mode}: one gradient step {wall_ms:.3f} ms host clock (profiled), "
            f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
            f"{sum(e.count for e in kern)} kernel launches [{card}]")
        for e in top:
            log(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<5d} {e.key[:90]}")

    kernels = [
        {"name": "fidelity", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vqc_fused.cu",
         "replaces": "src/repro/kernels/vqc_statevector.py:224"},
        {"name": "state", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vqc_fused.cu",
         "replaces": "src/repro/kernels/vqc_statevector.py:238"},
        {"name": "shiftbank", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vqc_shiftbank.cu",
         "replaces": "src/repro/kernels/vqc_statevector.py:520"},
    ]
    for k in kernels:
        n = k["name"]
        k.update(launches=launches[n], max_abs_err=errs[n], library_ms=None, **records[n])
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
