#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — every CUDA kernel compiled from ``src/repro_torch/kernels/csrc``
               (one nvcc per source, all at once); ptxas (its report
               kept beside a reused library) must show no spill stores
               for the five statevector kernels;
  3. kernels — each kernel against its plain PyTorch version on the card
               (max |diff| <= 1e-5) and against the dense simulator on a
               small input, then timed at the shape the training path gives
               it (CUDA events around back-to-back wrapper calls, and the
               kernel's own device time from torch.profiler), beside the
               plain version and the analytic bound.  The state kernel
               is checked at 7 and 10-14 qubits, and both on their
               device-memory route (one block per circuit, the state in
               device memory) at 15 and 17 qubits (QuClassi 15q-1l and
               17q-1l rows, C = 256); the spill pair, launched
               directly, at 13 qubits (m = 6), 17 (m = 8), 19 (m = 9) and
               on tied 5q/7q circuits under a forced shared-memory budget;
               multibank launches must equal per-bank launches bit for bit
               on both shift routes (13q: the single sweep it takes, and
               the spill pair under a forced budget); both routes are
               timed in turns at 13q-3l on 2 workers, 15q-3l, 17q-1l and
               17q-3l (B = 576);
               The flash-attention kernels are checked against their plain
               version, each on its dtype's route (bf16: the wgmma kernel of
               flash_attn_sm90.cu; float32: the SIMT kernel of
               flash_attn.cu), at the SmolLM-360M prefill shape (BH 60,
               S 2048, hd 64, g 3) in bf16 and f32, at Qwen3-4B's (BH 32,
               hd 128, g 4) in bf16, with window 64 and non-causal at S 256,
               at S 100 (the last tile part full), S 1 and S 192, within
               2e-5 (f32) and 2e-2 (bf16), then both routes are timed at the
               prefill shape beside ``scaled_dot_product_attention`` (timed
               only);
  4. train   — QuClassi Algorithm 1 through the data plane's
               ``worker_batched_executor``, 3 steps of 64 images after one
               warm-up step each: ``quclassi-7q-3l`` on 4 workers with
               implicit banks (shift kernel) and materialized (fused
               kernel), then 13-qubit, 3-layer QuClassi on 2 workers with
               implicit banks (the single-sweep shift kernel: each
               worker's checkpoints fit its launch's block; the first bank
               is also run through the spill pair under a forced budget).
               Launch counts are zeroed just before each run and read just
               after; then one profiled gradient step per run shows where
               the time goes;
  5. serve   — ``smollm-360m`` at full width and depth (32 layers, bf16,
               seeded weights) on the flash path: (a) a 4 x 2048-token
               prefill through ``make_prefill_step`` (counts zeroed before
               and read after; 32 launches, all on the wgmma route), timed,
               then profiled once; (b) 4 requests of a 64-token prompt, 16
               greedy tokens each, through ``make_serve_step``'s cache; (c)
               in float32, TF32 off, the cached decode's logits at every
               prompt position within 1e-3 of the flash prefill's (the
               float32 route), and the first generated token equal;
  6. gateway — the multi-tenant serving port (``repro_torch.serve``):
               (a) the paper's Fig-6 mix, 4 clients (5Q/1L, 5Q/2L, 7Q/1L,
               7Q/2L) each submitting a materialized shift-rule bank of 64
               samples to 4 workers of 5/10/15/20 qubits, through a sync
               and then an async runtime: async equal to sync bit for bit
               and within 1e-5 of direct kernel calls, with circuits/s,
               batches, lane fill, per-tenant p50/p99 and the async run's
               device idle share; (b) 2 tenants training quclassi-7q-3l,
               batch 64, implicit banks, 3 steps each, from two threads on
               one async runtime, free-running: finite losses, a batch
               holding both tenants, first-step losses within 1e-5 of solo
               runs; (c) mesh spill: a 7q batch on a fleet of 5-qubit
               workers and 17q rows over the per-block model, through
               ``MeshSpillExecutor`` (the device-memory route), within 1e-5
               of the plain version.  Counts are zeroed before each of
               (a), (b) and (c) and read after.
  7. cluster — the tenant-facing facade (``repro_torch.api``) on one async
               ``QuantumCluster`` (2 slots a worker, the 5/10/15/20-qubit
               fleet): (a) tenants alice (priority 0, SLO 500 ms, weight 2)
               and bob (priority 1) each submit 48 ``quclassi-7q-3l``
               circuits, interleaved, through ``Session.submit``/``drain``:
               every future within 1e-5 of a direct ``ops.vqc_fidelity``;
               (b) ``grad_shift`` through a materialized session's executor
               equal bit for bit to the runtime's executor, the implicit
               session's fidelities within 1e-5 (gradients within 1e-5
               scaled by the BCE chain factor); (c) ``Session.train``, 3
               steps of 64 images, implicit banks, first-step loss equal to
               ``trainer.train(gateway=cluster.runtime)``; (d) one shift
               bank of 64 samples through ``cluster.backend`` for all five
               kinds: batched, pooled and multibank equal to the direct
               implicit route bit for bit, sharded and mesh-spill (a
               one-device CUDA mesh) within 1e-5 of the materialized rows;
               (e) ``cluster.simulate`` of the Fig-6 clients, multi- and
               single-circuit tenancy, with and without the gateway (the
               virtual clock), whose placement then drives
               ``worker_batched_executor`` for a 7q-1l bank on the card
               (within 1e-5), and a federated session of 4 tenants, 3
               rounds, run twice: equal summaries and parameters; (f)
               ``scale.replay_real`` of the 300-tenant storm of
               ``examples/scale_storm.py``: completed + rejected ==
               submitted.  Counts are zeroed before each part that launches
               kernels and read after, before any comparison launch.
The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  Needs CUDA; without it, or without the
repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = 1e-5  # float32 fidelities: the reference's own kernel tolerance
#: H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
#: bf16 dense on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
#: flash attention against its plain version: the reference's own
#: tolerances (tests/test_flash_attention.py)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: float32 decode logits against the float32 flash prefill's
SERVE_TOL = 1e-3
#: rows of the device-memory route's checks and timing (15q-1l, 17q-1l)
DMEM_ROWS = 256
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


def device_ms(fn, kernel: str, iters: int = 20) -> float | None:
    """Mean device time of the CUDA kernel whose name contains ``kernel``
    over ``iters`` calls of ``fn`` (torch.profiler's kernel records): the
    kernel alone, where CUDA events around back-to-back calls also count
    the gaps in which the card waits for the host.  None, said in the log,
    when two profiled windows both miss some of the launches."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cuda_kind = torch.autograd.DeviceType.CUDA
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == cuda_kind and kernel in e.key]
        count = sum(e.count for e in hits)
        if count == iters:
            return sum(e.self_device_time_total for e in hits) / 1e3 / count
    log(f"  the profiler recorded {count} of {iters} launches of {kernel}: "
        "device time not measured")
    return None


def ptxas_spills(log: str) -> dict[str, tuple[int, int]]:
    """(spill stores, spill loads) in bytes per function of an ``nvcc
    -Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    return out


#: per library, the kernels whose ptxas report must show no spill stores
NO_SPILL_KERNELS = {"vqc_fused": ("fidelity_kernel", "state_kernel", "fidelity_dmem_kernel",
                                  "state_dmem_kernel"),
                    "vqc_shiftbank": ("shiftbank_kernel",),
                    "vqc_spill": ("shift_forward_kernel", "shift_tile_kernel")}


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profile_window(fn):
    """Run ``fn`` once under ``torch.profiler``: host-clock ms (ending in a
    synchronise), the CUDA kernels' key averages, and their busy ms."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda_kind = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda_kind]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    return wall_ms, kern, busy_ms


def log_top(kern, n: int) -> None:
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:n]:
        log(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<5d} {e.key[:90]}")


def flash_inputs(bh: int, s: int, hd: int, dtype, groups: int, dev, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple((torch.randn((n, s, hd), generator=g, device=dev) * 0.5).to(dtype)
                 for n in (bh, bh // groups, bh // groups))


def check_flash(dev, card: str) -> tuple[float, dict]:
    """The flash kernels against their plain version on the card at the
    serving path's shapes and the edge cases, each on its dtype's route,
    then timed at the SmolLM-360M prefill shape.  Returns (max |diff| of
    the bf16 route, timing record with the float32 route's under "simt")."""
    from repro_torch.kernels import flash_attention as FA

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # label, BH, S, hd, dtype, groups, causal, window
        ("smollm-360m prefill", 60, 2048, 64, bf16, 3, True, 0),
        ("smollm-360m prefill", 60, 2048, 64, f32, 3, True, 0),
        ("qwen3-4b prefill", 32, 2048, 128, bf16, 4, True, 0),
        ("window 64", 8, 256, 64, bf16, 1, True, 64),
        ("window 64", 8, 256, 64, f32, 1, True, 64),
        ("non-causal", 8, 256, 64, bf16, 2, False, 0),
        ("non-causal", 8, 256, 64, f32, 2, False, 0),
        ("non-causal window 64", 8, 256, 128, f32, 2, False, 64),
        ("part-full tile", 6, 100, 64, f32, 3, True, 0),
        ("part-full tile", 6, 100, 128, bf16, 3, True, 0),
        ("part-full tile", 6, 100, 16, f32, 1, True, 0),
        ("part-full tile", 6, 100, 32, bf16, 1, False, 0),
        ("one row", 6, 1, 64, bf16, 3, True, 0),
        ("1.5 tiles", 6, 192, 64, bf16, 3, True, 0),
    ]
    worst = {bf16: 0.0, f32: 0.0}
    for i, (label, bh, s, hd, dtype, groups, causal, window) in enumerate(cases):
        q, k, v = flash_inputs(bh, s, hd, dtype, groups, dev, seed=i)
        route = FA.ROUTES[dtype]
        before = FA.LAUNCHES[route]
        got = FA.flash_attention(q, k, v, causal=causal, window=window, groups=groups)
        want = FA._flash_plain(q, k, v, causal=causal, window=window, groups=groups)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        worst[dtype] = max(worst[dtype], err)
        tol = FLASH_TOL[dtype]
        log(f"  {route:13s} {label} BH={bh} S={s} hd={hd} g={groups} "
            f"{str(dtype)[6:]} causal={causal} window={window}: max|diff| = {err:.3e}")
        if FA.LAUNCHES[route] != before + 1:
            raise AssertionError(f"flash {label}: {dtype} did not launch the {route} kernel")
        if not (got.dtype == dtype and torch.isfinite(got.float()).all() and err <= tol):
            raise AssertionError(f"flash {label}: max|diff| {err} > {tol} or not finite")

    # timing at the prefill's shape: 4 requests x 2048 tokens, 15 heads over
    # 5 kv heads (BH 60, g 3), bf16 (the wgmma route) and float32 (SIMT)
    b, h, kv, s, hd = 4, 15, 5, 2048, 64
    q, k, v = flash_inputs(b * h, s, hd, bf16, h // kv, dev, seed=99)
    ms = time_ms(lambda: FA.flash_attention(q, k, v, groups=h // kv), iters=50)
    plain_ms = time_ms(lambda: FA._flash_plain(q, k, v, groups=h // kv), iters=3, warmup=1)
    q4, k4, v4 = q.view(b, h, s, hd), k.view(b, kv, s, hd), v.view(b, kv, s, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(q4, k4, v4, is_causal=True, scale=1.0, enable_gqa=True)  # noqa: E731
    library_ms = time_ms(library, iters=50)
    lib_diff = float((library().reshape(b * h, s, hd).float()
                      - FA.flash_attention(q, k, v, groups=h // kv).float()).abs().max())
    q32, k32, v32 = (t.float() for t in (q, k, v))
    simt_ms = time_ms(lambda: FA.flash_attention(q32, k32, v32, groups=h // kv), iters=10)
    flops = 4 * b * h * hd * s * (s + 1) // 2          # visible (query, key) pairs
    nbytes = 2 * (2 * b * h + 2 * b * kv) * s * hd     # q, o at 60 heads; k, v at 20
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    simt_bound_ms, simt_bound_by = bound(flops, 2 * nbytes, PEAK_F32_FLOPS)
    log(f"  time flash_wgmma   BH={b * h} S={s} hd={hd} g={h // kv} bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms "
        f"(max|diff| to the kernel {lib_diff:.3e}), bound {bound_ms:.6f} ms ({bound_by}; "
        f"{flops} flops, {nbytes} bytes) [{card}]")
    log(f"  time flash_simt    the same inputs in float32: kernel {simt_ms:.4f} ms, bound "
        f"{simt_bound_ms:.6f} ms ({simt_bound_by} at float32's {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s), "
        f"wgmma route {simt_ms / ms:.1f}x faster [{card}]")
    simt = {"source": "src/repro_torch/kernels/csrc/flash_attn.cu", "dtype": "float32",
            "max_abs_err": worst[f32], "ms": simt_ms, "bound_ms": simt_bound_ms,
            "bound_by": simt_bound_by}
    return worst[bf16], {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": library_ms, "simt": simt}


def ops_flops(ops, n: int) -> int:
    return sum(FLOPS_PER_AMP[op.gate] for op in ops) * 2**n


def dmem_pass_bytes(spec, want_state: bool) -> int:
    """Bytes of state one circuit of the device-memory route moves through
    device memory: the |0..0> write, then each gate's read and write of the
    32-byte sectors of re and im that hold an amplitude it changes (all of
    them for H, one-qubit and two-qubit rotations; those with the control
    set for CRY / CRZ; those with the ancilla set and the swapped bits
    unequal for CSWAP), then, for P0, the read of the first half."""
    n = spec.n_qubits
    idx = np.arange(2**n)

    def bit(q):
        return (idx >> (n - 1 - q)) & 1

    total = 8 * 2**n
    for op in spec.ops:
        if op.gate in ("cry", "crz"):
            touched = bit(op.qubits[0]) == 1
        elif op.gate == "cswap":
            a, b, c = op.qubits
            touched = (bit(a) == 1) & (bit(b) != bit(c))
        else:
            touched = np.ones(2**n, dtype=bool)
        sectors = int(touched.reshape(-1, 8).any(1).sum())
        total += 2 * 2 * 32 * sectors  # re and im, read and written
    return total + (0 if want_state else 8 * 2 ** (n - 1))


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


def spill_flops(K, plan, tab, tile_plan) -> tuple[int, int]:
    """Per-sample flops of the spill pair, (forward, tile).  Forward: the
    data pass, the train forward pass and f0.  Tile: per tile the recompute
    of its checkpoints from its boundary (ops lo .. last - 1), the chi walk
    over every op from the end down to the shallowest tile's lo (the last
    one skipped), and per variant row its replay span and inner product."""
    dim = 2**plan.m
    fwd = ops_flops(list(plan.data_ops) + list(plan.train_ops), plan.m) + INNER_FLOPS_PER_AMP * dim
    ops, n_inner = [], 0
    for _, lo, _, rows_t in tile_plan:
        last = max(plan.theta_positions[j][0] for _, j, _, _ in rows_t)
        ops += plan.train_ops[lo:last]
    ops += plan.train_ops[tile_plan[-1][1] + 1 :]
    n_rows = len(tab.variant_rows)  # one replay and one inner product each
    for (_, _, _, rows_t) in tile_plan:
        for _, j, _, _ in rows_t:
            ps = plan.theta_positions[j]
            ops += plan.train_ops[ps[0] : ps[-1] + 1]
            n_inner += 1
    assert n_inner == n_rows  # every requested group once
    return fwd, ops_flops(ops, plan.m) + n_inner * INNER_FLOPS_PER_AMP * dim


def spill_budget(K, spec, four: bool, groups, n_ckpt: int) -> int:
    """A shared-memory budget under which the single sweep cannot hold one
    sample and the spill pair must tile: the staged tables and, for one
    sample, ``n_ckpt`` checkpoints and 4 live states."""
    plan = K.build_shift_plan(spec)
    n_variants = K._walk_table(spec, four, tuple(groups), K.SMEM_BUDGET_BYTES, False).n_variants
    return K.walk_table_bytes(plan, n_variants) + (n_ckpt + 4) * K._state_bytes(plan.m, 1)


def zero_flash_counts() -> None:
    from repro_torch.kernels import flash_attention as FA

    for key in FA.LAUNCHES:
        FA.LAUNCHES[key] = 0


def serve_smollm(dev, card: str) -> tuple[int, int]:
    """Phase 5: SmolLM-360M at full width and depth on the flash path.
    Returns the wgmma launches of the main-path (bf16) prefill and the SIMT
    launches of the float32 prefill of (c)."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import vqc_statevector as K
    from repro_torch.launch import serve, steps
    from repro_torch.models import multimodal, transformer

    cfg = cfg_base.get("smollm-360m").with_(attention_impl="flash")
    b, s, plen, gen = 4, 2048, 64, 16
    prefill, model = steps.make_prefill_step(cfg, device=dev)
    log(f"serve {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.kv_heads} heads, hd {cfg.resolved_head_dim}, {cfg.dtype}, "
        f"{transformer.param_count(model):,} parameters (seeded init)")

    # (a) prefill of 4 x 2048 tokens through the flash kernel
    batch = multimodal.text_batch(cfg, b, s, seed=0)
    prefill(batch)  # warm-up: first-call costs, the kernel library's load
    torch.cuda.synchronize()
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    zero_flash_counts()
    logits = prefill(batch)
    torch.cuda.synchronize()
    counts = dict(FA.LAUNCHES)
    launches = counts["flash_wgmma"]
    others = {k: n for k, n in K.LAUNCHES.items() if n}
    if launches != cfg.n_layers or counts["flash"] != launches or counts["flash_simt"] or others:
        raise AssertionError(f"prefill launched flash {counts} (want {cfg.n_layers} on the "
                             f"wgmma route) and other kernels {others}")
    if logits.shape != (b, s, cfg.vocab) or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are not finite")
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(batch)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    ms = sum(runs) / len(runs)
    log(f"serve prefill: {b} x {s} tokens in {ms:.3f} ms mean of {len(runs)} "
        f"({', '.join(f'{r:.3f}' for r in runs)}), {b * s / ms * 1e3:,.1f} tokens/s, "
        f"{launches} flash launches a prefill, all flash_wgmma [{card}]")
    wall_ms, kern, busy_ms = profile_window(lambda: prefill(batch))
    flash = [e for e in kern if "flash_wgmma_kernel" in e.key]
    flash_ms = sum(e.self_device_time_total for e in flash) / 1e3
    log(f"profile prefill: {wall_ms:.3f} ms host clock (profiled), device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.4f}, flash_wgmma_kernel {flash_ms:.3f} ms "
        f"x{sum(e.count for e in flash)} = {flash_ms / busy_ms:.4f} of busy time, "
        f"{sum(e.count for e in kern)} kernel launches [{card}]")
    log_top(kern, 6)
    del logits

    # (b) requests as run_reduced serves them: one seeded token repeated as
    # the prompt, greedy tokens through the cache
    serve_step, _ = steps.make_serve_step(cfg, model=model)
    prompt = multimodal.decode_batch_for(cfg, b)
    prompt = {"tokens": prompt["tokens"].repeat(1, plen)}
    serve.generate(serve_step, model, {"tokens": prompt["tokens"][:, :4]}, 2)  # warm-up
    res = serve.generate(serve_step, model, prompt, gen)
    toks = res["tokens"]
    if toks.shape != (b, gen) or not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"generated tokens {tuple(toks.shape)} out of range")
    total_s = res["prompt_s"] + res["gen_s"]
    log(f"serve requests: {b} x ({plen} prompt + {gen} generated) cached decode steps: "
        f"prompt {res['prompt_s'] * 1e3:.3f} ms, generation {res['gen_s'] * 1e3:.3f} ms, "
        f"{b * gen / res['gen_s']:,.1f} generated tokens/s, "
        f"{b * (plen + gen) / total_s:,.1f} decode steps/s incl. prompt; "
        f"continuation of request 0: {toks[0].tolist()} [{card}]")
    one = {"tokens": prompt["tokens"][:, :1]}
    wall_ms, kern, busy_ms = profile_window(lambda: serve.generate(serve_step, model, one, 1))
    log(f"profile decode: 2 cached decode steps (1 prompt + 1 generated token) in "
        f"{wall_ms:.3f} ms host clock (profiled), device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.4f}, {sum(e.count for e in kern)} kernel launches "
        f"[{card}]")
    log_top(kern, 4)
    del model, prefill, serve_step
    torch.cuda.empty_cache()

    # (c) float32 at full width: cached decode against the flash prefill
    cfg32 = cfg.with_(dtype="float32")
    prefill32, model32 = steps.make_prefill_step(cfg32, device=dev)
    serve32, _ = steps.make_serve_step(cfg32, model=model32)
    prompt = multimodal.text_batch(cfg32, b, plen, seed=0)
    zero_flash_counts()
    full = prefill32(prompt).float()
    torch.cuda.synchronize()
    simt = FA.LAUNCHES["flash_simt"]
    if simt != cfg.n_layers or FA.LAUNCHES["flash_wgmma"]:
        raise AssertionError(f"float32 prefill launched flash {dict(FA.LAUNCHES)} (want "
                             f"{cfg.n_layers} on the SIMT route)")
    res = serve.generate(serve32, model32, prompt, 1, keep_logits=True)
    diff = float((res["prompt_logits"] - full).abs().max())
    first_ok = torch.equal(res["tokens"][:, 0].cpu(), full[:, -1].argmax(-1).cpu())
    log(f"serve consistency (float32, TF32 off): decode vs flash prefill logits over "
        f"{b} x {plen} positions: max|diff| = {diff:.3e} (limit {SERVE_TOL}), "
        f"logit scale {float(full.abs().max()):.3f}; first generated token equal: {first_ok}")
    if not (diff <= SERVE_TOL and first_ok):
        raise AssertionError(f"decode and prefill disagree: {diff}, first token equal {first_ok}")
    del model32, prefill32, serve32
    torch.cuda.empty_cache()
    return launches, simt


def zero_counts(K) -> None:
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0


def train_tenants(dev, workers, cfg, batch, test_set, inits, seeds, kw):
    """Each tenant of ``seeds`` trains ``cfg`` from its own host thread,
    free-running, through one async ``GatewayRuntime`` on ``workers`` (2
    admissions pending a tenant); -> (runtime, reports, seconds).  Fails if a
    tenant or the runtime failed."""
    from repro_torch.core.trainer import train
    from repro_torch.serve import GatewayRuntime

    rt = GatewayRuntime(workers, deadline=0.05, mode="async", max_pending=2)
    reps, errors = {}, []

    def tenant(cid):
        try:
            reps[cid] = train(cfg, batch, test_set, gateway=rt, client_id=cid,
                              seed=seeds[cid], init_params=inits[cid], **kw)
        except BaseException as exc:  # reported below, on the main thread
            errors.append(exc)

    try:
        threads = [threading.Thread(target=tenant, args=(cid,)) for cid in seeds]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if errors or rt.dispatcher.errors:
            raise AssertionError(f"training through the gateway failed: {errors} "
                                 f"{rt.dispatcher.errors}")
    finally:
        rt.close()
    return rt, reps, seconds


def serve_gateway(dev, card: str) -> dict:
    """Phase 6: the multi-tenant serving port on the card, (a) the Fig-6
    mix through a sync and an async runtime, (b) two tenants training
    quclassi-7q-3l through one async runtime, (c) mesh spill.  Counts are
    zeroed just before each path and read just after; returns their sum."""
    from repro_torch.comanager import dataplane
    from repro_torch.comanager.worker import WorkerConfig
    from repro_torch.configs.quclassi_paper import get_quclassi
    from repro_torch.core import circuits, quclassi, shift_rule
    from repro_torch.core.trainer import train
    from repro_torch.data.mnist import make_pair_dataset, train_test_split
    from repro_torch.kernels import ops
    from repro_torch.kernels import vqc_statevector as K
    from repro_torch.serve import GatewayRuntime

    counts = {key: 0 for key in K.LAUNCHES}

    def read(label: str, wanted) -> None:
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        log(f"  {label}: launches {got} [{card}]")
        for key in wanted:
            if got[key] <= 0:
                raise AssertionError(f"{label}: the {key} kernel was never launched")
        for key, n in got.items():
            counts[key] += n

    def fig6_workers(max_qubits=(5, 10, 15, 20)):
        return [WorkerConfig(f"w{i + 1}", q) for i, q in enumerate(max_qubits)]

    # (a) the Fig-6 client mix: each client's materialized shift-rule bank
    rng = np.random.default_rng(6)
    clients = []
    for cid, qc, nl in (("5q1l", 5, 1), ("5q2l", 5, 2), ("7q1l", 7, 1), ("7q2l", 7, 2)):
        spec = circuits.build_quclassi_circuit(qc, nl)
        theta = torch.tensor(rng.uniform(0, np.pi, spec.n_theta), dtype=torch.float32, device=dev)
        data = torch.tensor(rng.uniform(0, np.pi, (64, spec.n_data)), dtype=torch.float32,
                            device=dev)
        bank = shift_rule.build_bank(theta, data)
        clients.append((cid, spec, bank.theta, bank.data))
    n_rows = sum(t.shape[0] for _, _, t, _ in clients)

    def fig6(mode: str):
        """The clients' rows interleaved (row i of every client, then row
        i + 1), drained; -> per client fidelities, seconds, runtime."""
        rt = GatewayRuntime(fig6_workers(), target=128, deadline=0.05, mode=mode,
                            slots_per_worker=2)
        try:
            for cid, _, _, _ in clients:
                rt.gateway.register_client(cid, slo_ms=4000.0)
            rows = {cid: list(zip(t.unbind(0), d.unbind(0))) for cid, _, t, d in clients}
            futs = {cid: [] for cid in rows}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(max(len(r) for r in rows.values())):
                for cid, spec, _, _ in clients:
                    if i < len(rows[cid]):
                        futs[cid].append(rt.gateway.submit(
                            cid, spec, rows[cid][i], now=rt.dispatcher.clock()))
                rt.dispatcher.kick()
            rt.dispatcher.drain()
            got = {cid: torch.stack([f.value for f in fs]) for cid, fs in futs.items()}
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if getattr(rt.dispatcher, "errors", []):
                raise AssertionError(f"{mode} runtime errors: {rt.dispatcher.errors}")
        finally:
            rt.close()
        return got, seconds, rt

    log("gateway (a): the Fig-6 mix, 4 clients x a materialized bank of 64 samples "
        f"({n_rows} rows), workers of 5/10/15/20 qubits")
    for mode in ("sync", "async"):
        fig6(mode)  # warm-up: device tables, streams, first launches
    zero_counts(K)
    out = {}
    for mode in ("sync", "async"):
        got, seconds, rt = fig6(mode)
        out[mode] = got
        summ = rt.telemetry.summary()
        tenants = {t["client"]: (t["p50_latency_s"], t["p99_latency_s"]) for t in summ["tenants"]}
        log(f"  {mode}: {n_rows} circuits in {seconds:.4f} s = {n_rows / seconds:.1f} circuits/s, "
            f"{summ['batches']} batches, lane fill {summ['lane_fill']}, per-tenant "
            f"(p50 s, p99 s) {tenants} [{card}]")
    read("gateway (a) launches, sync + async", ("fidelity",))
    worst = 0.0
    for cid, spec, theta, data in clients:
        if not torch.equal(out["sync"][cid], out["async"][cid]):
            raise AssertionError(f"{cid}: async differs from sync")
        diff = float((out["async"][cid] - ops.vqc_fidelity(spec, theta, data)).abs().max())
        worst = max(worst, diff)
    log(f"  async == sync bit for bit; max|diff| to direct ops.vqc_fidelity = {worst:.3e}")
    if not worst <= TOL:
        raise AssertionError(f"Fig-6 fidelities differ from direct launches by {worst}")
    wall_ms, kern, busy_ms = profile_window(lambda: fig6("async"))
    log(f"  async run profiled: {wall_ms:.3f} ms host clock, device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.4f}, {sum(e.count for e in kern)} kernel "
        f"launches [{card}]")
    zero_counts(K)  # the profiled run is not counted

    # (b) two tenants training quclassi-7q-3l on one async runtime
    cfg = get_quclassi("quclassi-7q-3l")
    x, y = make_pair_dataset(1, 5, n_per_class=128, seed=0)
    (xtr, ytr), test_set = train_test_split(x, y)
    one_batch = (xtr[:64], ytr[:64])  # 3 epochs of one batch: 3 steps, a loss each
    kw = dict(epochs=3, batch_size=64, lr=1e-3, bank_mode="implicit", device=dev)
    seeds = {"tenant-a": 0, "tenant-b": 1}
    inits = {cid: quclassi.init_params(cfg, torch.Generator().manual_seed(s), dev)
             for cid, s in seeds.items()}
    n_groups = 1 + 2 * cfg.n_theta
    solo = {}
    for cid, s in seeds.items():  # solo: the data plane alone, 4 workers
        run = dataplane.worker_batched_executor(
            cfg.spec, dataplane.round_robin_assignment(n_groups, 4), 4)
        solo[cid] = train(cfg, one_batch, test_set, executor=run, seed=s,
                          init_params=inits[cid], **kw)
    # a short admission queue a tenant (backpressure after 2 pending
    # subtasks): the weighted-fair scheduler then interleaves the two
    # free-running tenants' group subtasks into the shared buffers.
    zero_counts(K)
    rt, reps, seconds = train_tenants(dev, fig6_workers(), cfg, one_batch, test_set, inits,
                                      seeds, kw)
    read("gateway (b) launches", ("shiftbank",))
    mixed = [b for b in rt.dispatcher.batch_log if len(b[2]) > 1]
    log(f"gateway (b): 2 tenants x 3 steps of quclassi-7q-3l in {seconds:.4f} s = "
        f"{2 * 3 / seconds:.3f} steps/s, {len(rt.dispatcher.batch_log)} batches, "
        f"{len(mixed)} holding both tenants, fused launches {rt.telemetry.fused_launches} "
        f"({rt.telemetry.multibank_launches} multi-bank) [{card}]")
    for cid, rep in reps.items():
        losses = [e.loss for e in rep.epochs]
        diff = abs(losses[0] - solo[cid].epochs[0].loss)
        log(f"  {cid}: losses {losses}, first step vs solo run: |diff| = {diff:.3e}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{cid}: a loss is not finite: {losses}")
        if not diff <= TOL:
            raise AssertionError(f"{cid}: first-step loss differs from a solo run by {diff}")
    if not mixed:
        raise AssertionError("no batch held both tenants")

    # (c) mesh spill: over-width 7q rows on 5-qubit workers, 17q rows over
    # the per-block memory model (the device-memory route)
    log("gateway (c): mesh spill")
    zero_counts(K)
    for label, workers, qc, n in (("7q rows on 5-qubit workers", (5, 5), 7, 2),
                                  ("17q-1l rows over the per-block model", (5, 10, 15, 20),
                                   17, DMEM_ROWS)):
        spec = circuits.build_quclassi_circuit(qc, 1)
        th = torch.tensor(rng.uniform(0, np.pi, (n, spec.n_theta)), dtype=torch.float32,
                          device=dev)
        dt = torch.tensor(rng.uniform(0, np.pi, (n, spec.n_data)), dtype=torch.float32,
                          device=dev)
        rt = GatewayRuntime(fig6_workers(workers), deadline=0.01, mode="async")
        try:
            t0 = time.perf_counter()
            got = rt.executor(spec, "wide")(th, dt)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            rt.close()
        diff = float((got - torch.clamp(2 * K._fused_plain(spec, th, dt, False) - 1, 0, 1))
                     .abs().max())
        log(f"  {label}: {n} rows in {seconds:.4f} s, mesh spills {rt.telemetry.mesh_spills}, "
            f"batch log {rt.dispatcher.batch_log}, max|diff| to the plain version {diff:.3e} "
            f"[{card}]")
        if rt.telemetry.mesh_spills < 1 or not diff <= TOL:
            raise AssertionError(f"{label}: no mesh spill, or max|diff| {diff} > {TOL}")
    read("gateway (c) launches", ("fidelity", "fidelity_dmem"))
    return counts


#: seconds a circuit spends being dispatched by the manager in the Fig-6
#: runs (``benchmarks/paper_data.py`` ``ASSIGN_LATENCY``; the smoke imports
#: nothing of the benchmarks)
FIG6_ASSIGN_LATENCY = 0.005
#: the Fig-6 workers' co-residency slowdown (``benchmarks/multitenant.py``)
FIG6_CONTENTION = 0.5


def cluster_phase(dev, card: str) -> dict:
    """Phase 7: the tenant-facing facade on the card, (a) sessions submit
    and drain, (b) session and runtime executors, (c) ``Session.train``, (d)
    the five backends, (e) the virtual-clock simulation driving real
    execution and a federated session, (f) a tenant storm replayed through
    real kernels.  Counts are zeroed just before each part that launches
    kernels and read just after; returns their sum."""
    from repro_torch import api, scale
    from repro_torch.comanager import dataplane, tenancy
    from repro_torch.comanager.worker import PAPER_RATES_GCP, WorkerConfig
    from repro_torch.configs.quclassi_paper import get_quclassi
    from repro_torch.core import fidelity, quclassi, shift_rule
    from repro_torch.core.trainer import train
    from repro_torch.data.mnist import make_pair_dataset, train_test_split
    from repro_torch.federated import FederatedConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import vqc_statevector as K

    counts = {key: 0 for key in K.LAUNCHES}

    def read(label: str, wanted) -> None:
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        log(f"  {label}: launches {got} [{card}]")
        for key in wanted:
            if got[key] <= 0:
                raise AssertionError(f"{label}: the {key} kernel was never launched")
        for key, n in got.items():
            counts[key] += n

    cfg = get_quclassi("quclassi-7q-3l")
    spec = cfg.spec
    rng = np.random.default_rng(7)
    serving = api.ServingConfig(mode="async", slots_per_worker=2)
    cluster = api.QuantumCluster(api.ClusterConfig(serving=serving), device=dev)
    try:
        alice = cluster.session("alice", api.TenantPolicy(priority=0, slo_ms=500.0, weight=2.0))
        bob = cluster.session("bob", api.TenantPolicy(priority=1))

        # (a) two tenants' sessions submit 48 circuits each, interleaved
        th = torch.tensor(rng.uniform(0, np.pi, (96, spec.n_theta)), dtype=torch.float32,
                          device=dev)
        dt = torch.tensor(rng.uniform(0, np.pi, (96, spec.n_data)), dtype=torch.float32,
                          device=dev)

        def submit_all():
            futs = []
            for i in range(0, 96, 2):
                futs.append(alice.submit(spec, th[i], dt[i]))
                futs.append(bob.submit(spec, th[i + 1], dt[i + 1]))
            alice.drain()
            return futs

        submit_all()  # warm-up: the slots' streams, device tables
        zero_counts(K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = submit_all()
        got = torch.stack([f.result(timeout=60.0) for f in futs])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        read("cluster (a) launches", ("fidelity",))
        if not all(f.done for f in futs):
            raise AssertionError("cluster (a): a future did not resolve")
        summ = cluster.telemetry.summary()
        tel = {s.tenant: (s.telemetry()["p50_latency_s"], s.telemetry()["p99_latency_s"])
               for s in (alice, bob)}
        diff = float((got - ops.vqc_fidelity(spec, th, dt)).abs().max())
        log(f"cluster (a): 2 sessions x 48 quclassi-7q-3l circuits in {seconds:.4f} s = "
            f"{96 / seconds:.1f} circuits/s; since the cluster opened {summ['batches']} "
            f"batches, lane fill {summ['lane_fill']}, per-tenant (p50 s, p99 s) {tel}; "
            f"max|diff| to direct ops.vqc_fidelity {diff:.3e} [{card}]")
        if not diff <= TOL:
            raise AssertionError(f"cluster (a): results differ from direct launches by {diff}")

        # (b) grad_shift through a session's executor and the runtime's own
        x, y = make_pair_dataset(1, 5, n_per_class=4, seed=1)
        xb, yb = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        params = quclassi.init_params(cfg, torch.Generator().manual_seed(3), dev)
        zero_counts(K)
        mat = cluster.session("trainer-m", bank_mode="materialized")
        l_s, g_s, f_s = quclassi.grad_shift(cfg, params, xb, yb, executor=mat.executor(spec))
        l_r, g_r, _ = quclassi.grad_shift(cfg, params, xb, yb,
                                          executor=cluster.runtime.executor(spec, "legacy"))
        imp = cluster.session("trainer-i", bank_mode="implicit")
        l_i, g_i, f_i = quclassi.grad_shift(cfg, params, xb, yb, executor=imp.executor(spec))
        read("cluster (b) launches", ("fidelity", "shiftbank"))
        onehot = torch.nn.functional.one_hot(yb.long(), cfg.n_classes).to(torch.float32)
        chain = fidelity.bce_grad_wrt_fidelity(f_s, onehot)
        gtol = TOL * max(1.0, float(chain.abs().max()))
        fdiff = float((f_i - f_s).abs().max())
        gdiff = max(float((g_i[k] - g_s[k]).abs().max()) for k in g_s)
        log(f"cluster (b): grad_shift on {len(y)} images, session vs runtime executor equal "
            f"{float(l_s) == float(l_r) and all(torch.equal(g_s[k], g_r[k]) for k in g_s)}; "
            f"implicit session: max|diff| fidelities {fdiff:.3e}, gradients {gdiff:.3e} "
            f"(tolerance {gtol:.3e}) [{card}]")
        if float(l_s) != float(l_r) or not all(torch.equal(g_s[k], g_r[k]) for k in g_s):
            raise AssertionError("cluster (b): session and runtime executors differ")
        if not (fdiff <= TOL and gdiff <= gtol):
            raise AssertionError(f"cluster (b): implicit session differs: {fdiff}, {gdiff}")

        # (c) Session.train: 3 steps of 64 images, implicit banks
        x, y = make_pair_dataset(1, 5, n_per_class=128, seed=0)
        (xtr, ytr), test_set = train_test_split(x, y)
        one_batch = (xtr[:64], ytr[:64])
        init = quclassi.init_params(cfg, torch.Generator().manual_seed(0), dev)
        kw = dict(batch_size=64, lr=1e-3, init_params=init)
        sess = cluster.session("carol", bank_mode="implicit")
        zero_counts(K)
        t0 = time.perf_counter()
        rep = sess.train(cfg, one_batch, test_set, epochs=3, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        read("cluster (c) launches", ("shiftbank",))
        direct = train(cfg, one_batch, test_set, epochs=1, gateway=cluster.runtime,
                       client_id="carol-direct", bank_mode="implicit", device=dev, **kw)
        losses = [e.loss for e in rep.epochs]
        diff = abs(losses[0] - direct.epochs[0].loss)
        log(f"cluster (c): Session.train 3 steps of quclassi-7q-3l in {seconds:.4f} s = "
            f"{3 / seconds:.3f} steps/s, losses {losses}; first step vs "
            f"trainer.train(gateway=cluster.runtime): |diff| = {diff:.3e} [{card}]")
        if diff != 0.0 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"cluster (c): first-step loss differs by {diff}: {losses}")

        # (d) one shift bank of 64 samples through the five backends
        theta = torch.tensor(rng.uniform(0, np.pi, spec.n_theta), dtype=torch.float32, device=dev)
        data = torch.tensor(rng.uniform(0, np.pi, (64, spec.n_data)), dtype=torch.float32,
                            device=dev)
        bank = shift_rule.build_shift_bank(theta, data)
        outs, costs = {}, {}
        zero_counts(K)
        for kind in sorted(api.BACKEND_KINDS):
            be = cluster.backend(kind, spec)
            try:
                outs[kind] = be.run_bank(bank)
            finally:
                be.close()
            cm = be.cost_model()
            costs[kind] = (cm.bank_cost_units(spec, bank), cm.bank_smem_bytes(spec, bank))
        read("cluster (d) launches", ("shiftbank",))
        direct = ops.vqc_fidelity_shiftgroups(spec, bank.theta, bank.data, False).reshape(-1)
        rows = bank.materialize()
        plain_rows = ops.vqc_fidelity(spec, rows.theta, rows.data)
        log(f"cluster (d): one ShiftBank of 64 samples ({bank.n_groups} groups); "
            f"CostModel (bank_cost_units, bank_smem_bytes) {costs} [{card}]")
        for kind, out in outs.items():
            if kind in ("batched", "pooled", "multibank"):
                ok = torch.equal(out, direct)
                log(f"  {kind}: equal to the direct implicit route bit for bit: {ok}")
                if not ok:
                    raise AssertionError(f"cluster (d): {kind} differs from the implicit route")
            else:
                diff = float((out - plain_rows).abs().max())
                log(f"  {kind}: max|diff| to the materialized rows {diff:.3e}")
                if not diff <= TOL:
                    raise AssertionError(f"cluster (d): {kind} differs by {diff}")
    finally:
        cluster.close()

    # (e) the virtual-clock simulation of the Fig-6 clients (the paper's
    # circuit counts cut to 10%: Algorithm 2's queue scan is quadratic on
    # the host), its placement driving real execution, and a federated
    # session
    clients = (("5q1l", 5, 1), ("5q2l", 5, 2), ("7q1l", 7, 1), ("7q2l", 7, 2))
    jobs = [dataclasses.replace(tenancy.paper_job(cid, qc, nl, scale=0.1),
                                service_override=1.0 / PAPER_RATES_GCP[(qc, nl)])
            for cid, qc, nl in clients]
    fleet = tuple(WorkerConfig(f"w{i + 1}", q, contention=FIG6_CONTENTION)
                  for i, q in enumerate((5, 10, 15, 20)))
    sim_cluster = api.QuantumCluster(api.ClusterConfig(workers=fleet), device=dev)
    reports = {}
    t0 = time.perf_counter()
    for gateway in (False, True):
        for ten in ("multi", "single_circuit"):
            sim = api.SimulationConfig(tenancy=ten, classical_overhead=0.01, fair_queue=True,
                                       assign_latency=FIG6_ASSIGN_LATENCY, gateway=gateway)
            reports[(gateway, ten)] = r = sim_cluster.simulate(jobs, simulation=sim)
            log(f"cluster (e): simulate Fig-6, tenancy {ten}, gateway {gateway}: "
                f"{r.total_circuits} circuits, makespan {r.makespan:.3f} s virtual, "
                f"{r.circuits_per_second:.3f} circuits/s virtual, per client circuits/s "
                f"{ {c: round(j.circuits_per_second, 3) for c, j in r.jobs.items()} }")
        ratio = (reports[(gateway, "multi")].makespan
                 / reports[(gateway, "single_circuit")].makespan)
        gains = {c: round(reports[(gateway, "multi")].jobs[c].circuits_per_second
                          / reports[(gateway, "single_circuit")].jobs[c].circuits_per_second, 3)
                 for c, _, _ in clients}
        log(f"  gateway {gateway}: multi / single makespan {ratio:.4f}, per client "
            f"circuits/s gain {gains}")
    log(f"  4 simulations in {time.perf_counter() - t0:.3f} s host clock")
    rep = reports[(False, "multi")]
    spec71 = quclassi.QuClassiConfig(qc=7, n_layers=1).spec
    base = sum(j.n_circuits for j in jobs[:2])  # task ids are allocated job by job
    n71 = jobs[2].n_circuits
    order = {w.worker_id: i for i, w in enumerate(fleet)}
    placed = {tid - base: order[wid] for _, tid, wid in rep.assignments
              if base <= tid < base + n71}
    if len(placed) != n71:
        raise AssertionError(f"cluster (e): {len(placed)} of the 7q1l job's {n71} circuits placed")
    theta = torch.tensor(rng.uniform(0, np.pi, spec71.n_theta), dtype=torch.float32, device=dev)
    data = torch.tensor(rng.uniform(0, np.pi, (15, spec71.n_data)), dtype=torch.float32,
                        device=dev)
    bank = shift_rule.build_bank(theta, data)  # 13 x 15 rows of the job's 201 circuits
    assignment = [placed[i] for i in range(bank.n_circuits)]
    zero_counts(K)
    run = dataplane.worker_batched_executor(spec71, assignment, len(fleet))
    got = run(bank.theta, bank.data)
    read("cluster (e) launches", ("fidelity",))
    diff = float((got - ops.vqc_fidelity(spec71, bank.theta, bank.data)).abs().max())
    log(f"cluster (e): the simulation's placement of the 7q1l job drives "
        f"worker_batched_executor over {bank.n_circuits} rows of a 7q-1l bank, workers used "
        f"{sorted(set(assignment))}: max|diff| to direct ops.vqc_fidelity {diff:.3e} [{card}]")
    if not diff <= TOL:
        raise AssertionError(f"cluster (e): schedule-driven execution differs by {diff}")

    fed_cfg = get_quclassi("quclassi-5q-1l")
    fx, fy = make_pair_dataset(3, 9, n_per_class=16, seed=2)
    ex, ey = make_pair_dataset(3, 9, n_per_class=8, seed=3)
    fed_runs = []
    t0 = time.perf_counter()
    for _ in range(2):
        fed = sim_cluster.federated_session(
            ["t0", "t1", "t2", "t3"], FederatedConfig(n_rounds=3, quorum=0.75, seed=5),
            qcfg=fed_cfg, dataset=(fx, fy), eval_set=(ex, ey))
        fed_runs.append(fed.run())
    seconds = time.perf_counter() - t0
    s1, s2 = (json.dumps(r.summary(), sort_keys=True, default=float) for r in fed_runs)
    same_params = all(fed_runs[0].params[k].tobytes() == fed_runs[1].params[k].tobytes()
                      for k in fed_runs[0].params)
    summ = fed_runs[0].summary()
    log(f"cluster (e): federated quclassi-5q-1l, 4 tenants x 3 rounds, twice in "
        f"{seconds:.3f} s: summaries equal {s1 == s2}, parameters equal {same_params}; "
        f"rounds/s {summ['rounds_per_second']} virtual, accuracy by round "
        f"{summ.get('accuracy_by_round')} [{card}]")
    if s1 != s2 or not same_params:
        raise AssertionError("cluster (e): the federated double run is not bit-identical")

    # (f) the 300-tenant storm of examples/scale_storm.py through real kernels
    storm = scale.WorkloadSpec(
        populations=scale.standard_populations(300, rate_per_tenant=0.4, slo_scale=2.0),
        duration_s=10.0, seed=11).generate()
    zero_counts(K)
    res = scale.replay_real(storm, device=dev)
    read("cluster (f) launches", ("fidelity",))
    log(f"cluster (f): replay_real of {res.n_tenants} tenants: submitted {res.submitted}, "
        f"completed {res.completed}, rejected {res.rejected}, {res.achieved_cps:.1f} "
        f"circuits/s achieved in {res.makespan_s:.4f} s, p50 {res.p50_latency_s:.4f} s, "
        f"p99 {res.p99_latency_s:.4f} s [{card}]")
    if res.completed + res.rejected != res.submitted or res.submitted != storm.n_circuits:
        raise AssertionError(f"cluster (f): {res.completed} + {res.rejected} != {res.submitted}")
    wall_ms, kern, busy_ms = profile_window(lambda: scale.replay_real(storm, device=dev))
    log(f"  storm replay profiled: {wall_ms:.3f} ms host clock, device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.4f}, {sum(e.count for e in kern)} kernel "
        f"launches [{card}]")
    zero_counts(K)  # the profiled run is not counted
    return counts


def quclassi13():
    """The spill slice: 13-qubit, 3-layer QuClassi (m = 6, P = 32) trained
    on 2 workers, the paper's segmentation on 8x8 images (9 patches).
    Returns the config, the round-robin group assignment and each worker's
    groups."""
    from repro_torch.comanager import dataplane
    from repro_torch.core import quclassi, segmentation

    cfg13 = quclassi.QuClassiConfig(
        qc=13, n_layers=3,
        seg=segmentation.SegmentationConfig(filter_width=4, stride=2, n_filters=4),
        image_size=(8, 8))
    n_groups, n_workers = 1 + 2 * cfg13.n_theta, 2
    assign = dataplane.round_robin_assignment(n_groups, n_workers)
    return cfg13, assign, [tuple(g for g in range(n_groups) if assign[g] == w)
                           for w in range(n_workers)]


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
        from repro_torch.kernels import flash_attention as FA
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
            if "registers" in line or "spill" in line or "Function properties" in line:
                log(f"    {line.strip()}")
        reported = ptxas_spills(rep["log"])
        for kernel in NO_SPILL_KERNELS.get(name, ()):
            spills = {f: v for f, v in reported.items() if kernel in f}
            if not spills or any(st for st, _ in spills.values()):
                raise AssertionError(f"ptxas: {kernel} spills or has no report: {spills}")
            log(f"  {kernel}: no spill stores ({spills})")

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
    cfg13, assign13, worker_groups13 = quclassi13()
    spec13, n_workers13 = cfg13.spec, len(worker_groups13)
    plan13 = K.build_shift_plan(spec13)
    n_groups13 = 1 + 2 * cfg13.n_theta

    def angles(spec, c):
        th = rng.uniform(-np.pi, np.pi, (c, spec.n_theta))
        dt = rng.uniform(0.0, np.pi, (c, spec.n_data))
        return (torch.tensor(th, dtype=torch.float32, device=dev),
                torch.tensor(dt, dtype=torch.float32, device=dev))

    errs = {"fidelity": 0.0, "state": 0.0, "shiftbank": 0.0, "shift_forward": 0.0,
            "shift_tile": 0.0, "fidelity_dmem": 0.0, "state_dmem": 0.0}  # against plain only

    def check(kernel: str, label: str, got, want, tol: float = TOL, plain: bool = True):
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if plain:
            errs[kernel] = max(errs[kernel], err)
        log(f"  {kernel:13s} {label:44s} max|diff| = {err:.3e}")
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
    for n in range(10, 15):  # the state kernel's widths beyond the one-thread kernel's 9
        base = circuits.build_quclassi_circuit(n - 1 + n % 2, 1)
        spec = dataclasses.replace(base, n_qubits=n)  # even n: one idle last qubit
        th, dt = angles(spec, 100)
        re, im = K.vqc_state(spec, th, dt)
        pre, pim = K._fused_plain(spec, th, dt, want_state=True)
        warps = K.fused_geometry(n, 100)[0]
        check("state", f"{n} qubits C=100 ({warps} a block) re", re, pre)
        check("state", f"{n} qubits C=100 ({warps} a block) im", im, pim)
    log("checks: the device-memory route (no block holds one state)")
    wide = {qc: circuits.build_quclassi_circuit(qc, 1) for qc in (15, 17)}
    for qc, spec in wide.items():
        if K.fused_geometry(qc, DMEM_ROWS) != (0, 0):
            raise AssertionError(f"{qc} qubits: a block holds the state")
        th, dt = angles(spec, DMEM_ROWS)
        before = dict(K.LAUNCHES)
        p0 = K.vqc_p0(spec, th, dt)
        re, im = K.vqc_state(spec, th, dt)
        if (K.LAUNCHES["fidelity_dmem"], K.LAUNCHES["state_dmem"]) != (
                before["fidelity_dmem"] + 1, before["state_dmem"] + 1):
            raise AssertionError(f"{qc} qubits: not one launch of each device-memory kernel")
        check("fidelity_dmem", f"{qc}q-1l C={DMEM_ROWS}", p0,
              K._fused_plain(spec, th, dt, want_state=False))
        pre, pim = K._fused_plain(spec, th, dt, want_state=True)
        check("state_dmem", f"{qc}q-1l C={DMEM_ROWS} re", re, pre)
        check("state_dmem", f"{qc}q-1l C={DMEM_ROWS} im", im, pim)
        del re, im, pre, pim

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

    def spill_inputs(spec, groups, four=False, budget=K.SMEM_BUDGET_BYTES):
        """The spill pair's table and the plain pair's tile plan for one
        request, whichever route the request takes."""
        plan = K.build_shift_plan(spec)
        tab = K._walk_table(spec, four, tuple(groups), budget, True)
        variants = K._collect_variants(plan, K.shift_values(four), tuple(groups), spec.n_theta)
        return plan, tab, variants, K._tile_plan(plan, variants, tab.tiles)

    def check_spill(label, spec, b, groups, four=False, budget=K.SMEM_BUDGET_BYTES):
        """Each spill kernel against its plain version on the same inputs,
        then the wrapper end to end (on the route the request takes)
        against the plain pair."""
        plan, tab, variants, tile_plan = spill_inputs(spec, groups, four, budget)
        th, dt = angles(spec, b)
        f0, d_state, bnd = K._shift_forward_plain(plan, [lo for lo, _ in tab.tiles], th, dt)
        rows = K._shift_tile_plain(plan, tile_plan, th, dt, d_state, bnd)
        want = K._spilled_rows(variants, tuple(groups), tile_plan, f0, rows)
        label = (f"{label} four={four} G={len(groups)} B={b} tiles={tab.n_tiles} "
                 f"{tab.tb}/{tab.smem_bytes} B, forward {tab.forward_tb}/"
                 f"{tab.forward_smem_bytes} B")
        if not (tab.tb and tab.forward_tb) or max(
                tab.smem_bytes, tab.forward_smem_bytes) > K.SMEM_BUDGET_BYTES:
            raise AssertionError(f"{label}: no block, or more shared memory than a block has")
        var_rows = list(tab.variant_rows)
        f0_rows = [r for r in range(len(groups)) if r not in tab.variant_rows]
        out = torch.full_like(want, float("nan"))
        got_d, got_bnd = K._shift_forward_cuda(tab, th, dt, out)
        check("shift_forward", f"{label} f0", out[f0_rows], want[f0_rows])
        check("shift_forward", f"{label} data state", got_d, d_state)
        check("shift_forward", f"{label} boundaries", got_bnd, bnd)
        out = want.clone()
        out[var_rows] = float("nan")
        K._shift_tile_cuda(tab, th, dt, d_state, bnd, out)
        check("shift_tile", f"{label} rows", out, want)
        route = K.shift_execution_info(spec, b, four_term=four, groups=tuple(groups),
                                       smem_budget=budget)["mode"]
        check("shift_tile" if route == "spill" else "shiftbank", f"{label} wrapper ({route})",
              K.vqc_shift_fidelity(spec, th, dt, four_term=four, groups=tuple(groups),
                                   smem_budget=budget), want)

    log("checks: the spill pair (forward and tile kernels)")
    all13 = tuple(range(n_groups13))
    for groups in (all13, *worker_groups13):
        for b in (100, samples):
            check_spill("13q-3l", spec13, b, groups)
    for name, (qc, nl, n_ckpt) in (("tied-7q-3l", (7, 3, 3)), ("tied-5q-3l", (5, 3, 2))):
        spec = circuits.build_tied_quclassi_circuit(qc, nl)
        for four in (False, True):
            g_all = tuple(range(1 + (4 if four else 2) * spec.n_theta))
            budget = spill_budget(K, spec, four, g_all, n_ckpt)
            check_spill(f"{name} budget={budget}", spec, 100, g_all, four, budget)
    for qc, nl in ((17, 1), (17, 3), (19, 1)):  # m = 8, 8, 9
        spec = circuits.build_quclassi_circuit(qc, nl)
        check_spill(f"{qc}q-{nl}l", spec, 100, tuple(range(1 + 2 * spec.n_theta)))
    bank = shift_rule.build_shift_bank(*angles(spec13, 8))
    mat = bank.materialize()
    check("shiftbank", "13q-3l B=8 vs dense simulator",
          ops.vqc_fidelity_shiftgroups(spec13, bank.theta, bank.data).reshape(-1),
          ref.vqc_fidelity_ref(spec13, mat.theta, mat.data), plain=False)
    # multibank at 13q on both routes: banks packed into one launch equal
    # per-bank launches bit for bit.  The single sweep (the route 13q
    # takes) through the user's entry point; the spill pair under a
    # budget that holds no single-sweep sample.
    banks = [angles(spec13, b) for b in (samples, 100, 333, 64)]
    group_sets = (*worker_groups13, all13, tuple(range(0, n_groups13, 3)))
    forced13 = spill_budget(K, spec13, False, all13, 8)
    for route, budget in (("fused", K.SMEM_BUDGET_BYTES), ("spill", forced13)):
        kernel = "shiftbank" if route == "fused" else "shift_tile"
        if route == "fused":
            outs = ops.vqc_fidelity_shiftgroups_multibank(
                spec13, tuple(t for t, _ in banks), tuple(d for _, d in banks), False,
                group_sets)
        else:
            theta, data, segments = ops._pack_banks(tuple(t for t, _ in banks),
                                                    tuple(d for _, d in banks))
            out = K.vqc_shift_fidelity(spec13, theta, data, groups=all13, smem_budget=budget)
            outs = [out[list(gs), off : off + b] for gs, (off, b) in zip(group_sets, segments)]
        for k, ((th, dt), gs, out) in enumerate(zip(banks, group_sets, outs)):
            info = K.shift_execution_info(spec13, th.shape[0], groups=gs, smem_budget=budget)
            if info["mode"] != route:
                raise AssertionError(f"13q multibank bank {k}: groups {gs} run {info['mode']}, "
                                     f"not {route}")
            plain = K._shiftbank_plain(plan13, K.shift_values(False), gs, cfg13.n_theta, th, dt)
            if route == "fused":
                plain = torch.clamp(plain, 0.0, 1.0)
                per_bank = ops.vqc_fidelity_shiftgroups(spec13, th, dt, False, gs)
            else:
                per_bank = K.vqc_shift_fidelity(spec13, th, dt, groups=gs, smem_budget=budget)
            check(kernel, f"13q-3l {route} multibank bank {k} B={th.shape[0]}", out, plain)
            check(kernel, f"13q-3l {route} multibank bank {k} vs per-bank", out, per_bank,
                  tol=0.0, plain=False)

    # timing at the training path's shapes (quclassi-7q-3l on 4 workers;
    # 13q-3l on 2 workers for the spill pair, forced into the two depth
    # tiles of 11 and 5 checkpoints that earlier runs timed)
    plan7 = K.build_shift_plan(spec7)
    p, d = spec7.n_theta, spec7.n_data
    th_rows, dt_rows = angles(spec7, rows_per_worker)
    th_smp, dt_smp = angles(spec7, samples)
    shifts2 = K.shift_values(False)
    sweep13 = K._walk_table(spec13, False, worker_groups13[0], K.SMEM_BUDGET_BYTES, False)
    two_tiles13 = K.walk_table_bytes(plan13, sweep13.n_variants) + K.walk_smem_bytes(
        plan13.m, 11, K.SPILL_LAUNCH_WARPS)
    _, tab13, _, tile_plan13 = spill_inputs(spec13, worker_groups13[0], budget=two_tiles13)
    los13 = [lo for lo, _ in tab13.tiles]
    th13, dt13 = angles(spec13, samples)
    out13 = torch.empty((len(worker_groups13[0]), samples), dtype=torch.float32, device=dev)
    d13, bnd13 = K._shift_forward_cuda(tab13, th13, dt13, out13)
    fwd_flops, tile_flops = spill_flops(K, plan13, tab13, tile_plan13)
    p13, d13n, dim13 = spec13.n_theta, spec13.n_data, 2**plan13.m
    states13 = 8 * dim13 * (1 + tab13.n_tiles)  # chi seed + boundaries, one way
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
        "shift_forward": (
            lambda: K._shift_forward_cuda(tab13, th13, dt13, out13),
            lambda: K._shift_forward_plain(plan13, los13, th13, dt13),
            samples * fwd_flops,
            samples * (4 * (p13 + d13n) + 4 * tab13.n_f0_rows + states13),
            f"13q-3l B={samples}, G={len(worker_groups13[0])} (worker 0 of 2), "
            f"{tab13.n_tiles} tiles",
        ),
        "shift_tile": (
            lambda: K._shift_tile_cuda(tab13, th13, dt13, d13, bnd13, out13),
            lambda: K._shift_tile_plain(plan13, tile_plan13, th13, dt13, d13, bnd13),
            samples * tile_flops,
            samples * (4 * (p13 + d13n) + states13 + 4 * len(tab13.variant_rows)),
            f"13q-3l B={samples}, {len(tab13.variant_rows)} variant rows, "
            f"{tab13.n_tiles} tiles, {tab13.tb} samples a block",
        ),
    }
    # the device-memory route at 17q-1l, C = 256.  Its bound is the
    # function's (angles in, P0 or the state out, against its flops); the
    # state's traffic over device memory, one pass a gate (``pass_bytes``),
    # is logged beside it as that scheme's own bound
    spec17 = wide[17]
    th17, dt17 = angles(spec17, DMEM_ROWS)
    p17, d17, ops17 = spec17.n_theta, spec17.n_data, len(spec17.ops)
    pass_bytes = {}
    for kname, want_state in (("fidelity_dmem", False), ("state_dmem", True)):
        kern = K.vqc_state if want_state else K.vqc_p0
        timed[kname] = (
            lambda kern=kern: kern(spec17, th17, dt17),
            lambda want_state=want_state: K._fused_plain(spec17, th17, dt17, want_state),
            DMEM_ROWS * (ops_flops(spec17.ops, 17) + (0 if want_state else 2 * 2**17)),
            DMEM_ROWS * (4 * (p17 + d17) + (8 * 2**17 if want_state else 4)),
            f"17q-1l C={DMEM_ROWS} circuits ({ops17} gates a circuit)",
        )
        pass_bytes[kname] = DMEM_ROWS * dmem_pass_bytes(spec17, want_state)
    records = {}
    for kname, (kern, plain, flops, nbytes, shape) in timed.items():
        slow = kname.endswith("_dmem")
        ms = time_ms(kern, iters=5 if slow else 20)
        dev_ms = device_ms(kern, f"{kname}_kernel", iters=5 if slow else 20)
        plain_ms = time_ms(plain, iters=2 if slow else 5, warmup=1)
        bound_ms, bound_by = bound(flops, nbytes)
        records[kname] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
        if kname in pass_bytes:
            records[kname]["pass_bound_ms"] = pass_bytes[kname] / PEAK_BYTES_PER_S * 1e3
            log(f"  {kname}: one pass a gate moves {pass_bytes[kname]} bytes of state "
                f"({pass_bytes[kname] / (DMEM_ROWS * 16 * 2**17):.3f} full read-and-write "
                f"passes a circuit): {records[kname]['pass_bound_ms']:.6f} ms at "
                f"{PEAK_BYTES_PER_S / 1e12} TB/s [{card}]")
        shown = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        log(f"  time {kname:13s} {shape}: kernel {ms:.4f} ms (events; device time "
            f"{shown}), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
            f"({bound_by}; {flops} flops, {nbytes} bytes) [{card}]")
    log("timing: the single sweep and the spill pair in turns, B = 576 "
        f"(SWEEP_MIN_WARPS = {K.SWEEP_MIN_WARPS})")
    routes = {}
    for label, (qc, nl, stride) in (("13q-3l worker 0 of 2", (13, 3, 2)),
                                    ("15q-3l", (15, 3, 1)), ("17q-1l", (17, 1, 1)),
                                    ("17q-3l", (17, 3, 1)), ("19q-1l", (19, 1, 1)),
                                    ("19q-3l", (19, 3, 1))):
        spec = circuits.build_quclassi_circuit(qc, nl)
        plan = K.build_shift_plan(spec)
        groups = tuple(range(0, 1 + 2 * spec.n_theta, stride))
        sweep = K._walk_table(spec, False, groups, K.SMEM_BUDGET_BYTES, False)
        spill = K._walk_table(spec, False, groups, K.SMEM_BUDGET_BYTES, True)
        taken = K._shift_route(spec, False, groups, K.SMEM_BUDGET_BYTES)
        th, dt = angles(spec, samples)

        def run_sweep(sweep=sweep, th=th, dt=dt):
            return K._shiftbank_cuda(sweep, th, dt)

        def run_spill(spill=spill, th=th, dt=dt):
            return K._shift_spilled_cuda(spill, th, dt)

        want = K._shiftbank_plain(plan, shifts2, groups, spec.n_theta, th, dt)
        got_sweep, got_spill = run_sweep(), run_spill()
        check("shiftbank", f"route {label} single sweep", got_sweep, want)
        check("shift_tile", f"route {label} spill pair", got_spill, want)
        check("shift_tile", f"route {label} spill pair vs single sweep", got_spill, got_sweep,
              tol=0.0, plain=False)
        turns = [time_ms(run_sweep), time_ms(run_spill), time_ms(run_spill), time_ms(run_sweep)]
        sweep_dev = device_ms(run_sweep, "shiftbank_kernel")
        fwd_dev = device_ms(run_spill, "shift_forward_kernel")
        tile_dev = device_ms(run_spill, "shift_tile_kernel")
        spill_dev = None if fwd_dev is None or tile_dev is None else fwd_dev + tile_dev
        routes[label] = {
            "taken": "spill" if taken.tiles else "fused",
            "sweep": {"tb": sweep.tb, "smem_bytes": sweep.smem_bytes, "ms": [turns[0], turns[3]],
                      "device_ms": sweep_dev},
            "spill": {"tb": spill.tb, "n_tiles": spill.n_tiles, "forward_tb": spill.forward_tb,
                      "ms": [turns[1], turns[2]], "device_ms": spill_dev,
                      "forward_device_ms": fwd_dev, "tile_device_ms": tile_dev}}
        log(f"  route {label}: single sweep ({sweep.tb} a block, {sweep.smem_bytes} B) "
            f"{turns[0]:.4f} / {turns[3]:.4f} ms, device {sweep_dev}; spill pair "
            f"({spill.n_tiles} tiles, {spill.tb} a block) {turns[1]:.4f} / {turns[2]:.4f} ms, "
            f"device {spill_dev} (forward {fwd_dev}, tile {tile_dev}); the plan takes "
            f"{routes[label]['taken']} [{card}]")
    log("routes: " + json.dumps(routes))
    dmem_records = {k: records.pop(k) for k in ("fidelity_dmem", "state_dmem")}
    log("checks: the flash-attention kernel")
    errs["flash"], records["flash"] = check_flash(dev, card)
    log("kernels: " + json.dumps(
        [{"name": k, "max_abs_err": errs[k], **records[k]} for k in records]
        + [{"name": k, "max_abs_err": errs[k], **dmem_records[k]} for k in dmem_records]))

    # ------------------------------------------------------------- 4. train
    x, y = make_pair_dataset(1, 5, n_per_class=128, seed=0)
    train_set, test_set = train_test_split(x, y)
    steps = len(train_set[1]) // batch
    warm = (train_set[0][:batch], train_set[1][:batch])
    runs = {}
    for mode in ("implicit", "materialized"):
        n_units = n_groups if mode == "implicit" else samples * n_groups
        runs[f"7q {mode}"] = (cfg, mode, "shiftbank" if mode == "implicit" else "fidelity",
                              dataplane.worker_batched_executor(
                                  spec7, dataplane.round_robin_assignment(n_units, n_workers),
                                  n_workers))
    # 13q: the route each worker's request takes (the single sweep at 227 KB)
    route13 = {K.shift_execution_info(spec13, samples, groups=gs)["mode"]
               for gs in worker_groups13}
    if len(route13) != 1:
        raise AssertionError(f"13q workers take different routes: {route13}")
    route13 = route13.pop()
    runs["13q implicit"] = (cfg13, "implicit", "shift_tile" if route13 == "spill" else "shiftbank",
                            dataplane.worker_batched_executor(spec13, assign13, n_workers13))
    inits = {label: quclassi.init_params(c, torch.Generator().manual_seed(0), dev)
             for label, (c, _, _, _) in runs.items()}
    # warm-up, one step per run, so no timed run pays first-call costs
    for label, (c, mode, _, run) in runs.items():
        train(c, warm, test_set, epochs=1, batch_size=batch, executor=run,
              bank_mode=mode, init_params=inits[label], device=dev)

    launches = {k: 0 for k in K.LAUNCHES}
    first = {}
    for label, (c, mode, want, run) in runs.items():
        seen = []

        def recording(*args, run=run, seen=seen):
            out = run(*args)
            if not seen:
                seen.append((args[0], out.detach().clone()))
            return out

        executor = declare(recording, shiftbank=capabilities_of(run).shiftbank)
        torch.cuda.synchronize()
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        zero_flash_counts()
        rep = train(c, train_set, test_set, epochs=1, batch_size=batch, lr=1e-3,
                    executor=executor, bank_mode=mode, seed=0, init_params=inits[label],
                    device=dev)
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        if FA.LAUNCHES["flash"]:
            raise AssertionError(f"{label}: training launched the flash kernel")
        for key in counts:
            launches[key] += counts[key]
        ep = rep.epochs[0]
        first[label] = seen[0]
        log(f"train {label}: loss {ep.loss:.6f}, train acc {ep.train_accuracy:.4f}, "
            f"test acc {ep.test_accuracy:.4f}, {steps} steps in {ep.wall_seconds:.4f} s "
            f"({steps / ep.wall_seconds:.3f} steps/s, "
            f"{ep.circuits_executed / ep.wall_seconds:.1f} circuits/s), "
            f"launches {counts} [{card}]")
        if not math.isfinite(ep.loss):
            raise AssertionError(f"{label}: loss {ep.loss} is not finite")
        if not all(torch.isfinite(v).all() for v in rep.params.values()):
            raise AssertionError(f"{label}: parameters are not finite")
        wanted = ("shift_forward", "shift_tile") if want == "shift_tile" else (want,)
        for key in wanted:
            if counts[key] <= 0:
                raise AssertionError(f"{label}: the {key} kernel was never launched")
    diff = float((first["7q implicit"][1] - first["7q materialized"][1]).abs().max())
    log(f"train 7q: first-step fidelities, implicit vs materialized: max|diff| = {diff:.3e}")
    if not diff <= TOL:
        raise AssertionError(f"implicit and materialized first steps differ by {diff}")
    # 13q: the first bank against the plain version of its route, worker
    # by worker, and through the spill pair under a budget that holds no
    # single-sweep sample (bit for bit the same rows)
    bank, got = first["13q implicit"]
    plain = torch.empty((n_groups13, bank.n_samples), dtype=torch.float32, device=dev)
    forced = torch.empty_like(plain)
    for gs in worker_groups13:
        info = K.shift_execution_info(spec13, bank.n_samples, groups=gs)
        if info["mode"] == "spill":
            rows = K._shift_spilled_plain(plan13, shifts2, gs, cfg13.n_theta, info["tiles"],
                                          bank.theta, bank.data)
        else:
            rows = K._shiftbank_plain(plan13, shifts2, gs, cfg13.n_theta, bank.theta, bank.data)
        plain[list(gs)] = torch.clamp(rows, 0.0, 1.0)
        budget = spill_budget(K, spec13, False, gs, 8)
        if K.shift_execution_info(spec13, bank.n_samples, groups=gs,
                                  smem_budget=budget)["mode"] != "spill":
            raise AssertionError("13q: the forced budget does not spill")
        forced[list(gs)] = torch.clamp(K.vqc_shift_fidelity(
            spec13, bank.theta, bank.data, groups=gs, smem_budget=budget), 0.0, 1.0)
    diff = float((got - plain.reshape(-1)).abs().max())
    log(f"train 13q: first-step fidelities ({route13}) vs the plain version: "
        f"max|diff| = {diff:.3e}")
    if not diff <= TOL:
        raise AssertionError(f"13q first step differs from the plain version by {diff}")
    diff = float((got - forced.reshape(-1)).abs().max())
    log(f"train 13q: first-step fidelities ({route13}) vs the spill pair under a forced "
        f"budget: max|diff| = {diff:.3e}")
    if not diff <= TOL:
        raise AssertionError(f"13q first step differs from the spill pair by {diff}")

    # where one gradient step's time goes (after the counts were read)
    xb = torch.as_tensor(train_set[0][:batch], device=dev)
    yb = torch.as_tensor(train_set[1][:batch], device=dev)
    for label, (c, mode, _, run) in runs.items():
        def step(c=c, run=run, mode=mode, init=inits[label]):
            loss, _, _ = quclassi.grad_shift(c, init, xb, yb, executor=run,
                                             implicit=mode == "implicit")
            return float(loss)

        step()
        wall_ms, kern, busy_ms = profile_window(step)
        log(f"profile {label}: one gradient step {wall_ms:.3f} ms host clock (profiled), "
            f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
            f"{sum(e.count for e in kern)} kernel launches [{card}]")
        log_top(kern, 5)
        for e in kern:
            if "vqc::" in e.key:
                log(f"  circuit kernel {e.self_device_time_total / 1e3:.4f} ms "
                    f"x{e.count} {e.key[:60]}")

    # ------------------------------------------------------------- 5. serve
    launches["flash"], simt_launches = serve_smollm(dev, card)
    records["flash"]["simt"]["launches"] = simt_launches  # float32 prefill of phase 5c

    # ----------------------------------------------------------- 6. gateway
    t0 = time.perf_counter()
    for key, n in serve_gateway(dev, card).items():
        launches[key] += n
    log(f"gateway: phase 6 took {time.perf_counter() - t0:.2f} s wall")

    # ----------------------------------------------------------- 7. cluster
    t0 = time.perf_counter()
    for key, n in cluster_phase(dev, card).items():
        launches[key] += n
    log(f"cluster: phase 7 took {time.perf_counter() - t0:.2f} s wall")

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
        {"name": "shift_forward", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vqc_spill.cu",
         "replaces": "src/repro/kernels/vqc_statevector.py:822"},
        {"name": "shift_tile", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vqc_spill.cu",
         "replaces": "src/repro/kernels/vqc_statevector.py:848"},
        {"name": "flash", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attn_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:31"},
    ]
    for k in kernels:
        n = k["name"]
        k.update(launches=launches[n], max_abs_err=errs[n], **{"library_ms": None, **records[n]})
        if f"{n}_dmem" in dmem_records:  # the device-memory route, as flash carries "simt"
            k["dmem"] = {"route": "cuda", "source": k["source"], "replaces": k["replaces"],
                         "launches": launches[f"{n}_dmem"], "max_abs_err": errs[f"{n}_dmem"],
                         "library_ms": None, **dmem_records[f"{n}_dmem"]}
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
