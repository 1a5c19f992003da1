#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — every CUDA kernel compiled from ``src/repro_torch/kernels/csrc``
               (one nvcc per source, all at once); ptxas (its report
               kept beside a reused library) must show no spill stores
               for any statevector or flash kernel;
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
               hd 128, g 4) in bf16, Granite-34B's MQA (BH 192, hd 128,
               g 48) and Nemotron-4-340B's (BH 384, hd 192, g 12) in both,
               Phi-3-vision's hd 96 (BH 128, g 1) in both, Jamba's (BH
               128, hd 128, g 4) and MusicGen's (BH 128, hd 64, g 1) in
               bf16, with window 64 and non-causal at S 256, at S 100 (the
               last tile part full), S 1 and S 192, within 2e-5 (f32) and
               2e-2 (bf16), then both routes are timed at the smollm,
               granite-34b, nemotron, phi-3-vision, jamba and musicgen
               prefill shapes (4 x 2048) beside
               ``scaled_dot_product_attention`` (timed only);
  4. train   — QuClassi Algorithm 1 through the data plane's
               ``worker_batched_executor``, 3 steps of 64 images after one
               warm-up step each: ``quclassi-7q-3l`` on 4 workers with
               implicit banks (shift kernel) and materialized (fused
               kernel), then 13-qubit, 3-layer QuClassi on 2 workers with
               implicit banks (the single-sweep shift kernel: each
               worker's checkpoints fit its launch's block; the first bank
               is also run through the spill pair under a forced budget).
               Launch counts are zeroed just before each run and read just
               after.  Then the dense layer's gradient on the card: its
               register route (``dense_grad_phase``) at these steps' shapes
               and the 7q cell's, and its wide route (``dense_wide_phase``)
               at m = 13, 14 and 16 and in steps of the 27q cell; then one
               profiled gradient step per run shows where the time goes;
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
  8. zoo     — the MoE, MLA, MQA and squared-ReLU models, seeded, counts
               zeroed before each prefill and read after: (a)
               ``granite-moe-3b-a800m`` at full width and depth (bf16, 40
               experts top-8) through the flash kernel, a 4 x 2048 prefill
               (32 flash_wgmma launches, capacity and dropped pairs, tokens/s,
               a profiled idle share and top device ops, the MoE layer's and
               its expert bank's share of busy time) and 4 x (64 + 16) cached
               decode; (b) ``deepseek-v3-671b`` at full width, 2 layers (MLA,
               256 + 1 experts top-8, about 50 GB), a 4 x 512 prefill and 4 x
               (16 + 8) decode, then float32, 1 layer, dropless: absorbed-MLA
               decode logits within 1e-3 of the decompressed prefill's and the
               first token equal; (c) ``granite-34b`` at full width, 2 layers,
               float32: naive, chunked (chunk 1024) and flash (SIMT)
               prefills of 4 x 2048 within 1e-4, then the bf16 prefill on the
               wgmma route, its attention timed against
               ``scaled_dot_product_attention``; (d) ``nemotron-4-340b`` at
               full width, 1 layer, bf16: the flash attention layer within
               2e-2 of the naive one, relative to max(1, |naive|) (the
               logits' difference logged in bf16 steps); (e) checkpoints: the 7q-3l parameters trained in phase
               4, and ``granite-moe-3b-a800m`` at 1 layer in float32 restored
               into a fresh model, equal bit for bit.
  9. ssm/mm  — the SSM / xLSTM mixers and the multimodal frontends, seeded,
               published widths, each model freed before the next, counts
               zeroed before each prefill and read after: (a)
               ``jamba-v0.1-52b`` cut to one period (8 layers: 7 Mamba, 1
               attention through flash at hd 128 g 4, MoE 16 experts top-2
               on layers 1, 3, 5, 7), bf16: a 4 x 2048 prefill (1
               flash_wgmma launch, capacity and dropped pairs, the Mamba
               mixers' and MoE layers' share of busy time by CUDA events,
               peak memory) and 4 x (64 + 16) decode, then float32,
               dropless: the cached decode's logits over 2 x 64 positions
               within 1e-3 of the prefill's, first token equal; (b)
               ``xlstm-125m`` whole (6 mLSTM + 6 sLSTM): the same runs, no
               kernel launched, the sLSTM loop's launches; (c)
               ``phi-3-vision-4.2b`` whole: 576 projected patch embeddings
               + 1,472 text tokens, 32 flash_wgmma launches at hd 96, the
               flash attention layer within 2e-2 of naive relative to
               max(1, |naive|), text decode; (d) ``musicgen-large`` whole
               (4 codebooks): 4 x 2048 frames, decode per codebook; (e)
               xlstm-125m in float32 through ``repro_torch.checkpoint`` bit
               for bit, and a bf16 reduced Jamba's float32 leaves kept
               through ``params_to_numpy`` -> ``params_from_numpy``.
 10. train   — LM training through ``make_train_step``, counts zeroed
               before each training run and read after (no kernel of the
               port launches: attention trains through ``naive``): (a)
               ``smollm-360m`` at full width and depth (32 layers, bf16,
               seeded weights, its own naive attention and per-layer
               remat, AdamW), global batch 64 x 1024 in two interleaved
               microbatches of 32 rows: one warm-up step whose loss must
               be within 1e-3 relative of the cross-entropy of a no-grad
               prefill of the same batch, with a finite global gradient
               norm, then 3 timed steps on the same batch (the loss must
               fall), tokens/s, step time, peak memory, matmul FLOPs
               against the bf16 peak, and one profiled step's idle share
               and top device operations; (b) every architecture's
               ``reduced()`` config, float32: one step of global batch 4
               on the card against the same step on the CPU (loss within
               1e-5 relative, parameters within 1e-5, AdamW leaves where
               |g| > 1e-3 max|g|); (c) a loss through the flash kernel
               with grad enabled raises, launching nothing;
 11. dry-run — (a) the paper's bank dry-run (``launch/quantum_dryrun.py``,
               ``quclassi-7q-3l`` x 1,048,576 circuits): its records on a
               1 x 1 mesh and the 16 x 16 pod, the whole bank through
               ``fidelity_kernel`` and through the per-gate plain path on
               the card (within 1e-5), both timed beside the fused and
               per-gate traffic bounds and the kernel's operations bound;
               (b) a slice of it placed by ``bank_shardings`` over 1 and 3
               shards and run by ``sharded_executor``, bit-equal to
               ``worker_batched_executor``; (c) the LM dry-run
               (``launch/dryrun.py``) of ``smollm-360m`` x ``train_4k`` on
               16 x 16 and at phase 10a's 64 x 1024 on 1 x 1: its argument
               bytes for parameters and AdamW state equal to the bytes the
               card's allocator is asked for them, its FLOPs beside
               ``train_flops``.  Records in ``chiprun_out/dryrun/``.
 12. faults  — the serving fleet's fault tolerance on phase 6a's Fig-6 mix
               and fleet (5/10/15/20-qubit workers, 2 slots each): every
               future bit-equal to phase 6a's fault-free sync run, and every
               failure the fleet records one the injector raised (its
               failure count equals the attempts the injector refused): (a)
               crash migration, no retry, one failure trips the breaker,
               the crash at 0.3 of a fault-free run's time (sync: w2, which
               sync placement gives the 7-qubit batches; async: w3): the
               worker offline, a batch migrated; (b) w2 flaky (p = 0.3),
               two in-place retries: a retry; (c) async, w3 slowed x3,
               hedge_k 0.5 (which hedges healthy batches too): w3's batches
               hedged, w3 giving fewer batches' results than in an unslowed
               control run, every future resolved once; (d) w4 drained and
               a 20-qubit w5 registered halfway: no later batch on w4; (e)
               phase 6b's two tenants training quclassi-7q-3l while w2
               crashes and recovers: losses and parameters equal to the
               fault-free runs' bit for bit; (f) (a) async and (c) traced:
               ``validate_trace`` clean, migrated and hedged stages
               present.  (a), (b), (d) run sync and async.  Circuits/s with
               and without the fault, per-tenant p50/p99, the counters,
               the attempts the faulted worker ran before its first refusal
               and each part's async idle share are logged; counts are
               zeroed before each part and read after.
 13. examples — the ten example programs (``repro_torch.examples``), each
               run in this process through ``main([..., "--device",
               "cuda"])`` at the reference's default arguments, counts
               zeroed just before each program and read just after (one
               line each, with its wall time; a program that runs circuits
               must launch the kernels ``EXAMPLES`` names), its output kept
               in ``chiprun_out/examples/card/``; the comparison runs on the
               CPU in ``chiprun_out/examples/cpu/``: (a)
               ``multitenant_serving``, ``scale_storm``, ``trace_demo``
               (the virtual clock): output equal to the CPU run's, and
               ``trace_demo.json`` byte for byte; (b) ``quickstart``:
               fidelities within 1e-5 of the CPU run's on the same seeded
               angles, the shift-vs-autodiff gap <= 1e-4; (c)
               ``failure_injection``: the scenes' own bit-identity asserts,
               and every failure the fleet records one the injector raised;
               (d) ``gateway_serving``: gateway gradients within 1e-5 of
               local ones; (e) ``cluster_api``: the five backend families
               within 1e-5 of ``batched``, the session gradient equal to the
               legacy one bit for bit; (f) ``distributed_training``, 12
               epochs: the co-Manager's spread equal to the CPU run's and the
               first epoch's loss within 1e-4 of one CPU epoch's, the final
               accuracy logged; (g) ``federated_dql``: scene 1's accuracy by
               round equal to the CPU run's, scenes 2-3's output equal; (h)
               ``transformer_train``, 200 steps at full width (the program
               asserts that the loss falls): the checkpoint round trip bit
               for bit, tokens/s logged.
 14. wide    — shift plans of m >= 13 on the shift walk's device-memory
               route (``shift_dmem_kernel`` of vqc_shift_dmem.cu): (a) the
               kernel against its plain version within 1e-5 at 27q-1l,
               27q-3l, 29q-1l and 33q-1l (B = 100; whole banks and each
               worker's groups of the 2-worker round robin) and 27q-3l at
               B = 1,152 (a training step's samples), then timed there
               beside its plain version, its operations bound and its
               passes' traffic (beside the first kernel's); (b) 21q-3l
               and 25q-1l forced onto it (a 64-byte budget) against the
               spill pair within 1e-6, the bit-equal rows counted, both
               timed in turns; (c) one
               Algorithm-1 step of 27-qubit, 3-layer QuClassi (batch 64, 9
               patches, no dense layer) through the 2-worker implicit
               executor: 3 timed steps (steps/s, launches, peak memory),
               one profiled (idle share), the first bank against the plain
               version, the loss and gradients against the same step on the
               CPU within 1e-5 x the largest chain factor; (d) a 27q-1l
               implicit bank of 64 samples through ``GatewayRuntime`` sync
               and async on workers of 27 and 33 qubits: no mesh spill,
               sync == async == ``ops.vqc_fidelity_shiftgroups`` bit for
               bit.  Counts are zeroed before (c) and (d) and read after.
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
#: phase 10: a float32 train step's loss and parameters on the card against
#: the CPU port's (TF32 off)
TRAIN_RTOL = 1e-5
#: AdamW leaves are compared where |g| > TRAIN_ADAM_MASK * max |g| of the
#: leaf: a first Adam step is +-lr by the gradient's sign (ROADMAP R7)
TRAIN_ADAM_MASK = 1e-3
#: step 0's bf16 loss against the cross-entropy of a no-grad prefill
TRAIN_PREFILL_RTOL = 1e-3
TRAIN_ARCHS = ("nemotron-4-340b", "phi-3-vision-4.2b", "granite-34b", "smollm-360m",
               "qwen3-4b", "granite-moe-3b-a800m", "musicgen-large", "xlstm-125m",
               "jamba-v0.1-52b", "deepseek-v3-671b")
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
    the gaps in which the card waits for the host.  The profiler may drop
    a few kernel records of a window: then the mean is over the launches it
    recorded (said in the log), and None, said too, when two windows both
    hold fewer than half of them."""
    return device_ms_each(fn, (kernel,), iters)[kernel]


def device_ms_each(fn, kernels, iters: int = 20) -> dict:
    """``device_ms`` of each of ``kernels``, each launched once a call of
    ``fn``, from the same profiler windows."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cuda_kind = torch.autograd.DeviceType.CUDA
    out, count = {}, {}
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == cuda_kind]
        for kernel in kernels:
            if kernel in out:
                continue
            hits = [e for e in events if kernel in e.key]
            count[kernel] = sum(e.count for e in hits)
            if 2 * count[kernel] >= iters:
                if count[kernel] != iters:
                    log(f"  the profiler recorded {count[kernel]} of {iters} launches of "
                        f"{kernel}: device time is their mean")
                out[kernel] = sum(e.self_device_time_total for e in hits) / 1e3 / count[kernel]
        if len(out) == len(kernels):
            return out
    for kernel in kernels:
        if kernel not in out:
            log(f"  the profiler recorded {count[kernel]} of {iters} launches of {kernel}: "
                "device time not measured")
            out[kernel] = None
    return out


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
                    "vqc_spill": ("shift_forward_kernel", "shift_tile_kernel"),
                    "vqc_shift_dmem": ("shift_dmem_kernel",),
                    "flash_attn": ("flash_fwd_kernel",),
                    "flash_attn_sm90": ("flash_wgmma_kernel",)}


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profile_window(fn, cpu: bool = True):
    """Run ``fn`` once under ``torch.profiler``: host-clock ms (ending in a
    synchronise), the CUDA kernels' key averages, and their busy ms.
    ``cpu=False`` records the CUDA activity alone (a window of hundreds of
    thousands of launches then costs seconds, not minutes, to read)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
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
    serving paths' shapes and the edge cases, each on its dtype's route,
    then timed at the prefill shapes of ``FLASH_SHAPES``.  Returns (max
    |diff| of the bf16 route, timing record of the first shape with the
    float32 route's under "simt" and every shape's under "shapes")."""
    from repro_torch.kernels import flash_attention as FA

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # label, BH, S, hd, dtype, groups, causal, window
        ("smollm-360m prefill", 60, 2048, 64, bf16, 3, True, 0),
        ("smollm-360m prefill", 60, 2048, 64, f32, 3, True, 0),
        ("qwen3-4b prefill", 32, 2048, 128, bf16, 4, True, 0),
        ("granite-34b prefill (MQA)", 192, 2048, 128, bf16, 48, True, 0),
        ("granite-34b prefill (MQA)", 192, 2048, 128, f32, 48, True, 0),
        ("nemotron-4-340b prefill", 384, 2048, 192, bf16, 12, True, 0),
        ("nemotron-4-340b prefill", 384, 2048, 192, f32, 12, True, 0),
        ("part-full tile", 6, 100, 192, bf16, 3, True, 64),
        ("part-full tile", 6, 100, 192, f32, 3, False, 0),
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
        ("phi-3-vision-4.2b prefill", 128, 2048, 96, bf16, 1, True, 0),
        ("phi-3-vision-4.2b prefill", 128, 2048, 96, f32, 1, True, 0),
        ("jamba-v0.1-52b prefill", 128, 2048, 128, bf16, 4, True, 0),
        ("musicgen-large prefill", 128, 2048, 64, bf16, 1, True, 0),
        ("part-full tile", 6, 100, 96, bf16, 3, True, 64),
        ("part-full tile", 6, 100, 96, f32, 3, False, 0),
        ("1.5 tiles", 6, 192, 96, bf16, 3, False, 65),
        ("one row", 4, 1, 96, bf16, 1, True, 0),
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

    # timing at the serving paths' shapes, 4 requests x 2048 tokens, bf16 on
    # the wgmma route and float32 on the SIMT route: smollm-360m (the row's
    # main shape, phase 5), granite-34b's MQA and nemotron-4-340b's hd 192
    # (phase 8), phi-3-vision's hd 96, jamba's hd 128 g 4 and musicgen's
    # hd 64 g 1 (phase 9)
    timed = [time_flash(dev, card, *shape) for shape in FLASH_SHAPES]
    main = dict(timed[0])
    simt = {"source": "src/repro_torch/kernels/csrc/flash_attn.cu", "dtype": "float32",
            "max_abs_err": worst[f32], **main.pop("simt")}
    return worst[bf16], {**main, "simt": simt, "shapes": timed}


#: flash timing shapes: label, batch, heads, kv heads, S, hd
FLASH_SHAPES = (("smollm-360m prefill", 4, 15, 5, 2048, 64),
                ("granite-34b prefill", 4, 48, 1, 2048, 128),
                ("nemotron-4-340b prefill", 4, 96, 8, 2048, 192),
                ("phi-3-vision-4.2b prefill", 4, 32, 32, 2048, 96),
                ("jamba-v0.1-52b prefill", 4, 32, 8, 2048, 128),
                ("musicgen-large prefill", 4, 32, 32, 2048, 64))


def time_flash(dev, card: str, label: str, b: int, h: int, kv: int, s: int, hd: int) -> dict:
    """Both flash routes at one causal prefill shape: CUDA events around
    back-to-back calls (``ms``), the kernel's profiled device time, the
    plain version, ``scaled_dot_product_attention`` and the bound."""
    from repro_torch.kernels import flash_attention as FA

    g = h // kv
    q, k, v = flash_inputs(b * h, s, hd, torch.bfloat16, g, dev, seed=99)
    call = lambda: FA.flash_attention(q, k, v, groups=g)  # noqa: E731
    ms = time_ms(call, iters=50)
    dev_ms = device_ms(call, "flash_wgmma_kernel")
    plain_ms = time_ms(lambda: FA._flash_plain(q, k, v, groups=g), iters=3, warmup=1)
    q4, k4, v4 = q.view(b, h, s, hd), k.view(b, kv, s, hd), v.view(b, kv, s, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(q4, k4, v4, is_causal=True, scale=1.0, enable_gqa=True)  # noqa: E731
    library_ms = time_ms(library, iters=50)
    lib_diff = float((library().reshape(b * h, s, hd).float() - call().float()).abs().max())
    q32, k32, v32 = (t.float() for t in (q, k, v))
    simt_call = lambda: FA.flash_attention(q32, k32, v32, groups=g)  # noqa: E731
    simt_ms = time_ms(simt_call, iters=10)
    simt_dev = device_ms(simt_call, "flash_fwd_kernel", iters=5)
    f4 = q32.view(b, h, s, hd), k32.view(b, kv, s, hd), v32.view(b, kv, s, hd)
    library32 = lambda: sdpa(*f4, is_causal=True, scale=1.0, enable_gqa=True)  # noqa: E731
    library32_ms = time_ms(library32, iters=10)
    lib32_diff = float((library32().reshape(b * h, s, hd) - simt_call()).abs().max())
    flops = 4 * b * h * hd * s * (s + 1) // 2          # visible (query, key) pairs
    nbytes = 2 * (2 * b * h + 2 * b * kv) * s * hd     # q and o at h heads, k and v at kv
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    simt_bound_ms, simt_bound_by = bound(flops, 2 * nbytes, PEAK_F32_FLOPS)
    log(f"  time flash_wgmma   {label}: BH={b * h} S={s} hd={hd} g={g} bf16 causal: kernel "
        f"{ms:.4f} ms (device {dev_ms}), plain {plain_ms:.4f} ms, scaled_dot_product_attention "
        f"{library_ms:.4f} ms (max|diff| to the kernel {lib_diff:.3e}), bound {bound_ms:.6f} ms "
        f"({bound_by}; {flops} flops, {nbytes} bytes) [{card}]")
    log(f"  time flash_simt    {label}: the same inputs in float32: kernel {simt_ms:.4f} ms "
        f"(device {simt_dev}), bound {simt_bound_ms:.6f} ms ({simt_bound_by} at float32's "
        f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s), float32 scaled_dot_product_attention "
        f"{library32_ms:.4f} ms (the kernel takes {simt_ms / library32_ms:.2f}x its time; max|diff| "
        f"{lib32_diff:.3e}), wgmma route {simt_ms / ms:.1f}x faster [{card}]")
    return {"shape": label, "bh": b * h, "s": s, "hd": hd, "groups": g, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_max_abs_diff": lib_diff,
            "simt": {"ms": simt_ms, "device_ms": simt_dev, "bound_ms": simt_bound_ms,
                     "bound_by": simt_bound_by, "library_ms": library32_ms,
                     "library_max_abs_diff": lib32_diff}}


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
    serve_step = steps.make_serve_step(cfg, model=model)[0]
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
    serve32 = steps.make_serve_step(cfg32, model=model32)[0]
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


class MoESpy:
    """Records the routing of every ``moe_ffn`` call while active (the
    smoke's own view; the model does not return it)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.orig, self.calls = moe, moe.moe_ffn, []

    def __enter__(self):
        def spy(params, x, cfg, stats=None):
            st = {}
            out = self.orig(params, x, cfg, stats=st)
            self.calls.append(st)
            return out

        self.moe.moe_ffn = spy
        return self

    def __exit__(self, *exc):
        self.moe.moe_ffn = self.orig

    def dropped(self) -> tuple[int, int]:
        """(dropped (token, k) pairs, all pairs) over the recorded calls."""
        kept = sum(int(c["keep"].sum()) for c in self.calls)
        total = sum(c["keep"].numel() for c in self.calls)
        return total - kept, total


def free() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def timed_prefill(prefill, batch, runs: int = 3) -> tuple[float, list]:
    """Mean host-clock ms of ``runs`` prefills, each ending in a synchronise."""
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        prefill(batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return sum(out) / len(out), out


def decode_requests(steps, serve, model, cfg, b: int, plen: int, gen: int, card: str,
                    label: str) -> torch.Tensor:
    """``b`` requests, a seeded ``plen``-token prompt each (frames of K
    codes for audio, text for a VLM), ``gen`` greedy positions through the
    cache; generated tokens/s (frames/s for audio) logged."""
    from repro_torch.models import multimodal

    serve_step = steps.make_serve_step(cfg, model=model)[0]
    key = "codes" if cfg.n_codebooks else "tokens"
    make = multimodal.audio_batch if cfg.n_codebooks else multimodal.text_batch
    prompt = make(cfg, b, plen, seed=1)
    serve.generate(serve_step, model, {key: prompt[key][:, :2]}, 1)  # warm-up
    res = serve.generate(serve_step, model, prompt, gen)
    toks = res["tokens"]
    shape = (b, gen, cfg.n_codebooks) if cfg.n_codebooks else (b, gen)
    if toks.shape != shape or not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{label}: generated tokens {tuple(toks.shape)} out of range")
    unit = f"frames (of {cfg.n_codebooks} codes)" if cfg.n_codebooks else "tokens"
    log(f"{label} decode: {b} x ({plen} prompt + {gen} generated) cached decode steps: "
        f"prompt {res['prompt_s'] * 1e3:.3f} ms, generation {res['gen_s'] * 1e3:.3f} ms, "
        f"{b * gen / res['gen_s']:,.1f} generated {unit}/s; request 0: "
        f"{(toks[0, :, 0] if cfg.n_codebooks else toks[0]).tolist()} [{card}]")
    one = {key: prompt[key][:, :1]}
    wall_ms, kern, busy_ms = profile_window(lambda: serve.generate(serve_step, model, one, 1))
    log(f"profile {label} decode: 2 cached decode steps in {wall_ms:.3f} ms host clock "
        f"(profiled), device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
        f"{sum(e.count for e in kern)} kernel launches [{card}]")
    return toks


def serve_zoo(dev, card: str, qparams: dict) -> dict:
    """Phase 8: the MoE, MLA, MQA and squared-ReLU models and checkpoints.
    Returns the flash launches of its main-path runs per route."""
    from repro_torch import checkpoint
    from repro_torch.configs import base as cfg_base
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import vqc_statevector as K
    from repro_torch.launch import serve, steps
    from repro_torch.models import moe, multimodal, transformer

    launched = {"flash_wgmma": 0, "flash_simt": 0}

    def count_from_zero():
        torch.cuda.synchronize()
        zero_flash_counts()
        zero_counts(K)

    def read_counts(label, want):
        torch.cuda.synchronize()
        if {k: FA.LAUNCHES[k] for k in want} != want:
            raise AssertionError(f"{label}: flash launches {dict(FA.LAUNCHES)}, want {want}")
        others = {k: n for k, n in K.LAUNCHES.items() if n}
        if others:
            raise AssertionError(f"{label}: launched circuit kernels {others}")
        for key in launched:
            launched[key] += FA.LAUNCHES[key]

    # (a) granite-moe-3b-a800m at full width and depth through the flash
    # kernel; (b) deepseek-v3-671b at full width, 2 layers (MLA, 256 + 1
    # shared experts)
    t_phase = time.perf_counter()
    for name, change, (b, s), (plen, gen) in (
            ("granite-moe-3b-a800m", dict(attention_impl="flash"), (4, 2048), (64, 16)),
            ("deepseek-v3-671b", dict(n_layers=2), (4, 512), (16, 8))):
        cfg = cfg_base.get(name).with_(**change)
        t0 = time.perf_counter()
        prefill, model = steps.make_prefill_step(cfg, device=dev)
        torch.cuda.synchronize()
        attn = (f"MLA q/kv ranks {cfg.mla.q_lora_rank}/{cfg.mla.kv_lora_rank}" if cfg.mla else
                f"{cfg.kv_heads} kv heads, hd {cfg.resolved_head_dim}, {cfg.attention_impl}")
        log(f"zoo {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
            f"{attn}, {cfg.moe.n_experts} + {cfg.moe.n_shared_experts} experts "
            f"top-{cfg.moe.top_k}, {cfg.dtype}, {transformer.param_count(model):,} parameters "
            f"({transformer.active_param_count(cfg, model):,} active a token), "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card (seeded init in "
            f"{time.perf_counter() - t0:.2f} s)")
        batch = multimodal.text_batch(cfg, b, s, seed=0)
        prefill(batch)  # warm-up
        count_from_zero()
        with MoESpy() as spy:
            logits = prefill(batch)
        n_flash = cfg.n_layers if cfg.attention_impl == "flash" else 0
        read_counts(f"{cfg.name} prefill", {"flash_wgmma": n_flash, "flash_simt": 0})
        if logits.shape != (b, s, cfg.vocab) or not torch.isfinite(logits.float()).all():
            raise AssertionError(f"{cfg.name}: prefill logits {tuple(logits.shape)} not finite")
        del logits
        dropped, pairs = spy.dropped()
        cap = spy.calls[0]["capacity"]
        if cap != moe.capacity(cfg, b * s):
            raise AssertionError(f"{cfg.name}: capacity {cap}, want {moe.capacity(cfg, b * s)}")
        ms, runs = timed_prefill(prefill, batch)
        log(f"{cfg.name} prefill: {b} x {s} tokens in {ms:.3f} ms mean of {len(runs)} "
            f"({', '.join(f'{r:.3f}' for r in runs)}), {b * s / ms * 1e3:,.1f} tokens/s; "
            f"{n_flash} flash_wgmma launches; capacity {cap} a expert, dropped (token, k) pairs "
            f"{dropped} of {pairs} ({dropped / pairs:.4f}); peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB [{card}]")
        wall_ms, kern, busy_ms = profile_window(lambda: prefill(batch))
        log(f"profile {cfg.name} prefill: {wall_ms:.3f} ms host clock (profiled), device busy "
            f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
            f"{sum(e.count for e in kern)} kernel launches [{card}]")
        log_top(kern, 8)
        moe_share(model, cfg, b, s, busy_ms, dev, card)
        decode_requests(steps, serve, model, cfg, b, plen, gen, card, cfg.name)
        del model, prefill
        free()

    # (b) float32, 1 layer, dropless: cached decode (absorbed MLA) against
    # the prefill (decompressed MLA)
    cfg32 = cfg.with_(n_layers=1, dtype="float32",
                      moe=dataclasses.replace(cfg.moe, dropless=True))
    t0 = time.perf_counter()
    prefill32, model32 = steps.make_prefill_step(cfg32, device=dev)
    serve32 = steps.make_serve_step(cfg32, model=model32)[0]
    torch.cuda.synchronize()
    prompt = multimodal.text_batch(cfg32, 4, 16, seed=0)
    count_from_zero()
    full = prefill32(prompt).float()
    read_counts(f"{cfg.name} float32 prefill", {"flash_wgmma": 0, "flash_simt": 0})
    res = serve.generate(serve32, model32, prompt, 1, keep_logits=True)
    diff = float((res["prompt_logits"] - full).abs().max())
    first_ok = torch.equal(res["tokens"][:, 0].cpu(), full[:, -1].argmax(-1).cpu())
    log(f"{cfg.name} consistency (float32, 1 layer, dropless, capacity "
        f"{moe.capacity(cfg32, 64)}): absorbed-MLA decode vs decompressed prefill logits over "
        f"4 x 16 positions: max|diff| = {diff:.3e} (limit {SERVE_TOL}), logit scale "
        f"{float(full.abs().max()):.3f}; first generated token equal: {first_ok}; peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t0:.2f} s with the init [{card}]")
    if not (diff <= SERVE_TOL and first_ok):
        raise AssertionError(f"deepseek decode and prefill disagree: {diff}, first {first_ok}")
    del model32, prefill32, serve32, full, res
    free()

    # (c) granite-34b, full width, 2 layers, float32: MQA through the naive,
    # chunked and flash (SIMT) prefills; then bf16 through flash_wgmma
    cfg = cfg_base.get("granite-34b").with_(n_layers=2, dtype="float32", attention_chunk=1024)
    b, s = 4, 2048
    model = transformer.Model(cfg, device=dev)
    batch = multimodal.text_batch(cfg, b, s, seed=0)
    outs = {}
    with torch.no_grad():
        for impl in ("naive", "chunked", "flash"):
            model.cfg = cfg.with_(attention_impl=impl)
            count_from_zero()
            outs[impl] = model.prefill(batch)[0]
            read_counts(f"{cfg.name} {impl} prefill",
                        {"flash_wgmma": 0, "flash_simt": cfg.n_layers if impl == "flash" else 0})
    d_chunk = float((outs["chunked"] - outs["naive"]).abs().max())
    d_flash = float((outs["flash"] - outs["naive"]).abs().max())
    log(f"{cfg.name} (2 layers, float32, MQA g {cfg.n_heads}, hd {cfg.resolved_head_dim}): "
        f"{b} x {s} prefill logits, chunked (chunk {cfg.attention_chunk}) vs naive max|diff| = "
        f"{d_chunk:.3e}, flash (SIMT) vs naive {d_flash:.3e} (limit 1e-4), logit scale "
        f"{float(outs['naive'].abs().max()):.3f} [{card}]")
    if not (d_chunk <= 1e-4 and d_flash <= 1e-4):
        raise AssertionError(f"granite-34b prefills disagree: chunked {d_chunk}, flash {d_flash}")
    del model, outs
    free()
    cfg16 = cfg.with_(dtype="bfloat16", attention_impl="flash")
    prefill, model = steps.make_prefill_step(cfg16, device=dev)
    prefill(batch)
    count_from_zero()
    logits = prefill(batch)
    read_counts(f"{cfg.name} bf16 prefill", {"flash_wgmma": cfg.n_layers, "flash_simt": 0})
    if not torch.isfinite(logits.float()).all():
        raise AssertionError("granite-34b bf16 logits are not finite")
    del logits
    ms, runs = timed_prefill(prefill, batch)
    with torch.no_grad():
        h = model.embed_inputs(batch)
        mixer = model.blocks[0].mixer
        flash_ms = time_ms(lambda: blocks_attention(model, cfg16, "flash", h), iters=10)
        sdpa_ms = time_ms(lambda: sdpa_attention(mixer, h, cfg16), iters=10)
    log(f"{cfg.name} bf16 prefill (2 layers, flash_wgmma): {b} x {s} tokens in {ms:.3f} ms "
        f"mean of {len(runs)}, {b * s / ms * 1e3:,.1f} tokens/s; one attention layer through "
        f"the flash kernel {flash_ms:.4f} ms, through scaled_dot_product_attention "
        f"{sdpa_ms:.4f} ms (same projections) [{card}]")
    del model, prefill, h
    free()

    # (d) nemotron-4-340b, full width, 1 layer, bf16 (hd 192, squared ReLU)
    cfg = cfg_base.get("nemotron-4-340b").with_(n_layers=1)
    b, s = 2, 2048
    t0 = time.perf_counter()
    model = transformer.Model(cfg, device=dev)
    torch.cuda.synchronize()
    log(f"zoo {cfg.name} (1 layer): d {cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads, "
        f"hd {cfg.resolved_head_dim}, d_ff {cfg.d_ff} ({cfg.activation}), vocab {cfg.vocab}, "
        f"{transformer.param_count(model):,} parameters (seeded init in "
        f"{time.perf_counter() - t0:.2f} s)")
    batch = multimodal.text_batch(cfg, b, s, seed=0)
    with torch.no_grad():
        model.cfg = cfg.with_(attention_impl="flash")
        model.prefill(batch)
        count_from_zero()
        t0 = time.perf_counter()
        flash_logits = model.prefill(batch)[0]
        torch.cuda.synchronize()
        flash_ms = (time.perf_counter() - t0) * 1e3
        read_counts(f"{cfg.name} flash prefill", {"flash_wgmma": 1, "flash_simt": 0})
        model.cfg = cfg.with_(attention_impl="naive")
        naive_logits = model.prefill(batch)[0]
        h = rms_norm_of_embed(model, batch)
        att = {impl: blocks_attention(model, cfg, impl, h) for impl in ("flash", "naive")}
    # bf16 spacing grows with magnitude: the flash tolerance (2e-2, for
    # values of order 1) is applied to |diff| / max(1, |naive|)
    naive_att = att["naive"].float()
    d_abs = (att["flash"].float() - naive_att).abs()
    d_att = float((d_abs / naive_att.abs().clamp(min=1.0)).max())
    d_log = float((flash_logits.float() - naive_logits.float()).abs().max())
    scale = float(naive_logits.float().abs().max())
    step = 2.0 ** (math.floor(math.log2(scale)) - 7)
    log(f"{cfg.name} (1 layer, bf16): {b} x {s} flash prefill {flash_ms:.3f} ms "
        f"({b * s / flash_ms * 1e3:,.1f} tokens/s); attention layer output, flash vs naive: "
        f"max|diff| / max(1, |naive|) = {d_att:.3e} (limit {FLASH_TOL[torch.bfloat16]}; "
        f"max|diff| {float(d_abs.max()):.3e} at outputs up to "
        f"{float(naive_att.abs().max()):.3f}); logits max|diff| = {d_log:.3e} "
        f"({d_log / step:.1f} bf16 steps at the logits' scale {scale:.3f}) [{card}]")
    if not (d_att <= FLASH_TOL[torch.bfloat16] and torch.isfinite(flash_logits.float()).all()):
        raise AssertionError(f"nemotron flash and naive attention differ by {d_att}")
    del model, flash_logits, naive_logits, att, h
    free()

    # (e) checkpoints
    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    ckdir.mkdir(parents=True, exist_ok=True)
    path = str(ckdir / "quclassi.npz")
    t0 = time.perf_counter()
    checkpoint.save(path, qparams, {"config": "quclassi-7q-3l"})
    t1 = time.perf_counter()
    back, meta = checkpoint.load(path, like={k: torch.empty_like(v) for k, v in qparams.items()})
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = all(back[k].is_cuda and torch.equal(back[k], v) for k, v in qparams.items())
    log(f"checkpoint quclassi-7q-3l (trained in phase 4): {len(qparams)} leaves saved in "
        f"{t1 - t0:.4f} s, loaded onto the card in {t2 - t1:.4f} s; equal bit for bit: {same}")
    if not (same and meta == {"config": "quclassi-7q-3l"}):
        raise AssertionError("the QuClassi checkpoint did not restore bit for bit")
    cfg = cfg_base.get("granite-moe-3b-a800m").with_(n_layers=1, dtype="float32")
    model = transformer.Model(cfg, device=dev, seed=1)
    batch = multimodal.text_batch(cfg, 2, 256, seed=0)
    with torch.no_grad():
        want = model.prefill(batch)[0]
    path = str(ckdir / "granite-moe.npz")
    t0 = time.perf_counter()
    checkpoint.save(path, transformer.params_to_numpy(cfg, model), {"arch": cfg.name})
    t1 = time.perf_counter()
    fresh = transformer.Model(cfg, device=dev, seed=2)
    t2 = time.perf_counter()
    tree, meta = checkpoint.load(path, like=transformer.params_to_numpy(cfg, fresh))
    fresh.load_state_dict(transformer.params_from_numpy(cfg, tree, dev))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    with torch.no_grad():
        got = fresh.prefill(batch)[0]
    size = Path(path).stat().st_size
    same = torch.equal(got, want)
    log(f"checkpoint {cfg.name} (1 layer, float32, {transformer.param_count(model):,} "
        f"parameters, {size / 2**30:.3f} GiB): saved in {t1 - t0:.3f} s, loaded into a fresh "
        f"model on the card in {t3 - t2:.3f} s; prefill logits equal bit for bit: {same}")
    if not (same and meta == {"arch": cfg.name}):
        raise AssertionError("the restored granite-moe model's logits differ")
    for f in ckdir.iterdir():
        f.unlink()
    ckdir.rmdir()
    del model, fresh, tree, want, got
    free()
    log(f"zoo: phase 8 took {time.perf_counter() - t_phase:.2f} s wall")
    return launched


def peak_gib(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2**30


def mixer_share(model, cfg, kind: str, b: int, s: int, busy_ms: float, dev, card: str) -> None:
    """One ``kind`` mixer alone at the prefill's shape, timed by CUDA events,
    and its share of the profiled prefill's busy time over the model's
    layers of that kind."""
    from repro_torch.models import blocks

    layers = [i for i, k in enumerate(cfg.layer_kinds) if k == kind]
    mixer = blocks._SSM[kind][1]
    params = model.blocks[layers[0]].mixer
    h = torch.randn((b, s, cfg.d_model), device=dev, dtype=model.dtype)
    with torch.no_grad():
        ms = time_ms(lambda: mixer(params, h, cfg), iters=2, warmup=1)
    n = len(layers)
    log(f"time {cfg.name} {kind} mixer (events): {ms:.3f} ms a layer at {b} x {s}; x {n} "
        f"layers against the profiled prefill's {busy_ms:.3f} ms busy: {n * ms / busy_ms:.4f} "
        f"[{card}]")


def serve_ssm_multimodal(dev, card: str) -> dict:
    """Phase 9: the SSM / xLSTM mixers and the multimodal frontends (Jamba
    one period, xLSTM-125M, Phi-3-vision, MusicGen-large) and their
    checkpoints.  Returns the flash launches of its main-path runs per
    route."""
    from repro_torch import checkpoint
    from repro_torch.configs import base as cfg_base
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import vqc_statevector as K
    from repro_torch.launch import serve, steps
    from repro_torch.models import blocks, moe, multimodal, ssm, transformer

    launched = {"flash_wgmma": 0, "flash_simt": 0}

    def count_from_zero():
        torch.cuda.synchronize()
        zero_flash_counts()
        zero_counts(K)

    def read_counts(label, want):
        torch.cuda.synchronize()
        if {k: FA.LAUNCHES[k] for k in want} != want:
            raise AssertionError(f"{label}: flash launches {dict(FA.LAUNCHES)}, want {want}")
        others = {k: n for k, n in K.LAUNCHES.items() if n}
        if others:
            raise AssertionError(f"{label}: launched circuit kernels {others}")
        for key in launched:
            launched[key] += FA.LAUNCHES[key]

    def consistency(cfg32, b, plen, label):
        """float32: the cached decode's logits at every prompt position
        against the prefill's (within SERVE_TOL), first token equal."""
        t0 = time.perf_counter()
        prefill32, model32 = steps.make_prefill_step(cfg32, device=dev)
        serve32 = steps.make_serve_step(cfg32, model=model32)[0]
        make = multimodal.audio_batch if cfg32.n_codebooks else multimodal.text_batch
        prompt = make(cfg32, b, plen, seed=0)
        n_attn = cfg32.layer_kinds.count("attn") if cfg32.attention_impl == "flash" else 0
        count_from_zero()
        full = prefill32(prompt).float()
        read_counts(f"{label} float32 prefill", {"flash_wgmma": 0, "flash_simt": n_attn})
        res = serve.generate(serve32, model32, prompt, 1, keep_logits=True)
        diff = float((res["prompt_logits"] - full).abs().max())
        first_ok = torch.equal(res["tokens"][:, 0].cpu(), full[:, -1].argmax(-1).cpu())
        log(f"{label} consistency (float32, TF32 off): cached decode through the states"
            f"{' and KV caches' if n_attn else ''} vs prefill logits over {b} x {plen} "
            f"positions: max|diff| = {diff:.3e} (limit {SERVE_TOL}), logit scale "
            f"{float(full.abs().max()):.3f}; first generated token equal: {first_ok}; peak "
            f"{peak_gib(dev):.2f} GiB; {time.perf_counter() - t0:.2f} s with the init [{card}]")
        if not (diff <= SERVE_TOL and first_ok):
            raise AssertionError(f"{label}: decode and prefill disagree: {diff}, first {first_ok}")
        del model32, prefill32, serve32, full, res
        free()

    def prefill_phase(cfg, batch, b, s, label, want, spy=None, runs=3, cpu=True,
                      profiled=None):
        """One counted prefill (routed through ``spy`` if given; it also
        pays the first-call costs), ``runs`` timed, one profiled (``cpu``:
        as ``profile_window``; of ``profiled``, a shorter batch, if given);
        returns the profiled prefill's busy ms."""
        prefill, model = steps.make_prefill_step(cfg, model=models[-1])
        count_from_zero()
        if spy is None:
            logits = prefill(batch)
        else:
            with spy:
                logits = prefill(batch)
        read_counts(f"{label} prefill", want)
        shape = (b, s) + ((cfg.n_codebooks,) if cfg.n_codebooks else ()) + (cfg.vocab,)
        if tuple(logits.shape) != shape or not torch.isfinite(logits.float()).all():
            raise AssertionError(f"{label}: prefill logits {tuple(logits.shape)} not finite")
        del logits
        ms, runs = timed_prefill(prefill, batch, runs)
        unit = "frames" if cfg.n_codebooks else "tokens"
        log(f"{label} prefill: {b} x {s} {unit} in {ms:.3f} ms mean of {len(runs)} "
            f"({', '.join(f'{r:.3f}' for r in runs)}), {b * s / ms * 1e3:,.1f} {unit}/s; "
            f"{want['flash_wgmma']} flash_wgmma launches; peak {peak_gib(dev):.2f} GiB [{card}]")
        window = batch if profiled is None else profiled
        wall_ms, kern, busy_ms = profile_window(lambda: prefill(window), cpu=cpu)
        shape = "" if profiled is None else f" of {' x '.join(map(str, window['tokens'].shape))}"
        log(f"profile {label} prefill{shape}: {wall_ms:.3f} ms host clock (profiled"
            f"{'' if cpu else ', CUDA activity only'}), device busy {busy_ms:.3f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.4f}, {sum(e.count for e in kern)} kernel launches [{card}]")
        log_top(kern, 6)
        return busy_ms

    t_phase = time.perf_counter()
    models, t_part = [], [t_phase]

    def lap(label):
        now = time.perf_counter()
        log(f"ssm/mm: {label} took {now - t_part[0]:.2f} s wall")
        t_part[0] = now

    def build(cfg, label, note=""):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model = transformer.Model(cfg, device=dev)
        torch.cuda.synchronize()
        models[:] = [model]
        log(f"ssm/mm {label}: {cfg.n_layers} layers ({'/'.join(sorted(set(cfg.layer_kinds)))}), "
            f"d {cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads, hd {cfg.resolved_head_dim}, "
            f"{cfg.dtype}{note}, {transformer.param_count(model):,} parameters, "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card (seeded init in "
            f"{time.perf_counter() - t0:.2f} s)")
        return model

    # (a) jamba-v0.1-52b at full width, one period of 8 layers: 7 Mamba + 1
    # attention (flash, hd 128, g 4), MoE 16 experts top-2 on layers 1, 3,
    # 5, 7, a dense SiLU-gated FFN on the others
    cfg = cfg_base.get("jamba-v0.1-52b").with_(n_layers=8, attention_impl="flash")
    b, s = 4, 2048
    model = build(cfg, cfg.name, f", one period of {cfg.n_layers} layers")
    batch = multimodal.text_batch(cfg, b, s, seed=0)
    spy = MoESpy()
    busy_ms = prefill_phase(cfg, batch, b, s, cfg.name, {"flash_wgmma": 1, "flash_simt": 0},
                            spy=spy)
    dropped, pairs = spy.dropped()
    cap = spy.calls[0]["capacity"]
    if len(spy.calls) != 4 or cap != moe.capacity(cfg, b * s):
        raise AssertionError(f"{cfg.name}: {len(spy.calls)} MoE calls, capacity {cap}")
    log(f"{cfg.name} routing: capacity {cap} a expert, dropped (token, k) pairs {dropped} of "
        f"{pairs} ({dropped / pairs:.4f}) over the 4 MoE layers")
    mixer_share(model, cfg, "mamba", b, s, busy_ms, dev, card)
    moe_share(model, cfg, b, s, busy_ms, dev, card)
    decode_requests(steps, serve, model, cfg, b, 64, 16, card, cfg.name)
    log(f"{cfg.name}: peak {peak_gib(dev):.2f} GiB")
    del model, batch
    models.clear()
    free()
    torch.cuda.reset_peak_memory_stats(dev)
    consistency(cfg.with_(dtype="float32", moe=dataclasses.replace(cfg.moe, dropless=True)),
                2, 64, f"{cfg.name} (one period, dropless)")
    lap("(a) jamba-v0.1-52b")

    # (b) xlstm-125m whole: 6 mLSTM + 6 sLSTM layers, no attention, no FFN
    cfg = cfg_base.get("xlstm-125m")
    model = build(cfg, cfg.name)
    batch = multimodal.text_batch(cfg, b, s, seed=0)
    # host-bound (the sLSTM loop, 27 launches a step): one timed run, the
    # profiles a quarter as long and without the CPU activity (reading a
    # window of 4 x 2048, 335,000 launches, took a minute)
    sq = s // 4
    busy_ms = prefill_phase(cfg, batch, b, s, cfg.name, {"flash_wgmma": 0, "flash_simt": 0},
                            runs=1, cpu=False, profiled=multimodal.text_batch(cfg, b, sq, seed=0))
    h = torch.randn((b, sq, cfg.d_model), device=dev, dtype=model.dtype)
    with torch.no_grad():
        wall_ms, kern, sl_busy = profile_window(
            lambda: ssm.slstm_mixer(model.blocks[1].mixer, h, cfg), cpu=False)
    n_sl, n_layers = sum(e.count for e in kern), cfg.layer_kinds.count("slstm")
    log(f"{cfg.name} sLSTM loop: {n_sl} kernel launches a layer at {b} x {sq} ({n_sl / sq:.1f} a "
        f"step), {n_layers * n_sl} over the {n_layers} sLSTM layers; one layer {wall_ms:.3f} ms "
        f"host clock (profiled), device busy {sl_busy:.3f} ms, x {n_layers} layers against the "
        f"{b} x {sq} prefill's {busy_ms:.3f} ms busy: {n_layers * sl_busy / busy_ms:.4f} [{card}]")
    mixer_share(model, cfg, "mlstm", b, sq, busy_ms, dev, card)
    decode_requests(steps, serve, model, cfg, b, 64, 16, card, cfg.name)
    del model, batch, h
    models.clear()
    free()
    consistency(cfg.with_(dtype="float32"), 2, 64, cfg.name)
    lap("(b) xlstm-125m")

    # (c) phi-3-vision-4.2b whole: 576 projected patch embeddings + 1472
    # text tokens, MHA at hd 96 through the flash kernel
    cfg = cfg_base.get("phi-3-vision-4.2b").with_(attention_impl="flash")
    model = build(cfg, cfg.name, f", {cfg.n_prefix_embeds} patch embeddings of "
                  f"{cfg.prefix_embed_dim}")
    batch = multimodal.vlm_batch(cfg, b, s, seed=0)
    prefill_phase(cfg, batch, b, s, cfg.name, {"flash_wgmma": cfg.n_layers, "flash_simt": 0})
    with torch.no_grad():
        h = rms_norm_of_embed(model, batch)
        att = {impl: blocks_attention(model, cfg, impl, h) for impl in ("flash", "naive")}
    naive_att = att["naive"].float()
    d_abs = (att["flash"].float() - naive_att).abs()
    d_att = float((d_abs / naive_att.abs().clamp(min=1.0)).max())
    log(f"{cfg.name} attention layer 0 on the {b} x {s} image + text prefix, flash (wgmma, hd "
        f"96) vs naive: max|diff| / max(1, |naive|) = {d_att:.3e} (limit "
        f"{FLASH_TOL[torch.bfloat16]}; max|diff| {float(d_abs.max()):.3e} at outputs up to "
        f"{float(naive_att.abs().max()):.3f}) [{card}]")
    if not d_att <= FLASH_TOL[torch.bfloat16]:
        raise AssertionError(f"phi-3-vision flash and naive attention differ by {d_att}")
    del h, att, naive_att, d_abs
    decode_requests(steps, serve, model, cfg, b, 64, 16, card, cfg.name)
    del model, batch
    models.clear()
    free()
    lap("(c) phi-3-vision-4.2b")

    # (d) musicgen-large whole: K = 4 codebooks of 2048, MHA at hd 64
    cfg = cfg_base.get("musicgen-large").with_(attention_impl="flash")
    model = build(cfg, cfg.name, f", {cfg.n_codebooks} codebooks of {cfg.vocab}")
    batch = multimodal.audio_batch(cfg, b, s, seed=0)
    prefill_phase(cfg, batch, b, s, cfg.name, {"flash_wgmma": cfg.n_layers, "flash_simt": 0})
    decode_requests(steps, serve, model, cfg, b, 64, 16, card, cfg.name)
    del model, batch
    models.clear()
    free()
    lap("(d) musicgen-large")

    # (e) checkpoints: xlstm-125m in float32, bit for bit; a bf16 reduced
    # Jamba keeps its float32 leaves float32 through params_to_numpy ->
    # params_from_numpy
    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    ckdir.mkdir(parents=True, exist_ok=True)
    cfg = cfg_base.get("xlstm-125m").with_(dtype="float32")
    model = transformer.Model(cfg, device=dev, seed=1)
    batch = multimodal.text_batch(cfg, 2, 256, seed=0)
    with torch.no_grad():
        want = model.prefill(batch)[0]
    path = str(ckdir / "xlstm.npz")
    t0 = time.perf_counter()
    checkpoint.save(path, transformer.params_to_numpy(cfg, model), {"arch": cfg.name})
    t1 = time.perf_counter()
    fresh = transformer.Model(cfg, device=dev, seed=2)
    tree, meta = checkpoint.load(path, like=transformer.params_to_numpy(cfg, fresh))
    fresh.load_state_dict(transformer.params_from_numpy(cfg, tree, dev))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with torch.no_grad():
        got = fresh.prefill(batch)[0]
    same_leaves = all(torch.equal(v, fresh.state_dict()[k]) for k, v in model.state_dict().items())
    same = torch.equal(got, want) and same_leaves
    log(f"checkpoint {cfg.name} (float32, {transformer.param_count(model):,} parameters): saved "
        f"in {t1 - t0:.3f} s, loaded into a fresh model on the card in {t2 - t1:.3f} s; every "
        f"leaf and the prefill logits equal bit for bit: {same}")
    if not (same and meta == {"arch": cfg.name}):
        raise AssertionError("the restored xlstm model differs")
    cfg = cfg_base.get("jamba-v0.1-52b").reduced().with_(dtype="bfloat16")
    model = transformer.Model(cfg, device=dev, seed=3)
    back = transformer.params_from_numpy(cfg, transformer.params_to_numpy(cfg, model), dev)
    f32 = {k: v.dtype for k, v in back.items() if v.dtype == torch.float32}
    want_f32 = {f"blocks.{i}.mixer.{leaf}" for i, kind in enumerate(cfg.layer_kinds)
                for leaf in ssm.FLOAT32_LEAVES.get(kind, ())}
    kept = (set(f32) == want_f32
            and all(torch.equal(back[k], v) for k, v in model.state_dict().items()))
    log(f"checkpoint {cfg.name} (reduced, bf16): {len(f32)} float32 leaves (dt_bias, a_log, "
        f"d_skip of {cfg.layer_kinds.count('mamba')} Mamba layers) kept float32 and every leaf "
        f"equal through params_to_numpy -> params_from_numpy: {kept}")
    if not kept:
        raise AssertionError("bf16 jamba lost its float32 leaves")
    for f in ckdir.iterdir():
        f.unlink()
    ckdir.rmdir()
    del model, fresh, tree, want, got, back
    free()
    log(f"ssm/mm: phase 9 took {time.perf_counter() - t_phase:.2f} s wall")
    return launched


def train_flops(cfg, model, tokens: int, s: int) -> float:
    """Matmul FLOPs of one train step with per-layer remat: the layers run
    forward twice (the step and the backward's recompute) and backward once
    (twice a forward's FLOPs), the head forward once and backward once.  A
    layer's forward is 2 FLOPs per weight a token plus the naive
    attention's two (S, S) products over every head (the causal half is
    computed too)."""
    layer_w = sum(p.numel() for blk in model.blocks for p in blk.parameters() if p.dim() == 2)
    attn = 2 * 2 * s * cfg.n_heads * cfg.resolved_head_dim * cfg.layer_kinds.count("attn")
    head = cfg.vocab * cfg.d_model
    return tokens * (4 * (2 * layer_w + attn) + 3 * 2 * head)


def train_lm(dev, card: str) -> None:
    """Phase 10: LM training (``Model.loss`` through ``make_train_step``).
    (a) SmolLM-360M at full width and depth, bf16, AdamW: a no-grad
    prefill's cross-entropy, one warm-up step (its loss against that
    cross-entropy), 3 timed steps on the same batch, one profiled; (b)
    every architecture's ``reduced()`` config, float32, one step on the
    card against the same step on the CPU; (c) a loss through the flash
    kernel raises.  No kernel of the port launches in this phase."""
    from repro_torch.configs import base as cfg_base
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import vqc_statevector as K
    from repro_torch.launch import steps
    from repro_torch.models import common, multimodal, transformer

    def count_from_zero():
        torch.cuda.synchronize()
        zero_flash_counts()
        zero_counts(K)

    def no_launches(label):
        torch.cuda.synchronize()
        launched = {k: n for k, n in [*FA.LAUNCHES.items(), *K.LAUNCHES.items()] if n}
        if launched:
            raise AssertionError(f"{label}: launched {launched}; training runs no kernel")

    t_phase = time.perf_counter()
    free()
    # (a) smollm-360m: 32 layers, its own attention_impl ("naive") and remat
    cfg = cfg_base.get("smollm-360m")
    gb, s = 64, 1024
    if cfg.attention_impl != "naive" or not cfg.remat or cfg.optimizer != "adamw":
        raise AssertionError(f"{cfg.name}: trains with {cfg.attention_impl}, remat "
                             f"{cfg.remat}, {cfg.optimizer}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    train_step, optimizer, model = steps.make_train_step(cfg, global_batch=gb, device=dev)
    opt_state = optimizer.init(dict(model.named_parameters()))
    torch.cuda.synchronize()
    n_micro = gb // cfg.microbatch
    log(f"train {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.kv_heads} heads, hd {cfg.resolved_head_dim}, {cfg.dtype}, attention "
        f"{cfg.attention_impl}, remat {cfg.remat}, {cfg.optimizer} lr {cfg.learning_rate}, "
        f"{transformer.param_count(model):,} parameters; with the optimizer state "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card (seeded init in "
        f"{time.perf_counter() - t0:.2f} s); global batch {gb} x {s} = {gb * s:,} tokens a "
        f"step in {n_micro} interleaved microbatches of {cfg.microbatch}")
    batch = {k: v.to(dev) for k, v in multimodal.text_batch(cfg, gb, s, seed=0).items()}
    with torch.no_grad():
        want = sum(float(common.cross_entropy(model.prefill(mb)[0][:, :-1], mb["tokens"][:, 1:]))
                   for mb in steps.micro_split(batch, n_micro)) / n_micro
    free()
    count_from_zero()
    stats = {}
    t0 = time.perf_counter()
    opt_state, loss = train_step(opt_state, batch, stats)
    losses, gnorm = [float(loss)], float(stats["grad_norm"])
    warm_s = time.perf_counter() - t0
    del stats
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt_state, loss = train_step(opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    no_launches(f"{cfg.name} train")
    peak = peak_gib(dev)
    rel = abs(losses[0] - want) / abs(want)
    step_ms = sum(times) / len(times) * 1e3
    flops = train_flops(cfg, model, gb * s, s)
    log(f"train {cfg.name}: step 0 (warm-up, {warm_s:.3f} s) loss {losses[0]:.6f} against "
        f"the no-grad prefill's cross-entropy {want:.6f}: rel diff {rel:.3e} (limit "
        f"{TRAIN_PREFILL_RTOL}); global grad norm {gnorm:.4f}; losses "
        f"{', '.join(f'{v:.6f}' for v in losses)}")
    log(f"train {cfg.name}: {gb} x {s} tokens a step in {step_ms:.3f} ms mean of 3 "
        f"({', '.join(f'{t * 1e3:.3f}' for t in times)}), "
        f"{gb * s * len(times) / sum(times):,.1f} tokens/s (host clock, synchronised at each "
        f"end); peak {peak:.2f} GiB; {flops:.4e} matmul FLOPs a step: bound "
        f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at the bf16 peak, "
        f"{flops / (step_ms / 1e3) / 1e12:.1f} TFLOP/s achieved [{card}]")
    if not rel <= TRAIN_PREFILL_RTOL:
        raise AssertionError(f"{cfg.name}: step 0's loss {losses[0]} is not the prefill's "
                             f"cross-entropy {want}")
    if not math.isfinite(gnorm):
        raise AssertionError(f"{cfg.name}: the global gradient norm {gnorm} is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: the loss did not fall: {losses}")
    wall_ms, kern, busy_ms = profile_window(lambda: train_step(opt_state, batch), cpu=False)
    log(f"profile {cfg.name} train step: {wall_ms:.3f} ms host clock (profiled, CUDA activity "
        f"only), device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
        f"{sum(e.count for e in kern)} kernel launches [{card}]")
    # cuBLAS names its Hopper GEMMs nvjet_*, its older ones *gemm* / *xmma*
    kinds = {"matmul": ("gemm", "xmma", "cutlass", "nvjet"), "softmax": ("softmax",),
             "copy and cast": ("copy",)}

    def kind_of(key):
        return next((k for k, names in kinds.items() if any(t in key.lower() for t in names)),
                    "other elementwise and reductions")

    shares = {}
    for e in kern:
        shares[kind_of(e.key)] = shares.get(kind_of(e.key), 0.0) + e.self_device_time_total / 1e3
    log(f"profile {cfg.name} train step by kind: " + ", ".join(
        f"{k} {v:.3f} ms ({v / busy_ms:.4f})" for k, v in sorted(shares.items())) + f" [{card}]")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {kind_of(e.key)}: {e.self_device_time_total / 1e3:.4f} ms x{e.count} "
            f"{e.key[:140]}")
    del train_step, optimizer, model, opt_state, batch, loss
    free()
    log(f"train: (a) took {time.perf_counter() - t_phase:.2f} s wall")

    # (b) every reduced architecture, float32 (TF32 off): one step of global
    # batch 4 (two interleaved microbatches) on the card against the CPU
    t0 = time.perf_counter()
    for name in TRAIN_ARCHS:
        cfg = cfg_base.get(name).reduced()
        cpu = transformer.Model(cfg, device="cpu", seed=3)
        on_card = transformer.Model(cfg, device=dev, seed=3)
        on_card.load_state_dict(cpu.state_dict())
        batch = multimodal.batch_for(cfg, 4, 16, seed=1)
        results = []
        for model in (cpu, on_card):
            if model is on_card:
                count_from_zero()
            train_step, optimizer, _ = steps.make_train_step(cfg, global_batch=4, model=model)
            stats = {}
            _, loss = train_step(optimizer.init(dict(model.named_parameters())), batch, stats)
            results.append((float(loss), stats["grads"]))
        no_launches(f"{name} reduced train")
        (want, grads), (got, _) = results
        adam = cfg.optimizer in ("adam", "adamw")
        card_params = dict(on_card.named_parameters())
        err = 0.0
        for n, p in cpu.named_parameters():
            g = grads[n].abs()
            mask = g > TRAIN_ADAM_MASK * g.max() if adam else torch.ones_like(g, dtype=torch.bool)
            diff = (card_params[n].detach().cpu() - p.detach()).abs()[mask]
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
        rel = abs(got - want) / abs(want)
        log(f"train {name} (reduced, float32): card loss {got:.7f}, CPU {want:.7f}, rel diff "
            f"{rel:.3e} (limit {TRAIN_RTOL}); parameters after the step max|diff| {err:.3e} "
            f"(limit {TRAIN_RTOL}{', AdamW leaves where |g| > 1e-3 max|g|' if adam else ''})")
        if not (rel <= TRAIN_RTOL and err <= TRAIN_RTOL):
            raise AssertionError(f"{name}: the card's train step differs from the CPU's")
        del cpu, on_card, results, grads, card_params
    free()
    log(f"train: (b) took {time.perf_counter() - t0:.2f} s wall")

    # (c) the flash kernel has no backward: a loss through it raises, launching nothing
    cfg = cfg_base.get("smollm-360m").reduced().with_(attention_impl="flash")
    model = transformer.Model(cfg, device=dev)
    count_from_zero()
    try:
        model.loss(multimodal.text_batch(cfg, 2, 16))
    except RuntimeError as exc:
        if "has no backward" not in str(exc):
            raise
        log(f"train flash: a loss with grad enabled raises: {exc}")
    else:
        raise AssertionError("a loss through the flash kernel did not raise")
    no_launches("flash loss")
    del model
    log(f"train: phase 10 took {time.perf_counter() - t_phase:.2f} s wall")


#: phase 11: the paper's bank dry-run at the reference's default size
BANK_CIRCUITS = 1 << 20
#: phase 11b: the slice of that bank placed by ``bank_shardings``
BANK_SLICE = 1 << 16
def dryrun_phase(dev, card: str) -> dict:
    """Phase 11: the dry-runs.  (a) The paper's bank dry-run,
    ``quclassi-7q-3l`` x 1,048,576 circuits: the records of the 1 x 1 host
    mesh and the 16 x 16 pod; the whole bank through ``fidelity_kernel``
    (the quantum dry-run's own execution: counts zeroed just before, read
    just after) and through the per-gate plain path on the card, within
    1e-5, both timed beside the two traffic bounds and the kernel's
    operations bound.  (b) A slice of the bank placed by
    ``bank_shardings`` on the card as a mesh of 1 and of 3 shards and run
    by ``sharded_executor``, bit-equal to ``worker_batched_executor``.  (c)
    The LM dry-run of ``smollm-360m`` x ``train_4k`` on the 16 x 16 mesh and
    at phase 10a's 64 x 1024 on a 1 x 1 mesh: its per-device argument bytes
    for the parameters and AdamW state equal to the bytes the card's
    allocator is asked for them (its ``requested_bytes``; what it holds,
    ``allocated_bytes``, adds its rounding and unsplit block tails), its
    FLOPs beside ``train_flops``.  Returns (a) and (b)'s launches."""
    from repro_torch.comanager import dataplane
    from repro_torch.configs import base as cfg_base
    from repro_torch.core import circuits, fidelity
    from repro_torch.kernels import ops
    from repro_torch.kernels import vqc_statevector as K
    from repro_torch.launch import dryrun, quantum_dryrun, steps
    from repro_torch.launch.mesh import DeviceMesh, make_mesh

    t_phase = time.perf_counter()
    out_dir = str(ROOT / "chiprun_out" / "dryrun")
    host = make_mesh((1, 1), ("data", "model"))
    spec = circuits.build_quclassi_circuit(7, 3)
    free()

    # (a) the bank: the 1 x 1 record runs it on the card, the pod's counts only
    torch.cuda.synchronize()
    zero_counts(K)
    rec = quantum_dryrun.run(7, 3, BANK_CIRCUITS, verbose=False, mesh=host, device=dev,
                             out_dir=out_dir)
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    res = rec.pop("_results")
    pod = quantum_dryrun.run(7, 3, BANK_CIRCUITS, verbose=False, out_dir=out_dir)
    if counts["fidelity"] < 1 or any(n for k, n in counts.items() if k != "fidelity"):
        raise AssertionError(f"bank dry-run: launches {counts}; it runs fidelity_kernel alone")
    err = rec["executed"]["max_abs_diff"]
    if not err <= quantum_dryrun.TOL:
        raise AssertionError(f"bank dry-run: fused vs per-gate max |diff| {err}")
    theta, data = res["theta"], res["data"]
    fused_ms = time_ms(lambda: ops.vqc_fidelity(spec, theta, data), iters=10)
    fused_dev = device_ms(lambda: ops.vqc_fidelity(spec, theta, data), "fidelity_kernel",
                          iters=10)
    pergate_ms = time_ms(lambda: fidelity.fidelity_batch(spec, theta, data), iters=3, warmup=1)
    kern_bytes = rec["fused_kernel"]["bytes_per_device"]
    state_bytes = rec["pergate"]["analytic_state_bytes_per_device"]
    flops = BANK_CIRCUITS * (ops_flops(spec.ops, spec.n_qubits) + 2 * 2**spec.n_qubits)
    op_ms, op_by = bound(flops, kern_bytes)
    shown = "not measured" if fused_dev is None else f"{fused_dev:.4f} ms"
    log(f"dryrun bank {rec['workload']}: {BANK_CIRCUITS:,} circuits ({spec.n_qubits} qubits, "
        f"{spec.n_theta} theta, {spec.n_data} data angles, {len(spec.ops)} gates) on 1 card: "
        f"fused {fused_ms:.4f} ms (events; device {shown}), per-gate plain {pergate_ms:.4f} ms; "
        f"traffic bounds: fused {kern_bytes:,} B = {kern_bytes / PEAK_BYTES_PER_S * 1e3:.4f} "
        f"ms, per-gate state {state_bytes:,} B = {state_bytes / PEAK_BYTES_PER_S * 1e3:.4f} "
        f"ms at {PEAK_BYTES_PER_S / 1e12} TB/s; the kernel's bound {op_ms:.4f} ms ({op_by}; "
        f"{flops:,} float32 operations); max |fused - per-gate| {err:.3e} (limit "
        f"{quantum_dryrun.TOL}); launches {counts} [{card}]")
    log(f"dryrun bank counts: per-gate path on meta {rec['pergate']['flops_per_device']:.4e} "
        f"FLOPs, {rec['pergate']['bytes_per_device']:.4e} B (1 x 1); the 16 x 16 pod "
        f"{pod['chips']} chips, {pod['pergate']['bytes_per_device']:.4e} B and "
        f"{pod['fused_kernel']['bytes_per_device']:,} B fused a chip")
    del res

    # (b) a slice placed by bank_shardings and run by sharded_executor
    th, dt = theta[:BANK_SLICE].contiguous(), data[:BANK_SLICE].contiguous()
    want = dataplane.worker_batched_executor(
        spec, dataplane.round_robin_assignment(BANK_SLICE, 4), 4)(th, dt)
    sharded = {}
    for n_shards in (1, 3):
        mesh = DeviceMesh((dev,) * n_shards)
        t_sh, d_sh = dataplane.bank_shardings(mesh)
        torch.cuda.synchronize()
        zero_counts(K)
        got = dataplane.sharded_executor(spec, mesh)(t_sh.place(th), d_sh.place(dt))
        torch.cuda.synchronize()
        sharded[n_shards] = K.LAUNCHES["fidelity"]
        if not torch.equal(got, want):
            raise AssertionError(f"bank_shardings over {n_shards} shards: max |diff| "
                                 f"{float((got - want).abs().max())}")
        counts["fidelity"] += K.LAUNCHES["fidelity"]
    log(f"dryrun bank_shardings: {BANK_SLICE:,} rows over 1 and 3 shards of the card bit-equal "
        f"to worker_batched_executor; fidelity launches {sharded}")
    del theta, data, th, dt
    free()

    # (c) the LM dry-run: the pod, and phase 10a's shape on one card
    cfg = cfg_base.get("smollm-360m")
    t0 = time.perf_counter()
    pod_rec = dryrun.run_one(cfg.name, "train_4k", False, verbose=False, out_dir=out_dir)
    shape = cfg_base.InputShape("train_64x1024", 1024, 64, "train")
    one = dryrun.run_one(cfg.name, shape, False, verbose=False, mesh=host, out_dir=out_dir)
    count_s = time.perf_counter() - t0
    args = one["arguments_per_device"]
    want_bytes = args["params"] + args["opt_state"] - 4   # the step is a host int here
    def held():
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats(dev)
        return stats["requested_bytes.all.current"], stats["allocated_bytes.all.current"]

    before = held()
    _, optimizer, model = steps.make_train_step(cfg, global_batch=64, device=dev)
    opt_state = optimizer.init(dict(model.named_parameters()))
    got_bytes, got_alloc = (a - b for a, b in zip(held(), before))
    n_tensors = sum(1 for _ in model.parameters()) * (1 + sum(
        isinstance(v, dict) for v in opt_state.values()))
    ref_flops = train_flops(cfg, model, 64 * 1024, 1024)
    log(f"dryrun {cfg.name}: train_4k on 16 x 16 {pod_rec['flops_per_device']:.4e} FLOPs, "
        f"{pod_rec['bytes_accessed_per_device']:.4e} B, "
        f"{pod_rec['memory']['argument_size_bytes']:,} argument bytes a chip; 64 x 1024 on "
        f"1 x 1: {one['flops_per_device']:.4e} FLOPs against train_flops {ref_flops:.4e} "
        f"(ratio {one['flops_per_device'] / ref_flops:.6f}), "
        f"{one['bytes_accessed_per_device']:.4e} B counted (eager, unfused); both counted in "
        f"{count_s:.2f} s")
    log(f"dryrun {cfg.name}: parameters + AdamW state {want_bytes:,} B by the specs, "
        f"{got_bytes:,} B requested from the card's allocator for {n_tensors} tensors (diff "
        f"{got_bytes - want_bytes:,} B), {got_alloc:,} B held by it (rounding and unsplit "
        f"block tails: {got_alloc - got_bytes:,} B) [{card}]")
    if got_bytes != want_bytes:
        raise AssertionError(f"{cfg.name}: the dry-run's {want_bytes} B of parameters and "
                             f"optimizer state against {got_bytes} B allocated")
    del model, optimizer, opt_state
    free()
    log(f"dryrun: phase 11 took {time.perf_counter() - t_phase:.2f} s wall")
    return counts


def moe_share(model, cfg, b: int, s: int, busy_ms: float, dev, card: str) -> None:
    """One MoE layer (``moe_ffn``) and its expert bank alone at the
    prefill's shape, timed by CUDA events (their kernels keep the card
    busy), and their share of the profiled prefill's busy time over the
    model's MoE layers."""
    from repro_torch.models import moe

    moe_layers = [i for i in range(cfg.n_layers) if model.use_moe[i % len(cfg.pattern)]]
    params = model.blocks[moe_layers[0]].ffn
    cap = moe.capacity(cfg, b * s)
    h = torch.randn((b, s, cfg.d_model), device=dev, dtype=model.dtype)
    xs = torch.randn((max(cfg.moe.n_experts, cfg.moe.pad_to), cap, cfg.d_model), device=dev,
                     dtype=model.dtype)
    with torch.no_grad():
        layer_ms = time_ms(lambda: moe.moe_ffn(params, h, cfg), iters=5, warmup=1)
        bank_ms = time_ms(lambda: moe._expert_ffn(params.experts, xs, cfg.activation), iters=5,
                          warmup=1)
    n = len(moe_layers)
    log(f"time {cfg.name} MoE layer (events): moe_ffn {layer_ms:.3f} ms, its expert bank "
        f"(E {xs.shape[0]} x capacity {cap}) {bank_ms:.3f} ms, routing + dispatch + combine"
        f"{' + shared expert' if cfg.moe.n_shared_experts else ''} {layer_ms - bank_ms:.3f} ms; "
        f"x {n} layers against the prefill's {busy_ms:.3f} ms busy: MoE "
        f"{n * layer_ms / busy_ms:.4f}, bank {n * bank_ms / busy_ms:.4f}, the rest "
        f"{n * (layer_ms - bank_ms) / busy_ms:.4f} [{card}]")


def rms_norm_of_embed(model, batch):
    from repro_torch.models.common import rms_norm

    return rms_norm(model.embed_inputs(batch), model.blocks[0].norm1, model.cfg.norm_eps)


def blocks_attention(model, cfg, impl: str, h):
    """Layer 0's attention on ``h`` through ``impl`` (its prefill route)."""
    from repro_torch.models import blocks

    return blocks._prefill_attention(cfg.with_(attention_impl=impl))(model.blocks[0].mixer, h,
                                                                     cfg)


def sdpa_attention(params, x, cfg):
    """GQA attention with ``scaled_dot_product_attention`` in place of the
    flash kernel (timed only)."""
    from repro_torch.models.attention import project_qkv

    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    pos = torch.arange(s, device=x.device)[None, :]
    q, k, v = project_qkv(params, x, cfg, pos)
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True)
    return o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd) @ params["wo"]


def zero_counts(K) -> None:
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0


def launch_reader(K, card: str):
    """-> (counts, read): ``read(label, wanted)`` logs the wrappers' counts
    since they were last zeroed, fails if a kernel of ``wanted`` was never
    launched, and adds them to ``counts``."""
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

    return counts, read


def train_tenants(dev, workers, cfg, batch, test_set, inits, seeds, kw, **rt_kw):
    """Each tenant of ``seeds`` trains ``cfg`` from its own host thread,
    free-running, through one async ``GatewayRuntime`` on ``workers`` (2
    admissions pending a tenant; ``rt_kw`` to the runtime); -> (runtime,
    reports, seconds).  Fails if a tenant or the runtime failed."""
    from repro_torch.core.trainer import train
    from repro_torch.serve import GatewayRuntime

    rt = GatewayRuntime(workers, deadline=0.05, mode="async", max_pending=2, **rt_kw)
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


def tenant_runs(dev):
    """Phases 6b and 12e: two tenants' ``quclassi-7q-3l`` runs, batch 64,
    implicit banks, 3 steps of one batch; -> (cfg, batch, test set, initial
    parameters, seeds, ``train`` keywords)."""
    from repro_torch.configs.quclassi_paper import get_quclassi
    from repro_torch.core import quclassi
    from repro_torch.data.mnist import make_pair_dataset, train_test_split

    cfg = get_quclassi("quclassi-7q-3l")
    x, y = make_pair_dataset(1, 5, n_per_class=128, seed=0)
    (xtr, ytr), test_set = train_test_split(x, y)
    one_batch = (xtr[:64], ytr[:64])  # 3 epochs of one batch: 3 steps, a loss each
    kw = dict(epochs=3, batch_size=64, lr=1e-3, bank_mode="implicit", device=dev)
    seeds = {"tenant-a": 0, "tenant-b": 1}
    inits = {cid: quclassi.init_params(cfg, torch.Generator().manual_seed(s), dev)
             for cid, s in seeds.items()}
    return cfg, one_batch, test_set, inits, seeds, kw


def fig6_workers(max_qubits=(5, 10, 15, 20)):
    """The paper's 4-worker multi-tenant fleet (5/10/15/20 qubits)."""
    from repro_torch.comanager.worker import WorkerConfig

    return [WorkerConfig(f"w{i + 1}", q) for i, q in enumerate(max_qubits)]


def fig6_clients(dev, rng) -> list:
    """The Fig-6 client mix (``benchmarks/gateway_throughput.py:42-50``):
    4 clients (5Q/1L, 5Q/2L, 7Q/1L, 7Q/2L), each with a materialized
    shift-rule bank of 64 samples drawn from ``rng``; -> [(cid, spec, theta
    rows, data rows)]."""
    from repro_torch.core import circuits, shift_rule

    clients = []
    for cid, qc, nl in (("5q1l", 5, 1), ("5q2l", 5, 2), ("7q1l", 7, 1), ("7q2l", 7, 2)):
        spec = circuits.build_quclassi_circuit(qc, nl)
        theta = torch.tensor(rng.uniform(0, np.pi, spec.n_theta), dtype=torch.float32, device=dev)
        data = torch.tensor(rng.uniform(0, np.pi, (64, spec.n_data)), dtype=torch.float32,
                            device=dev)
        bank = shift_rule.build_bank(theta, data)
        clients.append((cid, spec, bank.theta, bank.data))
    return clients


def serve_fig6(clients, mode: str, halfway=None, **rt_kw):
    """The clients' rows interleaved (row i of every client, then row i +
    1) into a ``GatewayRuntime`` (target 128, 2 slots a worker, ``rt_kw``
    beside), drained; ``halfway(rt)`` runs once, after half the rows were
    submitted; -> (per client fidelities, seconds, runtime).  Fails if the
    runtime recorded an error."""
    from repro_torch.serve import GatewayRuntime

    rt = GatewayRuntime(fig6_workers(), target=128, deadline=0.05, mode=mode,
                        slots_per_worker=2, **rt_kw)
    try:
        for cid, _, _, _ in clients:
            rt.gateway.register_client(cid, slo_ms=4000.0)
        rows = {cid: list(zip(t.unbind(0), d.unbind(0))) for cid, _, t, d in clients}
        futs = {cid: [] for cid in rows}
        n = max(len(r) for r in rows.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            if halfway is not None and i == n // 2:
                halfway(rt)
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


def tenant_latencies(summ: dict) -> dict:
    return {t["client"]: (t["p50_latency_s"], t["p99_latency_s"]) for t in summ["tenants"]}


def serve_gateway(dev, card: str) -> tuple[dict, dict]:
    """Phase 6: the multi-tenant serving port on the card, (a) the Fig-6
    mix through a sync and an async runtime, (b) two tenants training
    quclassi-7q-3l through one async runtime, (c) mesh spill.  Counts are
    zeroed just before each path and read just after; returns their sum
    and (a)'s fault-free sync fidelities, the baseline of phase 12."""
    from repro_torch.comanager import dataplane
    from repro_torch.core import circuits
    from repro_torch.core.trainer import train
    from repro_torch.kernels import ops
    from repro_torch.kernels import vqc_statevector as K
    from repro_torch.serve import GatewayRuntime

    counts, read = launch_reader(K, card)

    # (a) the Fig-6 client mix: each client's materialized shift-rule bank
    rng = np.random.default_rng(6)
    clients = fig6_clients(dev, rng)
    n_rows = sum(t.shape[0] for _, _, t, _ in clients)

    log("gateway (a): the Fig-6 mix, 4 clients x a materialized bank of 64 samples "
        f"({n_rows} rows), workers of 5/10/15/20 qubits")
    for mode in ("sync", "async"):
        serve_fig6(clients, mode)  # warm-up: device tables, streams, first launches
    zero_counts(K)
    out = {}
    for mode in ("sync", "async"):
        got, seconds, rt = serve_fig6(clients, mode)
        out[mode] = got
        summ = rt.telemetry.summary()
        log(f"  {mode}: {n_rows} circuits in {seconds:.4f} s = {n_rows / seconds:.1f} circuits/s, "
            f"{summ['batches']} batches, lane fill {summ['lane_fill']}, per-tenant "
            f"(p50 s, p99 s) {tenant_latencies(summ)} [{card}]")
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
    wall_ms, kern, busy_ms = profile_window(lambda: serve_fig6(clients, "async"))
    log(f"  async run profiled: {wall_ms:.3f} ms host clock, device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.4f}, {sum(e.count for e in kern)} kernel "
        f"launches [{card}]")
    zero_counts(K)  # the profiled run is not counted

    # (b) two tenants training quclassi-7q-3l on one async runtime
    cfg, one_batch, test_set, inits, seeds, kw = tenant_runs(dev)
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
    return counts, out["sync"]


#: phase 12: a crashed worker's fault starts at its attempt number
#: FAULT_AFTER (it runs its first FAULT_AFTER batches), a point in the run's
#: progress: an onset in wall time can fall after the worker's last batch
#: when the host schedules the faulted run faster than the fault-free one
#: (a sync run that crashed w2 at 0.3 of the fault-free time caught no batch
#: of w2 once).  (e)'s crash-recover window lasts RECOVER_S of the
#: fault-free training's time
FAULT_AFTER = 2
RECOVER_S = 0.3
#: phase 12c: the slowed worker's factor, and the hedge threshold, a
#: multiple of the service model's estimate of a batch.  On an NVIDIA H100
#: 80GB HBM3 (700 W) a healthy Fig-6 batch's time spread 1.95-24x from its
#: median to its maximum (the host's scheduling of 8 slot threads), more
#: than the slowdown's 3x, so no threshold singles out the slowed worker:
#: at 1.5 a run hedged 0-8 times, slowed or not, and at 0.5 some slowed
#: runs hedged once.  At a quarter of the estimate every batch still
#: running when a slot frees is hedged, healthy ones too
#: (``phase12_probe.py --hedge-trials``, PERF.md).  What shows the
#: straggler is who wins: the slowed worker loses its hedged batches, so it
#: gives fewer batches' results than in an unslowed control run.  The slowed
#: worker is w2, the one Algorithm 2 gives a 7-qubit batch first (w3 takes
#: one only while w2 holds one); like a crash, the slowdown starts at its
#: batch FAULT_AFTER + 1, once the service model has timed the families
#: (an unseen family's estimate is 1 s, which no batch outlasts)
SLOW_FACTOR = 3.0
HEDGE_K = 0.25
SLOWED = "w2"


def counting_injector(failures, after: int = 0):
    """A ``FaultInjector`` of ``failures`` that counts the attempts it
    refused (``refused``) and each worker's attempts (``seen``), and starts
    each worker's fault at that worker's attempt number ``after``: the
    spec's ``at`` and ``recover_at`` count from the time of that attempt
    (``onset``, per worker)."""
    from repro_torch.comanager.faults import normalize_failures
    from repro_torch.serve.fleet import FaultInjector, InjectedWorkerFault

    class CountingInjector(FaultInjector):
        def __init__(self):
            super().__init__({})
            self.pending = normalize_failures(failures)
            self.refused = 0
            self.seen = {}
            self.onset = {}

        def check(self, worker_id, now):
            with self._lock:
                n = self.seen.get(worker_id, 0)
                self.seen[worker_id] = n + 1
                spec = self.pending.pop(worker_id, None) if n >= after else None
                if spec is not None:
                    self._t0 = now if self._t0 is None else self._t0
                    t = now - self._t0
                    self.onset[worker_id] = t
                    self.schedule[worker_id] = dataclasses.replace(
                        spec, at=spec.at + t,
                        recover_at=None if spec.recover_at is None else spec.recover_at + t)
            try:
                super().check(worker_id, now)
            except InjectedWorkerFault:
                with self._lock:
                    self.refused += 1
                raise

    return CountingInjector()


def fault_phase(dev, card: str, baseline: dict) -> dict:
    """Phase 12: the serving fleet's fault tolerance on the card, on the
    Fig-6 mix and fleet of phase 6a (its fault-free sync fidelities are
    ``baseline``): (a) crash migration, (b) a flaky worker, (c) hedging,
    (d) live membership, (e) two tenants training through a crash-recover,
    (f) (a) and (c) traced.  Every future must equal the fault-free run's
    bit for bit, and every failure the fleet records must be one the
    injector raised.  Counts are zeroed just before each part and read just
    after; returns their sum."""
    from repro_torch.comanager.faults import FaultSpec, FaultToleranceConfig
    from repro_torch.comanager.worker import WorkerConfig
    from repro_torch.kernels import vqc_statevector as K
    from repro_torch.obs import ObservabilityConfig, validate_trace
    from repro_torch.obs.trace import CircuitTrace, WorkerSpan

    t_phase = time.perf_counter()
    counts, read = launch_reader(K, card)

    clients = fig6_clients(dev, np.random.default_rng(6))  # phase 6a's draws
    n_rows = sum(t.shape[0] for _, _, t, _ in clients)

    def check(label: str, got, seconds, rt, inj) -> dict:
        """The replay invariant and the failure accounting of one run; logs
        its rates and counters, returns the counters."""
        for cid, want in baseline.items():
            if not torch.equal(got[cid], want):
                raise AssertionError(f"{label}: {cid}'s futures differ from phase 6a's "
                                     "fault-free run")
        for cid, st in rt.telemetry.tenants.items():
            if st.completed != st.submitted:
                raise AssertionError(f"{label}: {cid} completed {st.completed} of "
                                     f"{st.submitted} circuits")
        summ = rt.telemetry.summary()
        fleet = rt.dispatcher.fleet.snapshot()
        c = {key: sum(v[key] for v in fleet.values())
             for key in ("failures", "retries", "migrations", "hedges", "offline_trips")}
        c["migrated_batches"] = summ.get("migrated_batches", 0)
        refused, onset, seen = (0, {}, {}) if inj is None else (inj.refused, inj.onset, inj.seen)
        if c["failures"] != refused:
            raise AssertionError(f"{label}: the fleet recorded {c['failures']} failures, the "
                                 f"injector refused {refused} attempts: an error that was not "
                                 "injected was retried or migrated")
        states = {w: v["state"] for w, v in fleet.items()}
        log(f"  {label}: {n_rows} circuits in {seconds:.4f} s = {n_rows / seconds:.1f} "
            f"circuits/s, bit-equal to the fault-free run; {c}, refused {refused} (fault onset "
            f"{onset} s, attempts by worker {seen}), "
            f"hedges by straggler "
            f"{ {w: v['hedges'] for w, v in fleet.items() if v['hedges']} }, states {states}, "
            f"per-tenant (p50 s, p99 s) {tenant_latencies(summ)} [{card}]")
        won = [w for w, _, _ in rt.dispatcher.batch_log]
        return dict(c, states=states, slowed_hedges=fleet[SLOWED]["hedges"],
                    slowed_won=won.count(SLOWED))

    def idle(label: str, run) -> None:
        wall_ms, kern, busy_ms = profile_window(run)
        log(f"  {label} profiled: {wall_ms:.3f} ms host clock, device busy {busy_ms:.3f} ms, "
            f"idle share {1 - busy_ms / wall_ms:.4f} [{card}]")

    # the fault-free runs the faulted ones are timed against
    free = {}
    for mode in ("sync", "async"):
        serve_fig6(clients, mode)  # warm
        got, free[mode], rt = serve_fig6(clients, mode)
        check(f"fault-free {mode}", got, free[mode], rt, None)
    zero_counts(K)  # counted per part below

    # (a) crash migration: no retry, one failure trips the breaker.  Sync
    # placement never reaches w3 (Algorithm 2 orders workers by (CRU, id),
    # and a sync batch is placed with nothing outstanding), so the sync run
    # crashes w2, the worker its 7-qubit batches take.
    log(f"faults (a): crash migration, the crash at the crashed worker's batch {FAULT_AFTER + 1}")
    crash_ft = FaultToleranceConfig(retry_limit=0, breaker_threshold=1)
    crashed = {"sync": "w2", "async": "w3"}

    def crash_run(mode, **kw):
        inj = counting_injector({crashed[mode]: FaultSpec(kind="crash")}, after=FAULT_AFTER)
        return (*serve_fig6(clients, mode, fault_tolerance=crash_ft, fault_injector=inj, **kw),
                inj)

    for mode in ("sync", "async"):
        c = check(f"(a) {mode}, {crashed[mode]} crashed", *crash_run(mode))
        if c["states"][crashed[mode]] != "offline" or c["migrated_batches"] < 1:
            raise AssertionError(f"(a) {mode}: {crashed[mode]} is {c['states'][crashed[mode]]}"
                                 f" with {c['migrated_batches']} migrated batches")
    read("faults (a) launches, sync + async", ("fidelity",))
    idle("(a) async", lambda: crash_run("async"))
    zero_counts(K)

    # (b) a flaky worker: p = 0.3, two in-place retries.  The hash of seed 0
    # drops w2's attempts 0, 1, 3, 4, 5 and 6: a retried batch first, then
    # three drops in a row, which trip the breaker (threshold 3) and migrate
    log("faults (b): w2 flaky, p = 0.3, retry_limit 2")
    flaky = FaultSpec(kind="flaky", p=0.3)

    def flaky_run(mode):
        inj = counting_injector({"w2": flaky})
        return (*serve_fig6(clients, mode, fault_injector=inj,
                            fault_tolerance=FaultToleranceConfig(retry_limit=2)), inj)

    for mode in ("sync", "async"):
        c = check(f"(b) {mode}", *flaky_run(mode))
        if c["retries"] < 1:
            raise AssertionError(f"(b) {mode}: no retry")
    read("faults (b) launches, sync + async", ("fidelity",))
    idle("(b) async", lambda: flaky_run("async"))
    zero_counts(K)

    # (c) hedging: SLOWED slowed SLOW_FACTOR times; the healthy batches' spread
    # (a traced fault-free run) against HEDGE_K first
    _, _, rt = serve_fig6(clients, "async", observability=ObservabilityConfig())
    spans = sorted(s.end - s.start for s in rt.telemetry.trace.buffer.records(WorkerSpan))
    med = spans[len(spans) // 2]
    log(f"faults (c): healthy async batches (fault-free, traced): {len(spans)}, p50 "
        f"{med * 1e3:.3f} ms, max {spans[-1] * 1e3:.3f} ms (x{spans[-1] / med:.2f} the p50); "
        f"{SLOWED} slowed x{SLOW_FACTOR}, hedge_k {HEDGE_K} [{card}]")
    hedge_ft = FaultToleranceConfig(hedge_k=HEDGE_K)
    control = check(f"(c) control, hedge_k {HEDGE_K} and no slowdown",
                    *serve_fig6(clients, "async", fault_tolerance=hedge_ft), None)
    zero_counts(K)

    def hedge_run(**kw):
        inj = counting_injector({SLOWED: FaultSpec(kind="slowdown", factor=SLOW_FACTOR)},
                                after=FAULT_AFTER)
        return (*serve_fig6(clients, "async", fault_tolerance=hedge_ft, fault_injector=inj,
                            **kw), inj)

    c = check(f"(c) async, {SLOWED} slowed", *hedge_run())
    log(f"  (c): batches whose result {SLOWED} gave, slowed {c['slowed_won']}, control "
        f"{control['slowed_won']}")
    if c["hedges"] < 1 or c["slowed_won"] >= control["slowed_won"]:
        raise AssertionError(f"(c): {c['hedges']} hedges, and the slowed {SLOWED} gave "
                             f"{c['slowed_won']} batches' results, {control['slowed_won']} "
                             "unslowed")
    slowed_hedges = c["slowed_hedges"]  # gated over (c) and (f)'s (c)
    read("faults (c) launches", ("fidelity",))
    idle("(c) async", hedge_run)
    zero_counts(K)

    # (d) live membership: drain w4 and register a fresh 20-qubit w5 once
    # half the rows are in; later batches run on the survivors
    log("faults (d): w4 drained and w5 (20 qubits) registered halfway")

    def membership(mode, mark, rt):
        if mode == "sync":
            rt.dispatcher.drain()  # sync runs batches in drain(): run the first half
        rt.dispatcher.drain_worker("w4")
        rt.dispatcher.register_worker(WorkerConfig("w5", 20))
        mark["n"] = len(rt.dispatcher.batch_log)

    for mode in ("sync", "async"):
        mark = {}
        got, seconds, rt = serve_fig6(clients, mode,
                                      halfway=lambda rt: membership(mode, mark, rt))
        check(f"(d) {mode}", got, seconds, rt, None)
        later = [w for w, _, _ in rt.dispatcher.batch_log[mark["n"]:]]
        log(f"  (d) {mode}: batches after the drain by worker "
            f"{ {w: later.count(w) for w in sorted(set(later))} }, fleet "
            f"{rt.dispatcher.fleet.workers()}")
        if "w4" in later or "w4" in rt.dispatcher.fleet.workers() or not later:
            raise AssertionError(f"(d) {mode}: a batch ran on the drained w4, or none after it")
        if mode == "async" and rt.dispatcher._pool._max_workers != 5 * 2 + 1:
            raise AssertionError("(d): register_worker did not grow the slot pool")
    read("faults (d) launches, sync + async", ("fidelity",))
    idle("(d) async", lambda: serve_fig6(clients, "async",
                                         halfway=lambda rt: membership("async", {}, rt)))
    zero_counts(K)

    # (e) two tenants training quclassi-7q-3l while w2 crashes and recovers:
    # Algorithm 2 places a 7-qubit batch on w2 unless w2 is loaded (the
    # lowest id among equally loaded workers that fit), so w2 is the worker
    # sure to take more than FAULT_AFTER batches
    cfg, one_batch, test_set, inits, seeds, kw = tenant_runs(dev)
    train_tenants(dev, fig6_workers(), cfg, one_batch, test_set, inits, seeds, kw)  # warm
    free_rt, free_reps, free_s = train_tenants(dev, fig6_workers(), cfg, one_batch, test_set,
                                               inits, seeds, kw)
    log(f"faults (e): 2 tenants x 3 steps of quclassi-7q-3l, fault-free {free_s:.4f} s = "
        f"{6 / free_s:.3f} steps/s, {len(free_rt.dispatcher.batch_log)} batches "
        f"({free_rt.telemetry.multibank_launches} multi-bank); w2 down from its batch "
        f"{FAULT_AFTER + 1} for {RECOVER_S} of that time [{card}]")
    zero_counts(K)

    def crash_train():
        inj = counting_injector({"w2": FaultSpec(kind="crash_recover",
                                                 recover_at=RECOVER_S * free_s)},
                                after=FAULT_AFTER)
        ft = FaultToleranceConfig(retry_limit=0, breaker_threshold=1, breaker_cooldown_s=0.05)
        return (*train_tenants(dev, fig6_workers(), cfg, one_batch, test_set, inits, seeds,
                               kw, fault_tolerance=ft, fault_injector=inj), inj)

    rt, reps, seconds, inj = crash_train()
    read("faults (e) launches", ("shiftbank",))
    fleet = rt.dispatcher.fleet.snapshot()
    failures = sum(v["failures"] for v in fleet.values())
    migrations = sum(v["migrations"] for v in fleet.values())
    log(f"  (e): {seconds:.4f} s = {6 / seconds:.3f} steps/s, {len(rt.dispatcher.batch_log)} "
        f"batches ({rt.telemetry.multibank_launches} multi-bank), failures {failures}, refused "
        f"{inj.refused} (fault onset {inj.onset} s, attempts by worker {inj.seen}), "
        f"migrations {migrations}, w2 "
        f"{fleet['w2']['state']} [{card}]")
    if failures != inj.refused or inj.refused < 1:
        raise AssertionError(f"(e): {failures} failures against {inj.refused} refused attempts")
    for cid, rep in reps.items():
        same = [a.loss == b.loss for a, b in zip(rep.epochs, free_reps[cid].epochs)]
        params = all(torch.equal(rep.params[k], free_reps[cid].params[k]) for k in rep.params)
        log(f"  (e) {cid}: losses {[e.loss for e in rep.epochs]}, equal to the fault-free "
            f"run's: losses {same}, parameters {params}")
        if not (all(same) and params):
            raise AssertionError(f"(e) {cid}: the run under the crash differs from the "
                                 "fault-free run")
    idle("(e)", crash_train)
    zero_counts(K)

    # (f) (a) and (c) again with the trace on
    log("faults (f): (a) async and (c) traced")
    stages = set()
    for label, run in (("(a)", lambda: crash_run("async", observability=ObservabilityConfig())),
                       ("(c)", lambda: hedge_run(observability=ObservabilityConfig()))):
        got, seconds, rt, inj = run()
        c = check(f"(f) {label} traced", got, seconds, rt, inj)
        if label == "(c)":
            slowed_hedges += c["slowed_hedges"]
        records = rt.telemetry.trace.buffer.records(CircuitTrace)
        bad = validate_trace(records)
        seen = {s for r in records for s, _ in r.stages}
        log(f"  (f) {label}: {len(records)} trace records, {len(bad)} violations, recovery "
            f"stages {sorted(seen & {'retried', 'hedged', 'worker_offline', 'migrated', 'requeue'})}")
        if bad or len(records) != n_rows:
            raise AssertionError(f"(f) {label}: {len(records)} records, violations {bad[:5]}")
        stages |= seen
    if not {"migrated", "hedged"} <= stages:
        raise AssertionError(f"(f): the traces hold no migrated or hedged stage: {stages}")
    if slowed_hedges < 1:
        raise AssertionError(f"(c), (f): the slowed {SLOWED}'s batches were never hedged")
    read("faults (f) launches", ("fidelity",))
    log(f"faults: phase 12 took {time.perf_counter() - t_phase:.2f} s wall")
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

    counts, read = launch_reader(K, card)

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


#: phase 13: the example programs (``repro_torch.examples``), in the order
#: they run, each with the kernels it must launch on the card (federated_dql
#: trains by exact autodiff through the dense simulator, transformer_train
#: through naive attention, and the rest run on the virtual clock)
EXAMPLES = {"multitenant_serving": (), "scale_storm": (), "trace_demo": (),
            "quickstart": ("fidelity",), "failure_injection": ("fidelity",),
            "gateway_serving": ("fidelity",), "cluster_api": ("fidelity", "shiftbank"),
            "distributed_training": ("fidelity",), "federated_dql": (),
            "transformer_train": ()}
#: phase 13: distributed_training's first-epoch loss, card against CPU
EXAMPLE_LOSS_TOL = 1e-4


def examples_phase(dev, card: str) -> dict:
    """Phase 13: the ten example programs, each run in this process through
    ``main([..., "--device", "cuda"])`` at the reference's default arguments
    (its standard output kept in ``chiprun_out/examples/``, its working
    directory there too), counts zeroed just before and read just after;
    the gates compare with the same program on the CPU.  Returns the
    counts' sum."""
    import contextlib
    import importlib
    import io

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import vqc_statevector as K
    from repro_torch.serve.fleet import FaultInjector, InjectedWorkerFault

    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out" / "examples"
    counts, read = launch_reader(K, card)

    def run(name: str, where: str, *argv: str):
        """-> (result, standard output) of one program's ``main`` on the card
        (``where="card"``: ``dev``) or on the CPU."""
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        work = out_dir / where
        work.mkdir(parents=True, exist_ok=True)
        zero_counts(K)
        zero_flash_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.chdir(work), contextlib.redirect_stdout(buf):
            out = mod.main([*argv, "--device", dev.type if where == "card" else "cpu"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        text = buf.getvalue()
        (work / f"{name}.txt").write_text(text)
        if where == "card":
            if FA.LAUNCHES["flash"]:
                raise AssertionError(f"examples {name}: {FA.LAUNCHES['flash']} flash launches")
            read(f"{' '.join(('examples', name, *argv))} ({seconds:.2f} s wall)", EXAMPLES[name])
        else:
            log(f"  {' '.join(('examples', name, *argv))} on the CPU: {seconds:.2f} s wall")
        return out, text

    def same_lines(name: str, got: str, want: str) -> None:
        if got.splitlines() != want.splitlines():
            raise AssertionError(f"examples {name}: the card's output differs from the CPU's "
                                 f"(chiprun_out/examples/{{card,cpu}}/{name}.txt)")

    # (a) the virtual clock: the same lines as on the CPU
    for name in ("multitenant_serving", "scale_storm", "trace_demo"):
        same_lines(name, run(name, "card")[1], run(name, "cpu")[1])
    json_cuda, json_cpu = (out_dir / d / "trace_demo.json" for d in ("card", "cpu"))
    if json_cuda.read_bytes() != json_cpu.read_bytes():
        raise AssertionError("examples trace_demo: trace_demo.json differs from the CPU's")
    log(f"examples (a): virtual-clock output equal to the CPU's [{card}]")

    # (b) quickstart: the same theta (a seeded generator) on both devices
    q, _ = run("quickstart", "card")
    q_cpu, _ = run("quickstart", "cpu")
    err = float((q["fidelities"].cpu() - q_cpu["fidelities"]).abs().max())
    log(f"examples (b) quickstart: fidelities vs the CPU's max|diff| = {err:.3e}, "
        f"shift-vs-autodiff gap {q['grad_gap']:.3e}, loss {q['loss_shift']:.6f} "
        f"(CPU {q_cpu['loss_shift']:.6f}) [{card}]")
    if err > TOL or q["grad_gap"] > 1e-4:
        raise AssertionError(f"examples quickstart: fidelities {err:.3e}, gap {q['grad_gap']:.3e}")

    # (c) failure_injection: the scenes' own bit-identity asserts; every
    # failure the fleet records is one the injector raised
    injectors = []

    class CountingInjector(FaultInjector):
        def __init__(self, failures):
            super().__init__(failures)
            self.refused = 0
            injectors.append(self)

        def check(self, worker_id, now):
            try:
                super().check(worker_id, now)
            except InjectedWorkerFault:
                with self._lock:
                    self.refused += 1
                raise

    fi = importlib.import_module("repro_torch.examples.failure_injection")
    fi.FaultInjector = CountingInjector
    try:
        f, _ = run("failure_injection", "card")
    finally:
        fi.FaultInjector = FaultInjector
    for scene, inj in zip(("crash", "flaky"), injectors):
        failures = sum(v["failures"] for v in f[scene]["fleet"].values())
        if failures != inj.refused:
            raise AssertionError(f"examples failure_injection {scene}: the fleet recorded "
                                 f"{failures} failures, the injector refused {inj.refused}")
    log(f"examples (c) failure_injection: crash {f['crash']['fleet']}, flaky "
        f"{f['flaky']['fleet']}, refused {[inj.refused for inj in injectors]}, fleet after "
        f"membership {f['membership']['fleet']}; bit-identical migration held [{card}]")

    # (d) gateway_serving: gateway gradients against local ones
    g, _ = run("gateway_serving", "card")
    tr = g["training"]
    errs = {k: float((tr["grads_gateway"][k] - tr["grads_local"][k]).abs().max())
            for k in tr["grads_local"]}
    log(f"examples (d) gateway_serving: batches {[n for _, n, _ in g['streaming']['batch_log']]}, "
        f"gateway vs local gradients max|diff| {errs}, {tr['launches']} training launches "
        f"[{card}]")
    if max(errs.values()) > TOL:
        raise AssertionError(f"examples gateway_serving: gradients {errs}")

    # (e) cluster_api: five backend families against batched; the session
    # gradient equal to the legacy one (the program asserts it)
    c, _ = run("cluster_api", "card")
    diffs = {kind: b["diff_vs_batched"] for kind, b in c["backends"].items()}
    log(f"examples (e) cluster_api: backends vs batched {diffs}, session vs legacy gradient "
        f"{c['training']['diff']}, implicit {c['training']['implicit_err']:.3e} [{card}]")
    if len(diffs) != 5 or max(diffs.values()) > TOL or c["training"]["diff"] != 0.0:
        raise AssertionError(f"examples cluster_api: {diffs}, {c['training']['diff']}")

    # (f) distributed_training: 12 epochs on the card; its first epoch
    # against one epoch on the CPU (the same seeds give the same batches)
    d, _ = run("distributed_training", "card")
    d_cpu, _ = run("distributed_training", "cpu", "--epochs", "1")
    first, first_cpu = d["report"].epochs[0], d_cpu["report"].epochs[0]
    log(f"examples (f) distributed_training: spread {d['spread']}, first-epoch loss "
        f"{first.loss:.6f} (CPU {first_cpu.loss:.6f}), final test accuracy "
        f"{d['report'].final_test_accuracy:.4f} after {len(d['report'].epochs)} epochs, "
        f"{d['circuits']} circuits in {d['seconds']:.2f} s [{card}]")
    if d["spread"] != d_cpu["spread"] or abs(first.loss - first_cpu.loss) > EXAMPLE_LOSS_TOL:
        raise AssertionError(f"examples distributed_training: spread {d['spread']} vs "
                             f"{d_cpu['spread']}, loss {first.loss} vs {first_cpu.loss}")

    # (g) federated_dql: scene 1's accuracies as on the CPU; scenes 2-3 equal
    fd, text = run("federated_dql", "card")
    fd_cpu, text_cpu = run("federated_dql", "cpu")
    acc, acc_cpu = fd["happy"].accuracy_by_round, fd_cpu["happy"].accuracy_by_round
    log(f"examples (g) federated_dql: accuracy by round {acc} (CPU {acc_cpu}), update norms "
        f"{[r.update_norm for r in fd['happy'].rounds]} [{card}]")
    scene2 = "\n-- scene 2"
    if acc != acc_cpu or text.split(scene2)[1] != text_cpu.split(scene2)[1]:
        raise AssertionError("examples federated_dql: the card's rounds differ from the CPU's")

    # (h) transformer_train: 200 steps (the program asserts the loss falls)
    t, _ = run("transformer_train", "card", "--ckpt", str(out_dir / "transformer.npz"))
    log(f"examples (h) transformer_train: {t['params'] / 1e6:.1f}M params, loss "
        f"{t['losses'][0]:.4f} -> {t['losses'][-1]:.4f} over {len(t['losses'])} steps, "
        f"{t['tokens_per_s']:.1f} tokens/s, checkpoint bit-equal {t['checkpoint_ok']} [{card}]")
    if not t["checkpoint_ok"]:
        raise AssertionError("examples transformer_train: the checkpoint round trip differs")
    log(f"examples: phase 13 took {time.perf_counter() - t_phase:.2f} s wall")
    return counts


#: phase 14: a training step's shift samples (2 classes x 9 patches x batch
#: 64) and the widths of the shift walk's device-memory route
WIDE_B = 1152
#: phase 14's other sizes: samples of the checks in (a), of the forced
#: plans in (b), images of the step in (c), samples of the served bank (d)
WIDE_CHECK_B, WIDE_FORCED_B, WIDE_BATCH, WIDE_SERVE_B = 100, 576, 64, 64
WIDE_SHAPES = (("27q-1l", 27, 1), ("27q-3l", 27, 3), ("29q-1l", 29, 1), ("33q-1l", 33, 1))
#: a budget that holds no block of the shared-memory shift routes: it
#: forces an m <= 12 plan onto the device-memory walk
FORCE_DMEM_BUDGET = 64
#: phase 14's rows are also held to their own size, row by row:
#: |got - want| <= ROW_RTOL |want| + ROW_ATOL.  At m = 13-16 a row is a
#: product of 13-16 factors in [0, 1], most of them far below TOL, which
#: alone passes a kernel that is wrong on every row.
ROW_RTOL, ROW_ATOL = 1e-4, 1e-10
#: the 27q step's gradients within GRAD_RTOL of the largest CPU gradient:
#: R2's chain-scaled tolerance lies far above the gradients themselves
GRAD_RTOL = 1e-4
#: phase 14(b)'s timing of the walk against the route an m <= 12 plan takes
#: at 227 KB: QuClassi widths (m = 7-12), layers and batch sizes
ROUTE_SWEEP_QC, ROUTE_SWEEP_LAYERS, ROUTE_SWEEP_B = (15, 17, 19, 21, 23, 25), (1, 3), (64, 576)


def hold_rows(label: str, got, want, tol: float = TOL) -> float:
    """Hold shift rows ``got`` against ``want``: within ``tol``, and row by
    row within ROW_RTOL of the row's size (ROW_ATOL where it is ~0).  Logs
    max|diff|, max|want| and the worst row's share of its relative limit;
    raises where either limit fails (NaN fails both).  Returns max|diff|."""
    if got.is_cuda:
        torch.cuda.synchronize()
    diff, size = (got - want).abs(), want.abs()
    err, share = float(diff.max()), float((diff / (ROW_ATOL + ROW_RTOL * size)).max())
    log(f"  shift_dmem    {label:52s} max|diff| = {err:.3e} (limit {tol}), max|want| = "
        f"{float(size.max()):.3e}, worst row at {share:.4f} of {ROW_RTOL} |want| + {ROW_ATOL}")
    if not (err <= tol and share <= 1.0):
        raise AssertionError(f"shift_dmem {label}: max|diff| {err} > {tol}, or a row off by "
                             f"{share} x ({ROW_RTOL} |want| + {ROW_ATOL})")
    return err


def quclassi27():
    """The wide slice: 27-qubit, 3-layer QuClassi (m = 13, P = 74) on 2
    workers, the paper's segmentation on 8x8 images (9 patches), the
    patches encoded without the dense layer, so that the phase holds the
    shift walk alone (the reference takes the dense layer's gradient by
    autodiff through its dense simulator, 2**27 amplitudes a sample; the
    port's wide route is held by ``tests/test_torch_dense_wide.py`` and the
    card tests).  Returns the config, the round-robin assignment and each
    worker's groups."""
    from repro_torch.comanager import dataplane
    from repro_torch.core import quclassi, segmentation

    cfg = quclassi.QuClassiConfig(
        qc=27, n_layers=3,
        seg=segmentation.SegmentationConfig(filter_width=4, stride=2, n_filters=4),
        image_size=(8, 8), use_dense=False)
    n_groups = 1 + 2 * cfg.n_theta
    assign = dataplane.round_robin_assignment(n_groups, 2)
    return cfg, assign, [tuple(g for g in range(n_groups) if assign[g] == w) for w in range(2)]


def first_shift_traffic(K, walk) -> int:
    """Bytes of state one sample of ``walk`` moved through device memory
    under the route's first kernel, which kept every state of the walk
    there: per chunk of each pass its load (none from |0...0>, none where
    the previous one-chunk pass left the source staged), its store and
    chi's read for an inner product.  Phase 14(a) logs it beside the
    redesigned kernel's count; ``tools/redesign_ab.py`` beside both
    kernels' times."""
    n_chunks, total, resident = 2 ** (walk.m - walk.k), 0, -1
    for src, dst, row, *_ in walk.passes.tolist():
        total += (src >= 0 and src != resident) + (dst >= 0) + (row != -1)
        resident = dst if n_chunks == 1 and dst >= 0 else -1
    return total * n_chunks * K._state_bytes(walk.k, 1)


def wide_shift_phase(dev, card: str) -> tuple[dict, float, dict]:
    """Phase 14: shift plans of m >= 13 on the shift walk's device-memory
    route (``shift_dmem_kernel``).  (a) the kernel against its plain version
    at 27q-1l, 27q-3l, 29q-1l and 33q-1l (B = 100, whole banks and each
    worker's groups of the 2-worker round robin) and 27q-3l at B = 1,152,
    then timed there; (b) m <= 12 plans (21q-3l, 25q-1l) forced onto it
    against the spill pair they take, and timed against the route each
    plan of m = 7-12 takes at 227 KB (ROUTE_SWEEP_*); (c) one Algorithm-1 step of 27q-3l
    QuClassi through the 2-worker implicit executor at batch 64: its first
    bank against the plain version on the card, its loss and gradients
    against the same step on the CPU; (d) a tenant's 27q-1l implicit bank
    through ``GatewayRuntime`` sync and async on workers wide enough for
    it.  Counts are zeroed just before (c) and (d) and read just after.
    Returns those counts, the kernel's max |diff| to its plain version and
    its record for the kernels line."""
    from repro_torch.api.capabilities import declare
    from repro_torch.comanager import dataplane
    from repro_torch.comanager.worker import WorkerConfig
    from repro_torch.core import circuits, fidelity, quclassi, shift_rule
    from repro_torch.data.mnist import make_pair_dataset
    from repro_torch.kernels import ops
    from repro_torch.kernels import vqc_statevector as K
    from repro_torch.serve import GatewayRuntime

    t_phase = time.perf_counter()
    counts, read = launch_reader(K, card)
    rng = np.random.default_rng(14)
    worst = [0.0]

    def angles(spec, b):
        th = rng.uniform(-np.pi, np.pi, (b, spec.n_theta))
        dt = rng.uniform(0.0, np.pi, (b, spec.n_data))
        return (torch.tensor(th, dtype=torch.float32, device=dev),
                torch.tensor(dt, dtype=torch.float32, device=dev))

    def check(label: str, got, want, tol: float = TOL, plain: bool = True) -> float:
        err = hold_rows(label, got, want, tol)
        if plain:
            worst[0] = max(worst[0], err)
        return err

    # (a) the kernel against its plain version
    log("wide (a): the shift walk's device-memory kernel against its plain version")
    for label, qc, nl in WIDE_SHAPES:
        spec = circuits.build_quclassi_circuit(qc, nl)
        n_groups = 1 + 2 * spec.n_theta
        assign = dataplane.round_robin_assignment(n_groups, 2)
        sets = [tuple(range(n_groups))] + [
            tuple(g for g in range(n_groups) if assign[g] == w) for w in range(2)]
        for b in (WIDE_CHECK_B, WIDE_B) if label == "27q-3l" else (WIDE_CHECK_B,):
            th, dt = angles(spec, b)
            for gs in sets:
                walk = K._shift_route(spec, False, gs, K.SMEM_BUDGET_BYTES)
                if walk.route != "dmem":
                    raise AssertionError(f"{label} G={len(gs)} takes {walk.route}, not dmem")
                before = K.LAUNCHES["shift_dmem"]
                got = K.vqc_shift_fidelity(spec, th, dt, groups=gs)
                launched = K.LAUNCHES["shift_dmem"] - before
                check(f"{label} B={b} G={len(gs)} m={walk.m}, {len(walk.passes)} passes, "
                      f"{launched} launch(es)", got, K._shift_dmem_plain(walk, th, dt))
            del th, dt

    spec = circuits.build_quclassi_circuit(27, 3)
    plan, gs = K.build_shift_plan(spec), tuple(range(1 + 2 * spec.n_theta))
    walk = K._shift_route(spec, False, gs, K.SMEM_BUDGET_BYTES)
    th, dt = angles(spec, WIDE_B)

    def kern():
        return K.vqc_shift_fidelity(spec, th, dt)

    ms = time_ms(kern, iters=5, warmup=1)
    dev_ms = device_ms(kern, "shift_dmem_kernel", iters=5)
    plain_ms = time_ms(lambda: K._shift_dmem_plain(walk, th, dt), iters=2, warmup=1)
    flops = WIDE_B * shift_flops(K, plan, gs, spec.n_theta)
    nbytes = WIDE_B * (4 * (spec.n_theta + spec.n_data) + 4 * len(gs))
    bound_ms, bound_by = bound(flops, nbytes)
    traffic = WIDE_B * K.shift_dmem_traffic_bytes(walk)
    first = WIDE_B * first_shift_traffic(K, walk)
    _, smem, sample, per = K.shift_dmem_geometry(walk, WIDE_B)
    record = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "passes": len(walk.passes), "pass_bytes": traffic,
              "pass_bound_ms": traffic / PEAK_BYTES_PER_S * 1e3,
              "first_pass_bytes": first, "first_pass_bound_ms": first / PEAK_BYTES_PER_S * 1e3,
              "shape": f"27q-3l B={WIDE_B}, G={len(gs)}"}
    shown = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    log(f"  time shift_dmem 27q-3l B={WIDE_B}, G={len(gs)} ({len(walk.passes)} passes, "
        f"{smem} B of shared memory a block, {sample} B of scratch a sample, {per} samples a "
        f"launch): kernel {ms:.4f} ms (events; device time {shown}), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}; {flops} flops, {nbytes} bytes); the route's "
        f"passes move {traffic} bytes: {record['pass_bound_ms']:.4f} ms at "
        f"{PEAK_BYTES_PER_S / 1e12} TB/s (the first kernel's passes moved {first} bytes, "
        f"{record['first_pass_bound_ms']:.4f} ms) [{card}]")
    del th, dt

    # (b) m <= 12 plans forced onto the route, against the spill pair
    log(f"wide (b): m <= 12 plans forced onto the route (budget {FORCE_DMEM_BUDGET} B) "
        f"against the route they take, B = {WIDE_FORCED_B}")
    for label, qc, nl in (("21q-3l", 21, 3), ("25q-1l", 25, 1)):
        spec = circuits.build_quclassi_circuit(qc, nl)
        gs = tuple(range(1 + 2 * spec.n_theta))
        taken = K._shift_route(spec, False, gs, K.SMEM_BUDGET_BYTES).route
        if K._shift_route(spec, False, gs, FORCE_DMEM_BUDGET).route != "dmem" or taken != "pair":
            raise AssertionError(f"{label}: not the spill pair at 227 KB, or not forced")
        th, dt = angles(spec, WIDE_FORCED_B)

        def pair(spec=spec, th=th, dt=dt):
            return K.vqc_shift_fidelity(spec, th, dt)

        def forced(spec=spec, th=th, dt=dt):
            return K.vqc_shift_fidelity(spec, th, dt, smem_budget=FORCE_DMEM_BUDGET)

        got, want = forced(), pair()
        check(f"{label} forced vs spill pair", got, want, tol=1e-6, plain=False)
        same = [r for r in range(got.shape[0]) if torch.equal(got[r], want[r])]
        turns = [time_ms(pair, 5, 1), time_ms(forced, 5, 1), time_ms(forced, 5, 1),
                 time_ms(pair, 5, 1)]
        log(f"  {label}: rows {same} of {got.shape[0]} bit-equal (the states are the same "
            f"bits; the inner products sum in another order); spill pair {turns[0]:.4f} / "
            f"{turns[3]:.4f} ms, device-memory walk {turns[1]:.4f} / {turns[2]:.4f} ms "
            f"[{card}]")
        del th, dt
    log(f"wide (b): the walk timed against the route each m <= 12 plan takes at 227 KB, "
        f"QuClassi {ROUTE_SWEEP_QC} qubits x {ROUTE_SWEEP_LAYERS} layers, B = {ROUTE_SWEEP_B}")
    for qc in ROUTE_SWEEP_QC:
        for nl in ROUTE_SWEEP_LAYERS:
            spec = circuits.build_quclassi_circuit(qc, nl)
            taken = K._shift_route(spec, False, tuple(range(1 + 2 * spec.n_theta)),
                                   K.SMEM_BUDGET_BYTES)
            for b in ROUTE_SWEEP_B:
                th, dt = angles(spec, b)

                def chosen(spec=spec, th=th, dt=dt):
                    return K.vqc_shift_fidelity(spec, th, dt)

                def walked(spec=spec, th=th, dt=dt):
                    return K.vqc_shift_fidelity(spec, th, dt, smem_budget=FORCE_DMEM_BUDGET)

                check(f"{qc}q-{nl}l B={b} forced vs {taken.route}", walked(), chosen(),
                      tol=1e-6, plain=False)
                turns = [time_ms(chosen, 5, 1), time_ms(walked, 5, 1), time_ms(walked, 5, 1),
                         time_ms(chosen, 5, 1)]
                log(f"  route sweep {qc}q-{nl}l m={taken.m} B={b}: {taken.route} "
                    f"{turns[0]:.4f} / {turns[3]:.4f} ms, walk {turns[1]:.4f} / "
                    f"{turns[2]:.4f} ms, walk / {taken.route} "
                    f"{(turns[1] + turns[2]) / (turns[0] + turns[3]):.3f} [{card}]")
                del th, dt

    # (c) one Algorithm-1 step of 27q-3l QuClassi on 2 workers, batch 64
    cfg, assign, worker_groups = quclassi27()
    n_groups = 1 + 2 * cfg.n_theta
    run = dataplane.worker_batched_executor(cfg.spec, assign, 2)
    x, y = make_pair_dataset(1, 5, n_per_class=WIDE_BATCH // 2, seed=0)
    params = quclassi.init_params(cfg, torch.Generator().manual_seed(0), dev)
    xb, yb = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    first = []

    def recording(*args):
        out = run(*args)
        if not first:
            first.append((args[0], out.detach().clone()))
        return out

    executor = declare(recording, shiftbank=True)

    def step():
        return quclassi.grad_shift(cfg, params, xb, yb, executor=executor, implicit=True)

    log(f"wide (c): one Algorithm-1 step of 27q-3l QuClassi without the dense layer "
        f"(use_dense=False: the shift walk alone), m = 13, P = {cfg.n_theta}, batch {WIDE_BATCH}, "
        f"{cfg.n_patches} patches, 2 workers, implicit banks")
    step()  # warm-up: device tables, the first launches
    first.clear()
    torch.cuda.synchronize()
    zero_counts(K)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    n_steps = 3
    for _ in range(n_steps):
        loss, grads, fids = step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    read(f"wide (c) {n_steps} steps", ("shift_dmem",))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"  {n_steps} steps in {wall:.4f} s = {n_steps / wall:.4f} steps/s without the dense "
        f"layer, loss {float(loss):.6f}, peak memory {peak:.2f} GiB [{card}]")
    wall_ms, kern, busy_ms = profile_window(step)
    log(f"  profile: one step {wall_ms:.3f} ms host clock (profiled), device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
        f"{sum(e.count for e in kern)} kernel launches [{card}]")
    log_top(kern, 4)
    zero_counts(K)  # the profiled step is not counted
    if not (math.isfinite(float(loss)) and torch.isfinite(grads["theta"]).all()):
        raise AssertionError(f"27q step: loss {float(loss)} or gradients not finite")
    bank, got = first[0]
    plain = torch.empty((n_groups, bank.n_samples), dtype=torch.float32, device=dev)
    for gs in worker_groups:
        walk = K._shift_route(cfg.spec, False, gs, K.SMEM_BUDGET_BYTES)
        plain[list(gs)] = torch.clamp(K._shift_dmem_plain(walk, bank.theta, bank.data), 0.0, 1.0)
    check(f"27q-3l first bank B={bank.n_samples} vs the plain version", got, plain.reshape(-1))
    cpu = torch.device("cpu")
    closs, cgrads, cfids = quclassi.grad_shift(
        cfg, {k: v.to(cpu) for k, v in params.items()}, torch.as_tensor(x), torch.as_tensor(y),
        executor=dataplane.worker_batched_executor(cfg.spec, assign, 2), implicit=True)
    onehot = torch.nn.functional.one_hot(torch.as_tensor(y).long(), cfg.n_classes).float()
    chain = fidelity.bce_grad_wrt_fidelity(cfids, onehot)
    tol = TOL * max(1.0, float(chain.abs().max()))
    d_loss = abs(float(loss) - float(closs))
    d_grad = float((grads["theta"].cpu() - cgrads["theta"]).abs().max())
    g_max = float(cgrads["theta"].abs().max())
    log(f"  card vs CPU step: |loss diff| {d_loss:.3e}, max|grad diff| {d_grad:.3e} "
        f"(tolerance {tol:.3e}: 1e-5 x the largest chain factor; and {GRAD_RTOL} x max|grad| "
        f"{g_max:.3e} = {GRAD_RTOL * g_max:.3e})")
    hold_rows("27q-3l step fidelities card vs CPU", fids.cpu(), cfids)
    if not (d_loss <= tol and d_grad <= tol and d_grad <= GRAD_RTOL * g_max):
        raise AssertionError(f"27q step on the card differs from the CPU's: loss {d_loss}, "
                             f"gradients {d_grad} (max|grad| {g_max})")

    # (d) a tenant's 27q-1l implicit bank through the gateway, sync and async
    spec = circuits.build_quclassi_circuit(27, 1)
    th, dt = angles(spec, WIDE_SERVE_B)
    bank = shift_rule.build_shift_bank(th[0], dt)
    want = ops.vqc_fidelity_shiftgroups(spec, bank.theta, bank.data).reshape(-1)
    workers = [WorkerConfig("w1", 27), WorkerConfig("w2", 33)]
    log(f"wide (d): a 27q-1l implicit bank of {WIDE_SERVE_B} samples through GatewayRuntime, "
        "workers of 27 and 33 qubits")
    served = {}
    for mode in ("sync", "async"):
        rt = GatewayRuntime(workers, deadline=0.05, mode=mode)
        try:
            torch.cuda.synchronize()
            zero_counts(K)
            t0 = time.perf_counter()
            served[mode] = rt.shift_executor(spec, "wide")(bank)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            read(f"wide (d) {mode}", ("shift_dmem",))
        finally:
            rt.close()
        summ = rt.telemetry.summary()
        if rt.telemetry.mesh_spills:
            raise AssertionError(f"wide (d) {mode}: a batch went to the mesh")
        log(f"  {mode}: {bank.n_groups} group subtasks in {seconds:.4f} s, {summ['batches']} "
            f"batches, lane fill {summ['lane_fill']} [{card}]")
    if not (torch.equal(served["sync"], served["async"]) and torch.equal(served["sync"], want)):
        raise AssertionError("wide (d): sync, async and the direct call differ")
    log("  sync == async == ops.vqc_fidelity_shiftgroups bit for bit")
    log(f"wide: phase 14 took {time.perf_counter() - t_phase:.2f} s wall")
    return counts, worst[0], record


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


#: images a step of the benchmark's cell train.7q3l.b4096, the shape at
#: which phase 4 times the dense layer's register kernel
DENSE_TIME_BATCH = 4096
#: the register kernel against its plain version: float32 with another
#: summation order (block partials in block order against one matmul), so
#: within this share of the largest element
DENSE_PLAIN_RTOL = 1e-4


def dense_grad_cost(m: int, n_classes: int, patch_dim: int, n: int, n_images: int,
                    blocks: int, n_theta: int) -> tuple[int, int]:
    """(flops, bytes) of ``dense_grad_kernel`` and its reduction over ``n``
    patches.  Per patch and class: 2**m amplitudes of 3m - 1 complex
    products (6 flops) and m + 1 complex sums (2), then 2m angle derivatives
    of 2 products and 6 flops more, and the fidelity (3); per patch the
    3 factors of each qubit (two rotations of 8 flops), the sigmoid's chain
    (3 an angle) and the outer product into dW (2 a weight) and db (1).
    Bytes: angles, patches, the chain weights (a row an image) and theta
    in, the partials written and read back, the gradient out."""
    a, elems = 2 * m, patch_dim * 2 * m + 2 * m
    per_class = 2**m * (6 * (3 * m - 1) + 2 * (m + 1)) + a * (12 + 6) + 3
    flops = n * (n_classes * per_class + 3 * m * 16 + 3 * a + 2 * patch_dim * a + a)
    flops += blocks * elems
    nbytes = 4 * (n * (a + patch_dim) + n_images * n_classes + n_classes * n_theta
                  + 2 * blocks * elems + elems)
    return flops, nbytes


def dense_grad_phase(dev, card: str, shapes: dict) -> tuple[dict, float, dict]:
    """Phase 4's check of the dense layer's register kernel and its
    reduction (``kernels/dense_grad.py``) on the card.  ``shapes``:
    {label: (cfg, params, images, labels)}, each a training step's shape;
    a step of the benchmark's cell (7q-3l, ``DENSE_TIME_BATCH`` images) is
    added.  At each: the launch counts zeroed, then one launch of each
    kernel a call; the gradient against the plain version on the CPU
    (``DENSE_PLAIN_RTOL``) and against autograd through the dense
    simulator (``quclassi._dense_grad_simulator``) at the chain-scaled
    tolerance TOL (c + c**2), c = max |(f - y) / (f (1 - f))| over the
    scores the loss's clamp leaves inside [eps, 1 - eps]; two calls bit-equal.
    The benchmark's shape is timed.  Returns (launches, max_abs_err against
    the plain version, record)."""
    import torch.nn.functional as F_

    from repro_torch.core import fidelity, quclassi
    from repro_torch.kernels import dense_grad
    from repro_torch.kernels import vqc_statevector as K

    cfg7 = shapes["7q-3l"][0]
    g = torch.Generator().manual_seed(0)
    shapes = dict(shapes)
    shapes[f"7q-3l B={DENSE_TIME_BATCH}"] = (
        cfg7, quclassi.init_params(cfg7, g, dev),
        torch.rand((DENSE_TIME_BATCH, *cfg7.image_size), generator=g).to(dev),
        torch.randint(0, cfg7.n_classes, (DENSE_TIME_BATCH,), generator=g).to(dev))
    counts, worst, record = {key: 0 for key in K.LAUNCHES}, 0.0, {}
    for label, (cfg, params, images, labels) in shapes.items():
        plan = dense_grad.route_plan(cfg.qc, cfg.n_layers, cfg.n_classes, cfg.patch_dim)
        if plan is None:
            raise AssertionError(f"dense {label}: the register route refuses the shape")
        with torch.no_grad():
            angles, patches = quclassi.encode_images(cfg, params, images)
            fids = quclassi.class_fidelities(cfg, params, images)
        onehot = F_.one_hot(labels.long(), cfg.n_classes).to(torch.float32)
        weights = quclassi.dense_chain_weights(fids, onehot, cfg.n_patches)
        args = (plan, params["theta"], angles, patches, weights, cfg.n_patches)

        def pair(args=args, cfg=cfg):
            parts = dense_grad.register_partials(*args)
            return dense_grad.reduce_partials(parts, cfg.patch_dim, cfg.n_angles), parts

        torch.cuda.synchronize()
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        (gw, gb), parts = pair()
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        if {k: n for k, n in got.items() if n} != {"dense_grad": 1, "dense_reduce": 1}:
            raise AssertionError(f"dense {label}: launches {got}, not one of each kernel")
        for key, n in got.items():
            counts[key] += n
        (aw, ab), _ = pair()
        if not (torch.equal(aw, gw) and torch.equal(ab, gb)):
            raise AssertionError(f"dense {label}: two calls differ")
        pw, pb = dense_grad.reduce_partials(
            dense_grad.register_partials(plan, *(t.cpu() for t in args[1:5]), cfg.n_patches),
            cfg.patch_dim, cfg.n_angles)
        err = max(float((gw.cpu() - pw).abs().max()), float((gb.cpu() - pb).abs().max()))
        tol = DENSE_PLAIN_RTOL * max(float(pw.abs().max()), float(pb.abs().max()))
        worst = max(worst, err)
        log(f"  dense_grad    {label:44s} max|diff| = {err:.3e} (plain, tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"dense {label}: max|diff| to the plain version {err} > {tol}")
        sim = quclassi._dense_grad_simulator(cfg, params, images, labels)
        f = fids.cpu().numpy()
        inside = (f >= fidelity._EPS) & (f <= 1 - fidelity._EPS)
        fc = np.clip(f, fidelity._EPS, 1 - fidelity._EPS)
        c = float(np.abs((fc - onehot.cpu().numpy()) / (fc * (1 - fc)))[inside].max())
        tol = TOL * (c + c**2)
        err = max(float((gw - sim["w"]).abs().max()), float((gb - sim["b"]).abs().max()))
        log(f"  dense_grad    {label:44s} max|diff| = {err:.3e} (dense simulator, tol "
            f"{tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"dense {label}: max|diff| to the simulator {err} > {tol}")
        if label.endswith(f"B={DENSE_TIME_BATCH}"):
            n = angles.shape[0]
            flops, nbytes = dense_grad_cost(plan.m, cfg.n_classes, cfg.patch_dim, n,
                                            images.shape[0], parts.shape[0], cfg.n_theta)
            ms = time_ms(pair)
            dev_kernel = device_ms(pair, "dense_grad_kernel")
            dev_reduce = device_ms(pair, "dense_reduce_kernel")
            dev_ms = (None if dev_kernel is None or dev_reduce is None
                      else dev_kernel + dev_reduce)
            cpu_args = [t.cpu() for t in args[1:5]]
            plain_ms = time_ms(lambda: dense_grad.register_partials(
                plan, *cpu_args, cfg.n_patches), iters=2, warmup=1)
            bound_ms, bound_by = bound(flops, nbytes)
            record = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "shape": f"{label}: {n} patches, {parts.shape[0]} blocks",
                      "reduce": {"device_ms": dev_reduce, "launches": counts["dense_reduce"]}}
            shown = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
            log(f"  time dense_grad    {record['shape']}: kernel and reduction {ms:.4f} ms "
                f"(events; device time {shown}, the reduction's "
                f"{'not measured' if dev_reduce is None else f'{dev_reduce:.4f} ms'}), plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}; {flops} flops, "
                f"{nbytes} bytes) [{card}]")
    return counts, worst, record



#: the dense layer's wide route in phase 4: QuClassi at m = 13, 14 and 16
#: on the cell train.27q3l.b64's 64 images (576 patches); the first, the
#: cell's configuration, is also timed against the plain version and trained
DENSE_WIDE_SHAPES = (("27q-3l", 27, 3), ("29q-2l", 29, 2), ("33q-1l", 33, 1))
DENSE_WIDE_BATCH = 64


def dense_wide_cost(plan, n_classes: int, patch_dim: int, n: int) -> tuple[int, int]:
    """(flops, bytes) of the least work of the wide route over ``n`` patches,
    which no implementation can do with less (the count of
    ``dqbench/dense_wide_counters.py``): one inner product of 2**m
    amplitudes a (class, patch) and the trainable register's gates once a
    class; the patches, w and b read once, dW and db written once."""
    a = 2 * plan.m
    flops = n_classes * (n * INNER_FLOPS_PER_AMP * 2**plan.m + ops_flops(plan.train_ops, plan.m))
    return flops, 4 * (n * patch_dim + 2 * (patch_dim * a + a))


def dense_wide_phase(dev, card: str) -> tuple[dict, float, dict]:
    """Phase 4's check of the dense layer's wide route
    (``dense_wide_psi_kernel``, ``dense_wide_kernel``, then
    ``dense_reduce_kernel``) on the card.  (a) At each DENSE_WIDE_SHAPES
    width, QuClassi's encoding of DENSE_WIDE_BATCH random images and chain
    weights N(0, 1): the launch counts zeroed, then one launch of each
    kernel a call; w and b within DENSE_PLAIN_RTOL of the largest element of
    the plain version (``dense_grad._partials_plain``, on the CPU); two
    calls bit-equal; the three kernels timed (events, and device time each
    from one profiler window).  At 27q-3l also the plain version's time and
    the least-work bound (``dense_wide_cost``).  (b) Steps of 27q-3l
    QuClassi with its dense layer through the 2-worker implicit executor at
    batch 64, as the cell trains it: one launch of each kernel a step, none
    of the register kernel, the dense simulator never entered, w and b
    finite and bit-equal across two steps.  Returns (launches, max_abs_err
    against the plain version, the 27q-3l record)."""
    from repro_torch.api.capabilities import declare
    from repro_torch.comanager import dataplane
    from repro_torch.core import quclassi, segmentation
    from repro_torch.data.mnist import make_pair_dataset
    from repro_torch.kernels import dense_grad
    from repro_torch.kernels import vqc_statevector as K

    names = ("dense_wide_psi_kernel", "dense_wide_kernel", "dense_reduce_kernel")
    wanted = {"dense_wide_psi": 1, "dense_wide": 1, "dense_reduce": 1}
    counts, worst, record = {key: 0 for key in K.LAUNCHES}, 0.0, {}
    g = torch.Generator().manual_seed(0)
    for label, qc, nl in DENSE_WIDE_SHAPES:
        cfg = quclassi.QuClassiConfig(qc=qc, n_layers=nl)
        plan = dense_grad.route_plan(cfg.qc, cfg.n_layers, cfg.n_classes, cfg.patch_dim)
        if plan is None or not plan.wide:
            raise AssertionError(f"dense wide {label}: the wide route refuses the shape")
        params = quclassi.init_params(cfg, g, dev)
        images = torch.rand((DENSE_WIDE_BATCH, *cfg.image_size), generator=g).to(dev)
        with torch.no_grad():
            angles, patches = quclassi.encode_images(cfg, params, images)
        weights = torch.randn((DENSE_WIDE_BATCH, cfg.n_classes), generator=g).to(dev)
        args = (plan, params["theta"], angles, patches, weights, cfg.n_patches)

        def three(args=args, cfg=cfg):
            parts = dense_grad.register_partials(*args)
            return dense_grad.reduce_partials(parts, cfg.patch_dim, cfg.n_angles), parts

        torch.cuda.synchronize()
        zero_counts(K)
        (gw, gb), parts = three()
        torch.cuda.synchronize()
        got = {k: n for k, n in K.LAUNCHES.items() if n}
        if got != wanted:
            raise AssertionError(f"dense wide {label}: launches {got}, not one of each kernel")
        for key, n in got.items():
            counts[key] += n
        (aw, ab), _ = three()
        if not (torch.equal(aw, gw) and torch.equal(ab, gb)):
            raise AssertionError(f"dense wide {label}: two calls differ")
        cpu_args = [t.cpu() for t in args[1:5]]
        pw, pb = dense_grad.reduce_partials(
            dense_grad._partials_plain(plan, *cpu_args, cfg.n_patches), cfg.patch_dim,
            cfg.n_angles)
        err = max(float((gw.cpu() - pw).abs().max()), float((gb.cpu() - pb).abs().max()))
        tol = DENSE_PLAIN_RTOL * max(float(pw.abs().max()), float(pb.abs().max()))
        worst = max(worst, err)
        n = angles.shape[0]
        log(f"  dense_wide    {label:44s} max|diff| = {err:.3e} (plain, tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"dense wide {label}: max|diff| to the plain version {err} > {tol}")
        ms = time_ms(three)
        dev_each = device_ms_each(three, names)
        dev_ms = None if None in dev_each.values() else sum(dev_each.values())
        shown = ", ".join("not measured" if v is None else f"{v:.4f}" for v in dev_each.values())
        flops, nbytes = dense_wide_cost(plan, cfg.n_classes, cfg.patch_dim, n)
        bound_ms, bound_by = bound(flops, nbytes)
        shape = f"{label} m={plan.m}: {n} patches, {parts.shape[0]} blocks"
        plain_ms = None
        if not record:  # the cell's configuration
            plain_ms = time_ms(lambda: dense_grad._partials_plain(plan, *cpu_args, cfg.n_patches),
                               iters=2, warmup=1)
            record = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "shape": shape,
                      "psi": {"device_ms": dev_each[names[0]]},
                      "kernel_device_ms": dev_each[names[1]],
                      "reduce": {"device_ms": dev_each[names[2]]}}
        log(f"  time dense_wide    {shape}: the three kernels {ms:.4f} ms (events; device time "
            f"psi, wide, reduction {shown} ms), plain "
            f"{'not measured' if plain_ms is None else f'{plain_ms:.4f} ms'}, bound "
            f"{bound_ms:.6f} ms ({bound_by}; {flops} flops, {nbytes} bytes) [{card}]")
        del parts, angles, patches

    # (b) the cell's steps: 27q-3l with the dense layer on 2 workers
    cfg = quclassi.QuClassiConfig(
        qc=27, n_layers=3,
        seg=segmentation.SegmentationConfig(filter_width=4, stride=2, n_filters=4),
        image_size=(8, 8))
    n_groups = 1 + 2 * cfg.n_theta
    executor = declare(dataplane.worker_batched_executor(
        cfg.spec, dataplane.round_robin_assignment(n_groups, 2), 2), shiftbank=True)
    x, y = make_pair_dataset(1, 5, n_per_class=DENSE_WIDE_BATCH // 2, seed=0)
    params = quclassi.init_params(cfg, torch.Generator().manual_seed(0), dev)
    xb, yb = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)

    def refuse(*args, **kwargs):
        raise AssertionError("dense wide: the 27q step entered the dense simulator")

    simulator, quclassi._dense_grad_simulator = quclassi._dense_grad_simulator, refuse
    try:
        quclassi.grad_shift(cfg, params, xb, yb, executor=executor, implicit=True)  # warm-up
        torch.cuda.synchronize()
        zero_counts(K)
        steps = [quclassi.grad_shift(cfg, params, xb, yb, executor=executor, implicit=True)
                 for _ in range(2)]
        torch.cuda.synchronize()
    finally:
        quclassi._dense_grad_simulator = simulator
    got = dict(K.LAUNCHES)
    log(f"  dense_wide    27q-3l steps: 2 steps of {DENSE_WIDE_BATCH} images with the dense "
        f"layer on 2 workers, launches {got} [{card}]")
    if not (got["dense_wide_psi"] == got["dense_wide"] == got["dense_reduce"] == 2
            and got["dense_grad"] == 0 and got["shift_dmem"] > 0):
        raise AssertionError(f"dense wide 27q-3l steps: launches {got}, not one of each wide "
                             "kernel a step on the shift walk")
    for key, n in got.items():
        counts[key] += n
    (_, g0, _), (_, g1, _) = steps
    for k in ("w", "b"):
        if not torch.isfinite(g0[k]).all():
            raise AssertionError(f"dense wide 27q-3l steps: the {k} gradient is not finite")
        if not torch.equal(g0[k], g1[k]):
            raise AssertionError(f"dense wide 27q-3l steps: two steps give other {k} gradients")
    return counts, worst, record


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
            "shift_tile": 0.0, "fidelity_dmem": 0.0, "state_dmem": 0.0,
            "shift_dmem": 0.0}  # against plain only

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
    # state's traffic over device memory in the route's passes
    # (``K.dmem_traffic_bytes``) is logged beside it as that scheme's own
    # bound
    spec17 = wide[17]
    th17, dt17 = angles(spec17, DMEM_ROWS)
    p17, d17, ops17 = spec17.n_theta, spec17.n_data, len(spec17.ops)
    pass_bytes, n_passes = {}, {}
    for kname, want_state in (("fidelity_dmem", False), ("state_dmem", True)):
        kern = K.vqc_state if want_state else K.vqc_p0
        timed[kname] = (
            lambda kern=kern: kern(spec17, th17, dt17),
            lambda want_state=want_state: K._fused_plain(spec17, th17, dt17, want_state),
            DMEM_ROWS * (ops_flops(spec17.ops, 17) + (0 if want_state else 2 * 2**17)),
            DMEM_ROWS * (4 * (p17 + d17) + (8 * 2**17 if want_state else 4)),
            f"17q-1l C={DMEM_ROWS} circuits ({ops17} gates a circuit)",
        )
        n_passes[kname], per_circuit = K.dmem_traffic_bytes(spec17, want_state)
        pass_bytes[kname] = DMEM_ROWS * per_circuit
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
            cluster = K.dmem_geometry(spec17, DMEM_ROWS, K._sm_count(dev))[0]
            records[kname].update(
                passes=n_passes[kname], pass_bytes=pass_bytes[kname], cluster=cluster,
                pass_bound_ms=pass_bytes[kname] / PEAK_BYTES_PER_S * 1e3)
            log(f"  {kname}: {n_passes[kname]} passes of k = {K.DMEM_LOCAL_QUBITS} local "
                f"qubits ({ops17} gates), {cluster} block(s) a circuit, move "
                f"{pass_bytes[kname]} bytes of state ("
                f"{pass_bytes[kname] / (DMEM_ROWS * 16 * 2**17):.3f} full read-and-write "
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
    first, trained = {}, {}
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
        first[label], trained[label] = seen[0], rep.params
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
        for key in wanted + ("dense_grad", "dense_reduce"):  # every run trains w and b
            if counts[key] <= 0:
                raise AssertionError(f"{label}: the {key} kernel was never launched")
        if counts["dense_grad"] != counts["dense_reduce"]:
            raise AssertionError(f"{label}: the dense gradient's two kernels launched "
                                 f"{counts['dense_grad']} and {counts['dense_reduce']} times")
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
    log("checks: the dense layer's register kernel and its reduction at the step shapes")
    dense_counts, errs["dense_grad"], records["dense_grad"] = dense_grad_phase(
        dev, card, {"7q-3l": (cfg, inits["7q implicit"], xb, yb),
                    "13q-3l": (cfg13, inits["13q implicit"], xb, yb)})
    for key, n in dense_counts.items():
        launches[key] += n
    log("checks: the dense layer's wide route at the 27q cell's shape and in its steps")
    wide_counts, errs["dense_wide"], records["dense_wide"] = dense_wide_phase(dev, card)
    for key, n in wide_counts.items():
        launches[key] += n
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
    gateway_counts, fig6_baseline = serve_gateway(dev, card)
    for key, n in gateway_counts.items():
        launches[key] += n
    log(f"gateway: phase 6 took {time.perf_counter() - t0:.2f} s wall")

    # ----------------------------------------------------------- 7. cluster
    t0 = time.perf_counter()
    for key, n in cluster_phase(dev, card).items():
        launches[key] += n
    log(f"cluster: phase 7 took {time.perf_counter() - t0:.2f} s wall")

    # --------------------------------------------------------------- 8. zoo
    zoo = serve_zoo(dev, card, trained["7q implicit"])
    launches["flash"] += zoo["flash_wgmma"]
    records["flash"]["simt"]["launches"] += zoo["flash_simt"]

    # ------------------------------------------------- 9. SSM and multimodal
    mm = serve_ssm_multimodal(dev, card)
    launches["flash"] += mm["flash_wgmma"]
    records["flash"]["simt"]["launches"] += mm["flash_simt"]

    # -------------------------------------------------------- 10. LM training
    train_lm(dev, card)

    # ------------------------------------------------------------ 11. dry-runs
    for key, n in dryrun_phase(dev, card).items():
        launches[key] += n

    # ------------------------------------------------------------ 12. faults
    for key, n in fault_phase(dev, card, fig6_baseline).items():
        launches[key] += n

    # ---------------------------------------------------------- 13. examples
    for key, n in examples_phase(dev, card).items():
        launches[key] += n

    # ------------------------------------------------- 14. wide shift plans
    wide_counts, errs["shift_dmem"], records["shift_dmem"] = wide_shift_phase(dev, card)
    for key, n in wide_counts.items():
        launches[key] += n

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
        # the spill pair's device-memory route (registers of 13+ qubits):
        # one kernel for kernels 4 and 5, its own entry
        {"name": "shift_dmem", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vqc_shift_dmem.cu",
         "replaces": "src/repro/kernels/vqc_statevector.py:822"},
        # the dense layer's gradient on the two registers, in place of
        # jax.grad through the dense simulator; its reduction under "reduce"
        {"name": "dense_grad", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vqc_dense_grad.cu",
         "replaces": "src/repro/core/quclassi.py:196"},
        # its wide route (registers of 13-16 qubits): psi's build under
        # "psi", the reduction, shared with dense_grad, under "reduce"
        {"name": "dense_wide", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vqc_dense_grad.cu",
         "replaces": "src/repro/core/quclassi.py:196"},
        {"name": "flash", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attn_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:31"},
    ]
    for k in kernels:
        n = k["name"]
        k.update(launches=launches[n], max_abs_err=errs[n], **{"library_ms": None, **records[n]})
        if n == "dense_grad":
            k["reduce"]["launches"] = launches["dense_reduce"]
        if n == "dense_wide":
            k["psi"]["launches"] = launches["dense_wide_psi"]
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
