"""Build the CUDA kernels from ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ``ctypes``.  Libraries go to
``build/repro_torch_kernels/`` at the repository root, named by a hash of
every source and the flags, so an edited source rebuilds and an unchanged
one is reused, with the compiler's report kept beside it.  ``build()``
starts one ``nvcc`` per missing library, all at once.  Nothing is downloaded; a missing or failing compiler raises with
its output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: one shared library per source file
KERNELS = ("vqc_fused", "vqc_shiftbank", "vqc_spill", "vqc_shift_dmem", "vqc_dense_grad",
           "flash_attn", "flash_attn_sm90")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin): the "
        "repro_torch CUDA kernels are built from source and need the CUDA toolkit"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def report_path(library: Path) -> Path:
    """The compiler's output for ``library``, written with it."""
    return library.with_suffix(".ptxas.txt")


def build(names=KERNELS) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    process per source, all started together.  Returns per library its
    path, the seconds its compile took (0.0 when reused) and the compiler's
    output (register, spill and shared-memory use from ``-Xptxas -v``; for
    a reused library the output of the build that made it, or "" when that
    report is missing)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs, report = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            kept = report_path(out)
            log = kept.read_text() if kept.exists() else ""
            report[name] = {"path": str(out), "seconds": 0.0, "log": log}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        report_path(tmp).write_text(log)
        os.replace(report_path(tmp), report_path(out))
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        report[name] = {"path": str(out), "seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address for a C entry point (None -> NULL)."""
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def stream(dev) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``dev``: kernels launch on it."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
