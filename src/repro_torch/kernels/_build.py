"""The kernels' runtime: build the CUDA kernels from ``csrc/`` at first
use, load them, declare their entry points and launch them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ``ctypes``.  Libraries go to
``build/repro_torch_kernels/`` at the repository root, named by a hash of
every source and the flags, so an edited source rebuilds and an unchanged
one is reused, with the compiler's report kept beside it.  ``build()``
starts one ``nvcc`` per missing library, all at once.  Nothing is downloaded; a missing or failing compiler raises with
its output.

``load`` declares every ``extern "C"`` function of a library from its
sources (``entry_points``), so each entry point's signature is written once,
in C.  Every kernel wrapper launches through ``launch``, which counts the
launch into its module's ``LAUNCHES`` (made by ``launch_counts``).  Nothing
is built, loaded or declared before the first launch that needs it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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

#: library name -> (the loaded library, its error-string entry point)
_loaded: dict[str, tuple] = {}
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


_EXTERN = re.compile(r'extern "C"\s+([^(]*?)\s*\b(\w+)\s*\(([^)]*)\)')
_INCLUDE = re.compile(r'^\s*#include "([^"]+)"', re.M)
#: C type -> ctypes type, of a return and of a parameter (any pointer is a ``void*``)
_RETURNS = {"int": ctypes.c_int, "const char*": ctypes.c_char_p}
_PARAMS = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "void*": ctypes.c_void_p}


def _c_type(table: dict, c_type: str, entry: str):
    if c_type not in table:
        raise TypeError(f"{entry}: no ctypes type for the C type {c_type!r}")
    return table[c_type]


def entry_points(source: Path) -> dict[str, tuple]:
    """Each ``extern "C"`` function of ``source`` and of the local headers it
    includes (``#include "..."``, followed recursively) -> its ctypes
    ``(restype, argtypes)``.  Returns are ``int`` or ``const char*``;
    parameters are pointers (``c_void_p``), ``long long`` or ``int``; any
    other type raises, naming the entry point."""
    out, seen, todo = {}, set(), [Path(source)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_text()
        todo += [path.parent / header for header in _INCLUDE.findall(text)]
        for ret, entry, params in _EXTERN.findall(text):
            # a parameter's type is its words but the last, its name
            types = ["void*" if "*" in p else " ".join(p.split()[:-1])
                     for p in params.split(",") if p.strip()]
            out[entry] = (_c_type(_RETURNS, " ".join(ret.split()), entry),
                          tuple(_c_type(_PARAMS, t, entry) for t in types))
    return out


def declare(lib, source: Path):
    """Declare on ``lib`` every entry point of ``source`` (``entry_points``);
    returns the library's error string, its one ``const char*`` entry point
    taking an ``int``."""
    errors = []
    for entry, (restype, argtypes) in entry_points(source).items():
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = restype, argtypes
        if restype is ctypes.c_char_p and argtypes == (ctypes.c_int,):
            errors.append(fn)
    if len(errors) != 1:
        raise RuntimeError(f"{Path(source).name}: {len(errors)} error-string entry points "
                           "(const char* taking an int), want one")
    return errors[0]


def load(name: str) -> tuple:
    """The library ``name`` with its entry points declared, and its error
    string: built if needed, loaded and declared once, under a lock,
    however many threads ask for it first."""
    got = _loaded.get(name)
    if got is None:
        with _lock:
            got = _loaded.get(name)
            if got is None:
                path = library_path(name)
                if not path.exists():
                    build((name,))
                lib = ctypes.CDLL(str(path))
                got = _loaded[name] = (lib, declare(lib, CSRC / f"{name}.cu"))
    return got


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address for a C entry point (None -> NULL)."""
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def stream(dev) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``dev``: kernels launch on it."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


#: launch-count key -> the ``launch_counts`` dict that holds it
_COUNTS: dict[str, dict] = {}
#: the async dispatcher launches from several threads
_COUNT_LOCK = threading.Lock()


def launch_counts(*keys: str) -> dict[str, int]:
    """A kernel module's launch counts, all 0: the dict that ``launch`` and
    ``count_launch`` add to under these keys."""
    counts = dict.fromkeys(keys, 0)
    _COUNTS.update(dict.fromkeys(keys, counts))
    return counts


def count_launch(*keys: str) -> None:
    """One launch more under each of ``keys``."""
    with _COUNT_LOCK:
        for key in keys:
            _COUNTS[key][key] += 1


def launch(library: str, entry: str, what: str, device, *args, count) -> None:
    """Call ``entry`` of ``library`` on ``device`` with ``args`` and
    PyTorch's current stream of ``device`` last; raise with the library's
    error string on a nonzero return, else count one launch under
    ``count`` (a key, or a tuple of keys)."""
    lib, error = load(library)
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, stream(device))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: {error(rc).decode()}")
    count_launch(*((count,) if isinstance(count, str) else count))

_DEVICE_TABLES: dict = {}
_TABLES_LOCK = threading.Lock()


def on_device(key, arrays, device) -> tuple[torch.Tensor, ...]:
    """Host tables copied to ``device`` once per (key, device), None kept
    as None.  The copy is made under a lock and waited for before the
    tables are shared, so a kernel launched from another thread, on another
    stream, never reads a table whose copy is still in flight."""
    k = (key, device)
    got = _DEVICE_TABLES.get(k)
    if got is None:
        with _TABLES_LOCK:
            got = _DEVICE_TABLES.get(k)
            if got is None:
                got = tuple(None if a is None else torch.from_numpy(a).to(device)
                            for a in arrays)
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
                _DEVICE_TABLES[k] = got
    return got


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The card's streaming multiprocessors."""
    return torch.cuda.get_device_properties(device).multi_processor_count
