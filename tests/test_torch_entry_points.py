"""The kernels' C entry points as the runtime declares them from their
``extern "C"`` lines.  A wrong declaration shows only on the card, as a
call with an argument cut or widened, so it is checked here on the CPU:
each library is loaded through ``_build.load`` with a stand-in for
``ctypes.CDLL`` (no nvcc, no card), and every entry point's ``restype`` and
``argtypes`` must equal the declarations the kernels were launched with
before the runtime derived them from the sources."""
import contextlib
import ctypes
import re
import types
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build

vp, i32, i64, text = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_char_p
VQC_ERROR = {"vqc_error_string": (text, [i32])}
#: library -> entry point -> (restype, argtypes)
DECLARED = {
    "vqc_fused": {
        "vqc_fidelity_launch": (i32, [vp, vp, i32, i32, i32, vp, vp, i32, i32, vp, i32, i32,
                                      vp]),
        "vqc_state_launch": (i32, [vp, vp, i32, i32, i32, vp, vp, i32, i32, vp, vp, i32, i32,
                                   vp]),
        "vqc_dmem_launch": (i32, [i32, vp, vp, i32, i32, i32, vp, vp, i32, vp, i32, i32, i32,
                                  vp, vp, i64, vp, i32, i32, i32, vp]),
        **VQC_ERROR},
    "vqc_shiftbank": {
        "vqc_shiftbank_launch": (i32, [vp, vp, i32, i32, i32, vp, vp, i32, i32, i32, i32, i32,
                                       i32, vp, i32, i32, vp]),
        **VQC_ERROR},
    "vqc_spill": {
        "vqc_shift_forward_launch": (i32, [vp, vp, i32, i32, i32, vp, vp, i32, i32, i32, i32,
                                           i32, i32, vp, vp, vp, i32, i32, vp]),
        "vqc_shift_tile_launch": (i32, [vp, vp, i32, i32, i32, vp, vp, i32, i32, i32, i32, i32,
                                        vp, vp, vp, i32, i32, vp]),
        **VQC_ERROR},
    "vqc_shift_dmem": {
        "vqc_shift_dmem_launch": (i32, [vp, vp, i32, i32, i32, vp, vp, i32, vp, vp, i32, vp,
                                        i32, vp, vp, vp, i32, vp, i32, i32, i32, vp, i64, vp,
                                        i64, i64, i32, i32, vp]),
        **VQC_ERROR},
    "vqc_dense_grad": {
        "vqc_dense_grad_launch": (i32, [vp, i32, i32, vp, vp, i32, vp, vp, i32, vp, i32, vp,
                                        i32, vp, i32, i64, i32, i32, vp, i32, vp]),
        "vqc_dense_reduce_launch": (i32, [vp, i32, i32, vp, vp]),
        "vqc_dense_wide_psi_launch": (i32, [vp, i32, i32, vp, vp, i32, i32, vp, i32, i32, vp]),
        "vqc_dense_wide_launch": (i32, [vp, i32, vp, vp, i32, vp, i32, vp, i32, vp, i32, i64,
                                        i32, i32, vp, i32, vp]),
        **VQC_ERROR},
    "flash_attn": {
        "flash_attn_launch": (i32, [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]),
        "flash_error_string": (text, [i32])},
    "flash_attn_sm90": {
        "flash_sm90_launch": (i32, [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]),
        "flash_sm90_error_string": (text, [i32])},
}


class _Library:
    """Stands in for ``ctypes.CDLL``: every attribute an entry point on
    which the runtime sets ``restype`` and ``argtypes``."""

    def __init__(self, path):
        self.path = path
        self.entries = {}

    def __getattr__(self, name):
        entry = self.entries[name] = types.SimpleNamespace(name=name)
        setattr(self, name, entry)
        return entry


@pytest.fixture
def stand_in(monkeypatch, tmp_path):
    """Load without nvcc or a card: nothing is built, ``ctypes.CDLL`` is
    ``_Library``, and the runtime's cache starts empty."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build", lambda names: None)
    monkeypatch.setattr(_build.ctypes, "CDLL", _Library)
    monkeypatch.setattr(_build, "_loaded", {})
    return tmp_path


def test_every_library_is_in_the_table():
    assert sorted(DECLARED) == sorted(_build.KERNELS)


@pytest.mark.parametrize("library", sorted(DECLARED))
def test_entry_points_are_declared_from_the_sources(library, stand_in):
    lib, error = _build.load(library)
    assert lib.path == str(_build.library_path(library))
    got = {name: (e.restype, list(e.argtypes)) for name, e in lib.entries.items()}
    assert got == DECLARED[library]
    [error_name] = [name for name, (restype, _) in DECLARED[library].items() if restype is text]
    assert error is lib.entries[error_name]
    assert _build.load(library)[0] is lib


def test_an_unmapped_type_raises_at_load(stand_in, monkeypatch):
    csrc = stand_in / "csrc"
    csrc.mkdir()
    (csrc / "odd.cuh").write_text('extern "C" const char* odd_error_string(int code) {}\n')
    (csrc / "odd.cu").write_text('#include "odd.cuh"\n'
                                 'extern "C" int odd_launch(const float* x, unsigned n,\n'
                                 '                          void* stream) {}\n')
    monkeypatch.setattr(_build, "CSRC", csrc)
    with pytest.raises(TypeError, match="odd_launch.*'unsigned'"):
        _build.load("odd")
    assert "odd" not in _build._loaded


def test_only_the_runtime_declares_entry_points():
    kernels = Path(_build.__file__).parent
    declaring = sorted(p.name for p in kernels.glob("*.py")
                       if re.search(r"\.(argtypes|restype)\b", p.read_text()))
    assert declaring == ["_build.py"]


def test_launch_appends_the_stream_checks_and_counts(monkeypatch):
    """The one launch routine: the call gets the device's stream last; a
    nonzero return raises with the library's error string and counts
    nothing; a zero return counts under every key it names."""
    from repro_torch.kernels import flash_attention as F

    calls, rcs = [], [0, 700]
    lib = types.SimpleNamespace(flash_attn_launch=lambda *args: calls.append(args) or rcs.pop(0))
    errors = {700: b"an illegal memory access was encountered"}
    monkeypatch.setattr(_build, "_loaded", {"flash_attn": (lib, errors.get)})
    monkeypatch.setattr(_build, "stream", lambda dev: f"stream of {dev}")
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    before = dict(F.LAUNCHES)
    try:
        _build.launch("flash_attn", "flash_attn_launch", "flash-attention (flash_simt)", "dev0",
                      1, 2, count=("flash", "flash_simt"))
        assert calls == [(1, 2, "stream of dev0")]
        assert F.LAUNCHES == {**before, "flash": before["flash"] + 1,
                              "flash_simt": before["flash_simt"] + 1}
        with pytest.raises(RuntimeError, match=r"^flash-attention \(flash_simt\) kernel launch "
                                               "failed: an illegal memory access"):
            _build.launch("flash_attn", "flash_attn_launch", "flash-attention (flash_simt)",
                          "dev0", 3, count="flash_simt")
        assert F.LAUNCHES["flash_simt"] == before["flash_simt"] + 1
    finally:
        F.LAUNCHES.update(before)
