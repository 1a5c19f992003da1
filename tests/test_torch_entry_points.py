"""The ctypes declarations of the kernels' C entry points against the C
sources: each entry point takes the parameters, in number and kind, that
its ``extern "C"`` declaration names.  A mismatch shows only on the card,
as a launch that cannot be called, so it is checked here on the CPU with
a stand-in for the loaded library."""
import ctypes
import re
import types
from pathlib import Path

import pytest

from repro_torch.kernels import _build, flash_attention
from repro_torch.kernels import vqc_statevector as K

CSRC = Path(K.__file__).parent / "csrc"


class _Entries:
    """Stands in for a loaded library: every attribute an entry point on
    which the declaration sets ``argtypes`` and ``restype``."""

    def __getattr__(self, name):
        entry = types.SimpleNamespace()
        setattr(self, name, entry)
        return entry


def _c_params(lib: str) -> dict[str, list]:
    """Each ``extern "C" int`` entry point of ``csrc/<lib>.cu`` -> its
    parameters' ctypes types, read from the C declaration."""
    out = {}
    source = (CSRC / f"{lib}.cu").read_text()
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source):
        out[name] = [ctypes.c_void_p if "*" in p else ctypes.c_longlong if "long long" in p
                     else ctypes.c_int for p in (q.strip() for q in params.split(","))]
    return out


def _assert_declared(lib: str, entries) -> None:
    want = _c_params(lib)
    assert want, lib
    for name, params in want.items():
        entry = getattr(entries, name)
        assert list(entry.argtypes) == params, name
        assert entry.restype is ctypes.c_int, name


@pytest.mark.parametrize("lib", ["vqc_fused", "vqc_shiftbank", "vqc_spill", "vqc_shift_dmem"])
def test_circuit_entry_points_match_the_sources(lib):
    _assert_declared(lib, K._declare(lib, _Entries()))


@pytest.mark.parametrize("route", sorted(flash_attention._LIBS))
def test_flash_entry_points_match_the_sources(route, monkeypatch):
    entries = _Entries()
    monkeypatch.setattr(_build, "load", lambda name: entries)
    flash_attention._lib.__wrapped__(route)
    _assert_declared(flash_attention._LIBS[route][0], entries)
