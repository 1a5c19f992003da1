"""The kernel build keeps the compiler's report beside each library, so a
reused library still shows its register and spill use (``chip_smoke.py``
fails when a kernel it gates has no report or spills).  On the CPU, with a
stand-in for ``nvcc`` that writes the library and prints a ptxas report."""
import stat
import sys

import pytest

from repro_torch.kernels import _build

REPORT = ("ptxas info    : Function properties for _ZN3vqc15fidelity_kernelEv\n"
          "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n")


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "open(args[args.index('-o') + 1], 'wb').write(b'lib')\n"
        f"sys.stdout.write({REPORT!r})\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return script


def test_reused_library_reports_its_build(fake_nvcc):
    first = _build.build(("vqc_fused",))["vqc_fused"]
    assert first["log"] == REPORT and first["seconds"] > 0.0
    lib = _build.library_path("vqc_fused")
    assert lib.read_bytes() == b"lib"
    assert _build.report_path(lib).read_text() == REPORT
    assert not list(lib.parent.glob("*.tmp*"))
    again = _build.build(("vqc_fused",))["vqc_fused"]
    assert again == {"path": str(lib), "seconds": 0.0, "log": REPORT}


def test_reused_library_without_report_has_empty_log(fake_nvcc):
    _build.build(("vqc_spill",))
    lib = _build.library_path("vqc_spill")
    _build.report_path(lib).unlink()
    assert _build.build(("vqc_spill",))["vqc_spill"]["log"] == ""
