"""The port's virtual-clock example programs (``repro_torch.examples``)
against the reference's scripts in ``examples/``, on the CPU.

Each reference script is loaded by its path (``spec_from_file_location``
runs its imports, never its ``main``).  These programs and scenes do no
device work, so the port's standard output must equal the reference's
line for line, and ``trace_demo.json`` byte for byte.
"""
import importlib
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _ref(name: str):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name: str):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _lines(capsys) -> list[str]:
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", ["multitenant_serving", "scale_storm", "trace_demo"])
def test_program_prints_the_references_lines(name, capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # trace_demo writes trace_demo.json here
    _ref(name).main()
    want = _lines(capsys)
    out = _port(name).main(["--device", "cpu"])
    got = _lines(capsys)
    assert got == want
    assert isinstance(out, dict) and out


def test_trace_demo_json_is_byte_equal(monkeypatch, tmp_path):
    runs = {"ref": _ref("trace_demo").main,
            "port": lambda: _port("trace_demo").main(["--device", "cpu"])}
    for label, run in runs.items():
        (tmp_path / label).mkdir()
        monkeypatch.chdir(tmp_path / label)
        run()
    want = (tmp_path / "ref" / "trace_demo.json").read_bytes()
    assert (tmp_path / "port" / "trace_demo.json").read_bytes() == want


@pytest.mark.parametrize("program,scene,args", [
    ("failure_injection", "virtual_clock_demo", ()),
    ("federated_dql", "scene_2_stragglers", ("cpu",)),
    ("federated_dql", "scene_3_privacy", ()),
])
def test_scene_prints_the_references_lines(program, scene, args, capsys):
    getattr(_ref(program), scene)()
    want = _lines(capsys)
    getattr(_port(program), scene)(*args)
    assert _lines(capsys) == want


def test_returned_numbers_are_the_printed_ones(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    out = _port("trace_demo").main(["--device", "cpu"])
    lines = _lines(capsys)
    assert f"{out['records']} lifecycle records, 0 still open, 0 well-formedness violations" in lines
    assert out["records"] == out["report"].total_circuits and out["violations"] == 0
    for w, s in out["occupancy"].items():
        assert (f"{w}: {s['spans']} dispatches, busy {s['busy_s']:.1f}s, "
                f"utilization {s['utilization']:.0%}") in lines
