"""The port's copies of the reference's roofline analyzers give the
reference's results on the same HLO text and records (the same Python over
the same strings: equal, not close), and its hardware constants."""
import dataclasses
import gzip
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.roofline import analysis as ranalysis
from repro.roofline import hlo_analyzer as RH
from repro.roofline import profile_hlo as rprofile
from repro.roofline import reanalyze as rreanalyze
from repro.roofline import report as rreport
from repro_torch.roofline import analysis, hlo_analyzer as H, profile_hlo, reanalyze, report


def compile_text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _scan(x, ws):
    def body(c, w):
        return c @ w, 0
    return jax.lax.scan(body, x, ws)[0]


def _nested(x, ws):
    def inner(c, w):
        return c @ w, 0

    def outer(c, _):
        return jax.lax.scan(inner, c, ws)[0], 0
    return jax.lax.scan(outer, x, jnp.arange(3))[0]


def _sharded_scan(x):
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1), ("d",))

    def body(c, _):
        s = jax.lax.with_sharding_constraint(c, NamedSharding(mesh, P("d")))
        return s * 1.0001, 0
    return jax.lax.scan(body, x, jnp.arange(5))[0]


#: the modules of tests/test_hlo_analyzer.py, plus a hand-written one with
#: collectives (a one-device CPU compile has none)
COLLECTIVE_HLO = """HloModule coll
ENTRY %main (p0: bf16[8,4096,1152]) -> bf16[8,4096,1152] {
  %p0 = bf16[8,4096,1152]{2,1,0} parameter(0)
  %all-gather.5 = bf16[8,4096,1152]{2,1,0} all-gather(bf16[8,4096,1152]{2,1,0} %p0), dimensions={0}
  %all-reduce.2 = (f32[4,4]{1,0}, s32[2]{0}) all-reduce(%p0), to_apply=%add
  ROOT %reduce-scatter.1 = bf16[8,4096,1152]{2,1,0} reduce-scatter(%all-gather.5), dimensions={0}
}
"""


@pytest.fixture(scope="module")
def modules() -> dict:
    f32 = jnp.float32
    return {
        "matmul": compile_text(lambda a, b: a @ b, jnp.ones((128, 256), f32),
                               jnp.ones((256, 64), f32)),
        "scan": compile_text(_scan, jnp.ones((128, 128), f32), jnp.ones((10, 128, 128), f32)),
        "nested": compile_text(_nested, jnp.ones((64, 64), f32), jnp.ones((4, 64, 64), f32)),
        "elementwise": compile_text(lambda a: a + 1.0, jnp.ones((1024, 1024), f32)),
        "dot_general": compile_text(lambda a, b: jnp.einsum("bik,bkj->bij", a, b),
                                    jnp.ones((8, 32, 16), f32), jnp.ones((8, 16, 64), f32)),
        "sharded_scan": compile_text(_sharded_scan, jnp.ones((8, 128), f32)),
        "reduce": compile_text(lambda a: (a @ a).sum(), jnp.ones((32, 32), f32)),
        "collectives": COLLECTIVE_HLO,
    }


NAMES = ("matmul", "scan", "nested", "elementwise", "dot_general", "sharded_scan", "reduce",
         "collectives")


@pytest.mark.parametrize("name", NAMES)
def test_analyze_equals_reference(modules, name):
    want, got = RH.analyze(modules[name]), H.analyze(modules[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "scan":
        assert got.flops == pytest.approx(10 * 2 * 128 ** 3, rel=0.05)


@pytest.mark.parametrize("name", NAMES)
def test_parse_and_collective_bytes_equal_reference(modules, name):
    hlo = modules[name]
    assert analysis.collective_bytes(hlo) == ranalysis.collective_bytes(hlo)
    want, got = RH.parse_module(hlo), H.parse_module(hlo)
    assert sorted(got) == sorted(want)
    for comp in want:
        assert got[comp].root == want[comp].root
        assert [dataclasses.astuple(i) for i in got[comp].instrs.values()] == \
            [dataclasses.astuple(i) for i in want[comp].instrs.values()]
    if name == "collectives":
        by_kind = analysis.collective_bytes(hlo)["by_kind"]
        assert by_kind["all-gather"] == 8 * 4096 * 1152 * 2
        assert by_kind["all-reduce"] == 4 * 4 * 4 + 2 * 4


@pytest.mark.parametrize("name", [n for n in NAMES if n != "collectives"])
def test_instruction_costs_equal_reference(modules, name):
    def rows(mod):
        return [(fl, by, co, m, comp, inst.name, inst.opcode)
                for fl, by, co, m, comp, inst in mod.instruction_costs(modules[name])]
    assert rows(profile_hlo) == rows(rprofile)


def test_shape_helpers_equal_reference():
    for s in ("f32[128,256]", "bf16[8,4096,1152]{2,1,0}", "(f32[4], s32[2])", "pred[]",
              "(bf16[2,3]{1,0}, /*index=1*/u8[7])"):
        assert H.shape_bytes(s) == RH.shape_bytes(s)
        assert H.shape_dims(s) == RH.shape_dims(s)


RECORD = {"flops_per_device": 3.1e14, "bytes_accessed_per_device": 2.2e11,
          "collective_bytes_per_device": 4.5e9}


def test_roofline_terms_reference_default_and_h100():
    assert analysis.roofline_terms(RECORD) == ranalysis.roofline_terms(RECORD)
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW) == \
        (ranalysis.PEAK_FLOPS, ranalysis.HBM_BW, ranalysis.ICI_BW)
    h = analysis.roofline_terms(RECORD, analysis.H100)
    assert h["compute_s"] == 3.1e14 / 989e12
    assert h["memory_s"] == 2.2e11 / 3.35e12
    assert h["collective_s"] == 4.5e9 / 450e9
    assert h["dominant"] == "compute" and analysis.H100.peak_f32_flops == 67e12
    for kind in ("train", "prefill"):
        assert analysis.model_flops(360_000_000, 4096, kind) == \
            ranalysis.model_flops(360_000_000, 4096, kind)
    assert analysis.useful_compute_ratio(RECORD, 10 ** 9, 10 ** 5, "train", 256) == \
        ranalysis.useful_compute_ratio(RECORD, 10 ** 9, 10 ** 5, "train", 256)


def _write_records(directory, modules):
    """Two records in the reference's schema, each with its ``.hlo.gz``."""
    directory.mkdir()
    for arch, mod in (("smollm-360m", "scan"), ("qwen3-4b", "nested")):
        rec = {"arch": arch, "shape": "train_4k", "mesh": "16x16", "chips": 256,
               "flops_per_device": 1.0, "bytes_accessed_per_device": 2.0,
               "collective_bytes_per_device": 3.0, "collectives": {},
               "memory": {"argument_size_bytes": 10, "output_size_bytes": 11,
                          "temp_size_bytes": 2.5e9, "generated_code_size_bytes": 12}}
        tag = f"{arch}__train_4k__16x16"
        (directory / f"{tag}.json").write_text(json.dumps(rec))
        with gzip.open(directory / f"{tag}.hlo.gz", "wt") as f:
            f.write(modules[mod])


def test_reanalyze_and_report_equal_reference(modules, tmp_path, monkeypatch):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    _write_records(ref_dir, modules)
    shutil.copytree(ref_dir, port_dir)
    monkeypatch.setattr(rreanalyze, "DRYRUN_DIR", str(ref_dir))
    monkeypatch.setattr(reanalyze, "DRYRUN_DIR", str(port_dir))
    assert reanalyze.reanalyze("16x16") == rreanalyze.reanalyze("16x16") == 2
    for path in sorted(ref_dir.glob("*.json")):
        got = json.loads((port_dir / path.name).read_text())
        assert got == json.loads(path.read_text())
        assert got["flops_per_device"] != 1.0            # refreshed from the module
    monkeypatch.setattr(rreport, "DRYRUN_DIR", str(ref_dir))
    monkeypatch.setattr(report, "DRYRUN_DIR", str(port_dir))
    assert report.rows("16x16") == rreport.rows("16x16")
    assert report.rows("16x16", hw=analysis.H100)[0]["compute_ms"] != \
        report.rows("16x16")[0]["compute_ms"]


def test_report_reads_the_ports_records(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(report, "DRYRUN_DIR", str(tmp_path))
    rec = dryrun.run_one("smollm-360m", "decode_32k", multi_pod=False, verbose=False)
    (row,) = report.rows("16x16")
    assert row["hbm_gb_per_dev"] is None                   # needs a compiler: not computed
    assert "memory.temp_size_bytes" in rec["not_computed"]
    assert row["useful_ratio"] == pytest.approx(
        analysis.model_flops(rec["param_count"], 128, "decode") / (rec["flops_per_device"] * 256))
    report.main(["--md", "--hw", "h100"])
    assert "| smollm-360m | decode_32k |" in capsys.readouterr().out
