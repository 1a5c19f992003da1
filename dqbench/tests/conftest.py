"""Puts the benchmark's own modules and the program on the path, and
gives a tiny copy of the benchmark that runs on the CPU."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the CPU's stand-in for each cell: its configuration and harness
#: parameters, at a batch of 4 images
TINY = {"tiny.7q": "train.7q3l.b4096"}
#: a cell without the dense layer (QuClassi's own rotation encoding), of
#: the first cell's harness parameters, at 5 qubits and one layer
NODENSE = "tiny.5q1l.nodense"


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's folder with, beside
    each cell, a CPU-sized one of the same configuration and harness
    parameters (4 images a step) that reports every metric its cell does,
    and a CPU-sized cell without the dense layer."""
    shutil.copytree(BENCH, tmp_path / "dqbench", ignore=shutil.ignore_patterns("tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for tiny, cell in TINY.items():
        entry = next(w for w in spec["workloads"] if w["name"] == cell)
        spec["workloads"].append(dict(entry, name=tiny, traffic="tiny"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if cell in m.get("workloads", ()):
                m["workloads"].append(tiny)
        shutil.copy(BENCH / "cells" / f"{cell}.json", tmp_path / "dqbench" / "cells" / f"{tiny}.json")
    first = spec["workloads"][0]
    cfg = json.loads((BENCH / "configs" / f"{first['config']}.json").read_text())
    (tmp_path / "dqbench" / "configs" / "quclassi-5q-1l-nodense.json").write_text(
        json.dumps(dict(cfg, qc=5, n_layers=1, use_dense=False)))
    spec["workloads"].append(dict(first, name=NODENSE, config="quclassi-5q-1l-nodense",
                                  traffic="tiny"))
    shutil.copy(BENCH / "cells" / f"{first['name']}.json",
                tmp_path / "dqbench" / "cells" / f"{NODENSE}.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "dqbench" / "traffic" / "tiny.json").write_text(json.dumps(
        {"loop": "closed", "tenants": 1, "batch": 4, "pool_batches": 4, "noise": 0.15}))
    return tmp_path
