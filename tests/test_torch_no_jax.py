"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and ``phase12_probe.py`` never
import JAX or the JAX package ``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    mods = list(_modules())
    for sentinel in ("repro_torch.core.trainer", "repro_torch.kernels.ops",
                     "repro_torch.models.transformer", "repro_torch.launch.serve",
                     "repro_torch.launch.mesh", "repro_torch.obs", "repro_torch.obs.trace",
                     "repro_torch.serve", "repro_torch.serve.async_dispatcher",
                     "repro_torch.serve.dispatcher", "repro_torch.serve.gateway",
                     "repro_torch.comanager.manager", "repro_torch.comanager.faults",
                     "repro_torch.comanager.tenancy", "repro_torch.comanager.worker",
                     "repro_torch.api", "repro_torch.api.cluster",
                     "repro_torch.comanager.simulation", "repro_torch.federated",
                     "repro_torch.scale", "repro_torch.checkpoint.checkpoint",
                     "repro_torch.models.moe", "repro_torch.models.ssm",
                     "repro_torch.models.multimodal", "repro_torch.optim.schedules",
                     "repro_torch.launch.train", "repro_torch.launch.partition",
                     "repro_torch.launch.dryrun", "repro_torch.launch.quantum_dryrun",
                     "repro_torch.models.sharding", "repro_torch.models.loops",
                     "repro_torch.roofline",
                     "repro_torch.roofline.analysis", "repro_torch.roofline.hlo_analyzer",
                     "repro_torch.roofline.profile_hlo", "repro_torch.roofline.reanalyze",
                     "repro_torch.roofline.report", "repro_torch.roofline.op_counter"):
        assert sentinel in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules"
        " if sys.modules[k] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_or_reference_imports_in_source():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro[.\s])", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "phase12_probe.py"]
    hits = []
    for path in files:
        for m in pattern.finditer(path.read_text()):
            line = m.group(0).strip()
            if not line.startswith(("import repro_torch", "from repro_torch")):
                hits.append(f"{path.relative_to(ROOT)}: {line}")
    assert not hits, hits
