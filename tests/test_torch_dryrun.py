"""The port's dry-runs (``launch/dryrun.py``, ``launch/quantum_dryrun.py``)
and op counter (``roofline/op_counter.py``) against the reference's.

The reference's dry-run modules set ``XLA_FLAGS`` to 512 host devices when
imported, so every reference number that needs them comes from ONE
subprocess; the rest (``jax.eval_shape``, ``hlo_analyzer``) runs here on
the one CPU device."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.launch import steps as rsteps
from repro.models import transformer as rtransformer
from repro.roofline import hlo_analyzer as RH
from repro_torch.configs import base
from repro_torch.core import circuits
from repro_torch.launch import dryrun, quantum_dryrun, serve, train
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.partition import tree_leaves_with_path
from repro_torch.models import loops, ssm, transformer
from repro_torch.roofline import op_counter

ROOT = Path(__file__).resolve().parents[1]
QUANTUM_CASES = ((7, 3, 1_048_576, 256), (7, 3, 1_048_576, 1), (5, 1, 4096, 1), (5, 2, 1000, 8))
#: the 8-placeholder (2, 4) mesh check: smollm-360m cut to these widths
NARROW = dict(n_layers=2, d_model=256, n_heads=4, kv_heads=2, head_dim=64, d_ff=512, vocab=512)
NARROW_SHAPES = ("train_4k", "decode_32k")

REFERENCE_SCRIPT = textwrap.dedent(f"""
    import dataclasses, json, sys
    from repro.launch import dryrun, quantum_dryrun        # sets XLA_FLAGS (512 devices)
    import jax
    from repro.configs import base
    from repro.core import circuits
    from repro.launch import partition

    def flat(tree):
        out = {{}}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out["/".join(partition._k(k) for k in path)] = [list(leaf.shape), str(leaf.dtype)]
        return out

    res = {{"cfg": {{}}, "inputs": {{}}, "traffic": [], "args": {{}}}}
    for arch in dryrun.ALL_ARCHS:
        for shape in dryrun.ALL_SHAPES:
            cfg = dryrun.cfg_for_shape(base.get(arch), base.INPUT_SHAPES[shape])
            res["cfg"][f"{{arch}}/{{shape}}"] = dataclasses.asdict(cfg)
            res["inputs"][f"{{arch}}/{{shape}}"] = flat(dryrun.input_specs(arch, shape))
    for qc, nl, c, chips in {QUANTUM_CASES!r}:
        spec = circuits.build_quclassi_circuit(qc, nl)
        res["traffic"].append([quantum_dryrun.kernel_traffic(spec, c, chips),
                               quantum_dryrun.pergate_state_traffic(spec, c, chips)])
    try:                                           # its own 16 x 16 mesh (see below)
        dryrun.lower_one("smollm-360m", "decode_32k", False, overrides={NARROW!r})
        res["own_mesh_error"] = None
    except ValueError as exc:
        res["own_mesh_error"] = str(exc)
    auto = (jax.sharding.AxisType.Auto,) * 2      # shard_hint constrains Auto axes only
    dryrun.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
        (2, 4), ("data", "model"), axis_types=auto, devices=jax.devices()[:8])
    for shape in {NARROW_SHAPES!r}:
        lowered = dryrun.lower_one("smollm-360m", shape, False, overrides={NARROW!r})[0]
        mem = lowered.compile().memory_analysis()
        res["args"][shape] = [mem.argument_size_in_bytes, mem.output_size_in_bytes]
    json.dump(res, sys.stdout)
""")


@pytest.fixture(scope="module")
def reference() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


def _flat(tree) -> dict:
    return {path: [list(leaf.shape), str(leaf.dtype).removeprefix("torch.")]
            for path, leaf in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", dryrun.ALL_ARCHS)
def test_cfg_and_input_specs_equal_reference(reference, arch):
    for shape in dryrun.ALL_SHAPES:
        key = f"{arch}/{shape}"
        cfg = dryrun.cfg_for_shape(base.get(arch), base.INPUT_SHAPES[shape])
        assert json.loads(json.dumps(dataclasses.asdict(cfg))) == reference["cfg"][key]
        assert _flat(dryrun.input_specs(arch, shape)) == reference["inputs"][key]


def test_batch_and_decode_specs_cover_every_family():
    for arch, keys in (("musicgen-large", ["codes"]), ("phi-3-vision-4.2b",
                       ["image_embeds", "tokens"]), ("smollm-360m", ["tokens"])):
        cfg = base.get(arch)
        assert sorted(dryrun.batch_specs(cfg, 2, 1024)) == sorted(keys)
        assert list(dryrun.decode_specs(cfg, 2)) == [keys[-1]]


@pytest.mark.parametrize("arch", dryrun.ALL_ARCHS)
def test_param_count_equals_reference(arch):
    rcfg = rbase.get(arch)
    shapes = jax.eval_shape(rtransformer.Model(rcfg).init_params, jax.random.PRNGKey(0))
    model = transformer.Model(base.get(arch), device="meta")
    assert transformer.param_count(model) == rtransformer.param_count(shapes)
    assert transformer.active_param_count(base.get(arch), model) == \
        rtransformer.active_param_count(rcfg, shapes)
    assert all(p.device.type == "meta" for p in model.parameters())


def test_quantum_traffic_equals_reference(reference):
    for (qc, nl, c, chips), (k, g) in zip(QUANTUM_CASES, reference["traffic"]):
        spec = circuits.build_quclassi_circuit(qc, nl)
        assert quantum_dryrun.kernel_traffic(spec, c, chips) == k
        assert quantum_dryrun.pergate_state_traffic(spec, c, chips) == g
    spec = circuits.build_quclassi_circuit(7, 3)
    assert (spec.n_qubits, spec.n_theta, spec.n_data, len(spec.ops)) == (7, 14, 6, 25)
    assert quantum_dryrun.kernel_traffic(spec, 1 << 20, 1)["bytes_per_device"] == 88_080_384
    assert quantum_dryrun.pergate_state_traffic(spec, 1 << 20, 1)["bytes_per_device"] == \
        53_687_091_200


@pytest.mark.parametrize("shape", NARROW_SHAPES)
def test_argument_bytes_on_a_2x4_mesh_equal_reference(reference, shape):
    """Per-device argument bytes from the specs == XLA's memory analysis of
    the reference's step compiled over 8 placeholders (the same
    in_shardings).  Output bytes too, but for the 8-byte pointer a leaf
    that XLA's output tuple adds (the port's outputs are no tuple)."""
    plan = dryrun.plan("smollm-360m", shape, make_mesh((2, 4), ("data", "model")), NARROW)
    want_args, want_out = reference["args"][shape]
    assert sum(plan["arguments"].values()) == want_args
    assert sum(plan["outputs"].values()) + 8 * plan["output_leaves"] == want_out


def test_reference_dryrun_rejects_its_own_production_mesh(reference, tmp_path, monkeypatch):
    """A fault of the reference under this JAX (ROADMAP Queue 3): its
    ``make_production_mesh`` builds ``jax.make_mesh``'s default Explicit
    axes, and its ``shard_hint``'s ``with_sharding_constraint`` accepts
    Auto axes only, so ``lower_one`` raises for every combination.  The
    port's dry-run of the same combination runs."""
    assert "Auto axes" in reference["own_mesh_error"]
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    rec = dryrun.run_one("smollm-360m", "decode_32k", False, verbose=False, overrides=NARROW)
    assert rec["flops_per_device"] > 0


# ------------------------------------------------------ FLOPs vs hlo_analyzer
def _ref_params(cfg):
    return jax.eval_shape(rtransformer.Model(cfg).init_params, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-4b"])
def test_prefill_matmul_flops_equal_hlo_analyzer(arch):
    """Within 1%: both count 2 * out * contraction for every matmul."""
    b, s = 2, 64
    rcfg = rbase.get(arch).reduced()
    prefill, _ = rsteps.make_prefill_step(rcfg)
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    hlo = jax.jit(prefill).lower(_ref_params(rcfg), batch).compile().as_text()
    want = RH.analyze(hlo).flops
    got = dryrun.count_step(base.get(arch).reduced(), "prefill", b, s).flops
    assert got == pytest.approx(want, rel=0.01)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-4b"])
def test_train_matmul_flops_equal_hlo_analyzer(arch):
    """Within 5%: the backward and the remat recompute are XLA's own there
    and autograd's here, and XLA may drop recomputed work it can reuse."""
    b, s = 4, 64
    rcfg = rbase.get(arch).reduced()
    step, optimizer, _ = rsteps.make_train_step(rcfg, global_batch=b)
    params = _ref_params(rcfg)
    opt = jax.eval_shape(optimizer.init, params)
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    hlo = jax.jit(step).lower(params, opt, batch).compile().as_text()
    want = RH.analyze(hlo).flops
    got = dryrun.count_step(base.get(arch).reduced(), "train", b, s).flops
    assert got == pytest.approx(want, rel=0.05)


# ----------------------------------------------------- the loop shortcuts
def _full_count(cfg, kind, b, s):
    return dryrun.count_step(cfg, kind, b, s, extrapolate=False)


@pytest.mark.parametrize("arch,kind", [("xlstm-125m", "prefill"), ("xlstm-125m", "train"),
                                       ("jamba-v0.1-52b", "prefill")])
def test_trip_count_shortcut_equals_the_full_loop(arch, kind):
    """The sLSTM step loop and the mLSTM / Mamba chunk loops counted as
    three trips (and layer periods and microbatches extrapolated) against
    every trip counted.  FLOPs equal; bytes equal in the forward and within
    1% with a backward (the gradient sums of per-step outputs that only
    distinct trips see)."""
    cfg = base.get(arch).reduced()
    b, s = 4, 128
    full = _full_count(cfg, kind, b, s)
    short = dryrun.count_step(cfg, kind, b, s)
    assert short.flops == full.flops
    if kind == "train":
        assert short.bytes == pytest.approx(full.bytes, rel=0.01)
    else:
        assert short.bytes == full.bytes


def test_slstm_backward_bytes_grow_linearly_with_length():
    """ROADMAP P6: each step's input is one piece of a single ``unbind``,
    so the backward stacks the S step gradients once.  Indexing
    ``pre_all[:, t]`` made a full-length zero-filled gradient a step and
    summed S of them: bytes quadratic in S."""
    cfg = base.get("xlstm-125m").reduced().with_(pattern=("slstm",), n_layers=1)
    by_len = {s: _full_count(cfg, "train", 2, s).bytes for s in (128, 256)}
    assert by_len[256] / by_len[128] < 2.0      # 1.87 now; 2.60 with per-step indexing


def test_trip_count_shortcut_on_a_ragged_tail_chunk():
    """Mamba's last chunk is shorter (120 = 3 x 32 + 24): the shortcut runs
    it as itself, so the count is still the full loop's."""
    cfg = base.get("jamba-v0.1-52b").reduced()
    full = _full_count(cfg, "prefill", 2, 120)
    short = dryrun.count_step(cfg, "prefill", 2, 120)
    assert (short.flops, short.bytes) == (full.flops, full.bytes)


def test_trip_loop_is_range_outside_a_counter():
    assert list(loops.trip_loop(5)) == [0, 1, 2, 3, 4]
    with op_counter.OpCounter(shortcut=True):
        assert list(loops.trip_loop(5)) == [0, 1, 4]
        assert list(loops.trip_loop(3)) == [0, 1, 2]
    with op_counter.OpCounter(shortcut=False):
        assert list(loops.trip_loop(5)) == [0, 1, 2, 3, 4]
    assert loops.expand_trips(["a", "b", "c"], 5) == ["a", "b", "b", "b", "c"]


def test_an_open_counter_leaves_other_threads_loops_whole():
    """A counter open in one thread (a dry-run beside a serving slot) does
    not shorten a real sLSTM forward in another."""
    cfg = base.get("xlstm-125m").reduced()
    params = ssm.init_slstm_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want = ssm.slstm_mixer(params, x, cfg)[0]
    opened, done = threading.Event(), threading.Event()

    def hold():
        with op_counter.OpCounter(shortcut=True):
            opened.set()
            done.wait(60)

    holder = threading.Thread(target=hold)
    holder.start()
    try:
        assert opened.wait(60)
        with torch.no_grad():
            got = ssm.slstm_mixer(params, x, cfg)[0]
    finally:
        done.set()
        holder.join()
    assert torch.equal(got, want)


def test_op_counter_counts_matmuls_and_views():
    a = torch.empty((8, 16), device="meta")
    w = torch.empty((16, 4), device="meta")
    cost, out = op_counter.count(lambda: (a @ w).T)
    assert out.shape == (4, 8) and cost.flops == 2 * 8 * 16 * 4
    assert cost.bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4    # the transpose is a view
    assert cost.ops == 2


# ------------------------------------------------------------- the launchers
def test_train_and_serve_full_config_write_records(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = train.main(["--arch", "smollm-360m"])
    assert set(rec) >= {"arch", "shape", "mesh", "chips", "lower_s", "compile_s",
                        "flops_per_device", "bytes_accessed_per_device",
                        "collective_bytes_per_device", "collectives", "raw_cost_analysis",
                        "memory", "param_count"}
    assert rec["memory"]["temp_size_bytes"] is None and rec["compile_s"] is None
    assert set(rec["collectives"]) == {"all-gather", "reduce-scatter"}
    rec = serve.main(["--arch", "smollm-360m", "--multi-pod"])
    assert (rec["shape"], rec["mesh"], rec["chips"]) == ("decode_32k", "2x16x16", 512)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "smollm-360m__decode_32k__2x16x16.json", "smollm-360m__train_4k__16x16.json"]


def test_dryrun_main_runs_a_combination(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    dryrun.main(["--arch", "granite-moe-3b-a800m", "--shape", "long_500k", "--single-pod-only"])
    assert "all 1 dry-run combos counted OK" in capsys.readouterr().out
    rec = json.loads((tmp_path / "granite-moe-3b-a800m__long_500k__16x16.json").read_text())
    assert rec["uneven_hints"]                      # batch 1 over 16 data shards


def test_quantum_dryrun_executes_both_paths_on_the_cpu(tmp_path):
    rec = quantum_dryrun.run(7, 3, 4096, verbose=False, device="cpu", out_dir=str(tmp_path))
    assert rec["executed"]["max_abs_diff"] <= quantum_dryrun.TOL
    res = rec["_results"]
    assert res["fused"].shape == res["pergate"].shape == (4096,)
    assert torch.isfinite(res["fused"]).all()
    spec = circuits.build_quclassi_circuit(7, 3)
    assert rec["fused_kernel"]["bytes_per_device"] == \
        quantum_dryrun.kernel_traffic(spec, 4096, 256)["bytes_per_device"]
    assert rec["pergate"]["flops_per_device"] > 0 and rec["chips"] == 256
    assert json.loads((tmp_path / "quantum_bank__7q3L.json").read_text())["executed"] == \
        rec["executed"]
