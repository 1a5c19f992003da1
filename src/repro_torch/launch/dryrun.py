"""Multi-pod dry-run: every (arch x input-shape x mesh) combination built
and stepped on the ``meta`` device (nothing is allocated or computed), and
recorded for the roofline.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]

Records land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json, in
the reference's schema (its dry-run writes experiments/dryrun/).  Where
the reference compiles against 256 or 512 host placeholders and reads XLA's
analyses, the port reckons each number itself:
  * per-device argument and output bytes: the leaves' shapes cut by
    ``launch.partition``'s specs (the reference's in/out shardings);
  * FLOPs and bytes: ``roofline.op_counter`` over the step on ``meta``,
    divided by the mesh's chips.  Layer periods and microbatches are
    counted as ``hlo_analyzer`` counts a scan: the step is counted at 1
    and 2 periods and at two microbatch counts, and the cost, bilinear in
    the two, is extrapolated to the config's (exact: every period and
    microbatch runs the same ops).  Bytes are eager PyTorch's, unfused:
    an upper bound beside XLA's;
  * collective bytes: what the specs force, not what a compiler would
    insert: the all-gather over ``data`` of every weight sharded there
    (per forward and per backward of each microbatch) and, in training,
    the reduce-scatter of its float32 gradient (per microbatch);
  * what needs a compiler (temporaries, code size, compile time, XLA's raw
    cost analysis, activation collectives) is null and named under
    ``not_computed``.
Activation ``shard_hint``s are checked under the mesh's binding; those
whose axes do not divide (the reference's compiler pads them) are listed
under ``uneven_hints``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import base as cfg_base
from repro_torch.launch import partition, steps
from repro_torch.launch.mesh import chips, make_production_mesh
from repro_torch.launch.partition import TensorSpec, spec_of
from repro_torch.models import blocks, transformer
from repro_torch.models.sharding import axis_binding
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.op_counter import OpCost, count

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

NOT_COMPUTED = ("compile_s", "raw_cost_analysis", "memory.temp_size_bytes",
                "memory.generated_code_size_bytes",
                "collectives of activations (tensor-parallel all-reduces, expert all-to-alls)")


# --------------------------------------------------------------- input specs
def cfg_for_shape(cfg, shape: cfg_base.InputShape):
    """Shape-conditioned config tweaks, as the reference's:

    * long_500k on pure-attention archs -> sliding-window (8192) variant —
      the sub-quadratic requirement; SSM/hybrid run native; MLA keeps its
      full compressed-latent cache (linear memory).
    * decode shapes on MoE archs keep standard capacity routing.
    """
    if shape.name == "long_500k":
        has_ssm = any(k != "attn" for k in cfg.pattern)
        if cfg.mla is None and not (has_ssm and "attn" not in cfg.pattern):
            if cfg.sliding_window == 0:
                cfg = cfg.with_(sliding_window=8192)
    return cfg


def batch_specs(cfg, batch: int, seq_len: int) -> dict:
    """The reference's batch: int32 ids (the port feeds them as int64)."""
    if cfg.n_codebooks:
        return {"codes": TensorSpec((batch, seq_len, cfg.n_codebooks), torch.int32)}
    if cfg.n_prefix_embeds:
        return {"image_embeds": TensorSpec((batch, cfg.n_prefix_embeds, cfg.prefix_embed_dim),
                                           torch.float32),
                "tokens": TensorSpec((batch, seq_len - cfg.n_prefix_embeds), torch.int32)}
    return {"tokens": TensorSpec((batch, seq_len), torch.int32)}


def decode_specs(cfg, batch: int) -> dict:
    if cfg.n_codebooks:
        return {"codes": TensorSpec((batch, 1, cfg.n_codebooks), torch.int32)}
    return {"tokens": TensorSpec((batch, 1), torch.int32)}


def _stack_specs(leaves: list) -> TensorSpec:
    return TensorSpec((len(leaves),) + leaves[0].shape, leaves[0].dtype)


def cache_specs(cfg, batch: int, capacity: int) -> list:
    """The reference's cache tree: one dict per pattern entry, each leaf
    with a leading ``n_periods`` axis."""
    dtype = getattr(torch, cfg.dtype)
    return [{k: TensorSpec((cfg.n_periods,) + tuple(v.shape), v.dtype)
             for k, v in blocks.init_block_cache(kind, cfg, batch, capacity, dtype,
                                                 "meta").items()}
            for kind in cfg.pattern]


def param_specs(cfg, model: transformer.Model) -> dict:
    """The reference's parameter tree of a ``meta`` model, as specs."""
    return transformer.params_tree(cfg, model.state_dict(), spec_of, _stack_specs)


def opt_specs(cfg, optimizer, model: transformer.Model) -> dict:
    """The reference's optimizer-state tree: the step an int32 scalar, each
    moment a float32 tree in the parameters' layout."""
    state = optimizer.init(dict(model.named_parameters()))
    return {k: (transformer.params_tree(cfg, v, spec_of, _stack_specs) if isinstance(v, dict)
                else TensorSpec((), torch.int32))
            for k, v in state.items()}


def input_specs(arch: str, shape_name: str):
    """Public entry: ``TensorSpec`` stand-ins for every model input."""
    shape = cfg_base.INPUT_SHAPES[shape_name]
    cfg = cfg_for_shape(cfg_base.get(arch), shape)
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_specs(cfg, shape.global_batch, shape.seq_len)}
    return {"batch": decode_specs(cfg, shape.global_batch),
            "caches": cache_specs(cfg, shape.global_batch, shape.seq_len),
            "pos": TensorSpec((), torch.int32)}


def _meta(tree):
    """Meta tensors for a tree of specs (ids as the port's int64)."""
    def one(_, s):
        dt = torch.long if s.dtype == torch.int32 else s.dtype
        return torch.empty(s.shape, dtype=dt, device="meta")
    return partition.tree_map_with_path(one, tree)


# ------------------------------------------------------------------ counting
def _bilinear(costs: dict, p_pts: tuple, m_pts: tuple, p: int, m: int) -> OpCost:
    """The cost at (p periods, m microbatches) from counts at the corners
    of ``p_pts`` x ``m_pts`` (one point on an axis: that axis is exact)."""
    p0, m0 = p_pts[0], m_pts[0]
    c00 = costs[p0, m0]
    dp = (costs[p_pts[1], m0] - c00) if len(p_pts) > 1 else OpCost()
    dm = (costs[p0, m_pts[1]] - c00) if len(m_pts) > 1 else OpCost()
    dpm = (costs[p_pts[1], m_pts[1]] - costs[p_pts[1], m0] - costs[p0, m_pts[1]] + c00
           if len(p_pts) > 1 and len(m_pts) > 1 else OpCost())
    return c00 + dp * (p - p0) + dm * (m - m0) + dpm * ((p - p0) * (m - m0))


def count_step(cfg, kind: str, global_batch: int, seq_len: int, *, binding: dict | None = None,
               extrapolate: bool = True) -> OpCost:
    """FLOPs / bytes / ops of one ``kind`` step ("train", "prefill" or
    "decode") of ``cfg`` on ``meta``; with ``extrapolate`` counted at 1 and
    2 periods (and two microbatch counts when training) and extrapolated,
    the SSM loops as three trips; without, every layer, microbatch and
    trip counted (the reference the tests hold the shortcuts to)."""
    n_pat, n_periods = len(cfg.pattern), cfg.n_periods
    n_micro = max(1, global_batch // max(cfg.microbatch, 1)) if kind == "train" else 1
    rows = global_batch // n_micro
    if extrapolate:
        p_pts = (1, 2) if n_periods > 1 else (1,)
        m_pts = (1,) if n_micro == 1 else (2, 3)
    else:
        p_pts, m_pts = (n_periods,), (n_micro,)
    costs = {}
    with axis_binding(**(binding or {})):
        for p in p_pts:
            c = cfg.with_(n_layers=p * n_pat)
            model = transformer.Model(c, device="meta")
            for m in m_pts:
                if kind == "train":
                    step, optimizer, _ = steps.make_train_step(c, global_batch=m * rows,
                                                               model=model)
                    state = optimizer.init(dict(model.named_parameters()))
                    batch = _meta(batch_specs(c, m * rows, seq_len))
                    costs[p, m], _ = count(step, state, batch, shortcut=extrapolate)
                elif kind == "prefill":
                    step, _ = steps.make_prefill_step(c, model=model)
                    costs[p, m], _ = count(step, _meta(batch_specs(c, global_batch, seq_len)),
                                           shortcut=extrapolate)
                else:
                    step, _ = steps.make_serve_step(c, model=model)
                    caches = model.init_caches(global_batch, seq_len)
                    batch = _meta(decode_specs(c, global_batch))
                    costs[p, m], _ = count(step, batch, caches, seq_len - 1,
                                           shortcut=extrapolate)
    return _bilinear(costs, p_pts, m_pts, n_periods, n_micro)


def _prefill_logits_spec(part, cfg, batch: int, seq_len: int) -> tuple[TensorSpec, object]:
    """The prefill's logits and their layout: ``hidden_to_logits``'s hint
    (batch over the batch axes, vocab over ``model``); audio's per-codebook
    logits by the batch rule alone."""
    dtype = getattr(torch, cfg.dtype)
    if cfg.n_codebooks:
        spec = TensorSpec((batch, seq_len, cfg.n_codebooks, cfg.vocab), dtype)
        return spec, partition.NamedSharding(part.mesh, part.batch_spec(spec.shape))
    spec = TensorSpec((batch, seq_len, cfg.vocab), dtype)
    dims = list(part.batch_spec(spec.shape))
    if cfg.vocab % part.model_n == 0:
        dims[2] = "model"
    return spec, partition.NamedSharding(part.mesh, partition.P(*dims))


def _gathered_bytes(leaf, sharding) -> int:
    """Per-device bytes of ``leaf`` all-gathered over ``data`` (its other
    axes stay cut); 0 when it is not sharded over ``data``, or ``data``
    has one device."""
    sizes = sharding.mesh.shape
    data_in = any("data" in partition.spec_axes(e) for e in sharding.spec)
    if not data_in or sizes["data"] == 1:
        return 0
    other = math.prod(sizes[a] for e in sharding.spec
                      for a in partition.spec_axes(e) if a != "data")
    return leaf.nbytes // other


def _input_shape(shape) -> cfg_base.InputShape:
    """A name of ``INPUT_SHAPES`` or an ``InputShape`` of one's own."""
    return shape if isinstance(shape, cfg_base.InputShape) else cfg_base.INPUT_SHAPES[shape]


def plan(arch: str, shape_name, mesh, overrides: dict | None = None) -> dict:
    """Shapes, shardings and per-device bytes of one combination (no step
    is run): the counterpart of the reference's ``lower_one``."""
    shape = _input_shape(shape_name)
    cfg = cfg_for_shape(cfg_base.get(arch), shape)
    if overrides:
        cfg = cfg.with_(**overrides)
    part = partition.Partitioner(mesh)
    model = transformer.Model(cfg, device="meta")
    params = param_specs(cfg, model)
    p_sh = part.param_shardings(params)
    scalar = TensorSpec((), torch.int32)
    args = {"params": partition.per_device_bytes(params, p_sh)}
    outs = {}
    n_micro = max(1, shape.global_batch // max(cfg.microbatch, 1))
    if shape.kind == "train":
        _, optimizer, _ = steps.make_train_step(cfg, global_batch=shape.global_batch, model=model)
        opt = opt_specs(cfg, optimizer, model)
        o_sh = part.opt_shardings(opt, params)
        b = batch_specs(cfg, shape.global_batch, shape.seq_len)
        args["opt_state"] = partition.per_device_bytes(opt, o_sh)
        args["batch"] = partition.per_device_bytes(b, part.batch_shardings(b))
        outs = {"params": args["params"], "opt_state": args["opt_state"],
                "loss": TensorSpec((), torch.float32).nbytes}
        n_out = len(partition.tree_leaves_with_path((params, opt))) + 1
    elif shape.kind == "prefill":
        b = batch_specs(cfg, shape.global_batch, shape.seq_len)
        args["batch"] = partition.per_device_bytes(b, part.batch_shardings(b))
        logits, l_sh = _prefill_logits_spec(part, cfg, shape.global_batch, shape.seq_len)
        outs = {"logits": l_sh.shard_bytes(logits)}
        n_out = 1
    else:
        b = decode_specs(cfg, shape.global_batch)
        caches = cache_specs(cfg, shape.global_batch, shape.seq_len)
        c_sh = part.cache_shardings(caches)
        args["batch"] = partition.per_device_bytes(b, part.batch_shardings(b))
        args["caches"] = partition.per_device_bytes(caches, c_sh)
        args["pos"] = scalar.nbytes
        v_shape = ((shape.global_batch, 1, cfg.n_codebooks, cfg.vocab) if cfg.n_codebooks
                   else (shape.global_batch, 1, cfg.vocab))
        outs = {"logits": TensorSpec(v_shape, getattr(torch, cfg.dtype)).nbytes,
                "caches": args["caches"]}
        n_out = 1 + len(partition.tree_leaves_with_path(caches))
    # the collectives the weight specs force
    gathered = sum(_gathered_bytes(leaf, sh) for leaf, sh in
                   partition.tree_zip_leaves(params, p_sh))
    coll = {}
    if gathered:
        uses = 2 * n_micro if shape.kind == "train" else 1
        coll["all-gather"] = gathered * uses
        if shape.kind == "train":
            grads = sum(sh.shard_bytes(TensorSpec(leaf.shape, torch.float32))
                        for leaf, sh in partition.tree_zip_leaves(params, p_sh)
                        if _gathered_bytes(leaf, sh))
            coll["reduce-scatter"] = grads * n_micro
    return {"cfg": cfg, "shape": shape, "model": model, "arguments": args, "outputs": outs,
            "output_leaves": n_out, "collectives": coll}


def run_one(arch: str, shape_name, multi_pod: bool, verbose: bool = True,
            overrides: dict | None = None, variant: str = "", mesh=None,
            out_dir: str | None = None) -> dict:
    """Plan and count one combination and write its record (``mesh``
    defaults to the production mesh of ``multi_pod``; ``shape_name`` may
    be an ``InputShape`` of one's own)."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(n) for n in mesh.shape.values())       # 16x16, 2x16x16
    in_shape = _input_shape(shape_name)
    tag = f"{arch}__{in_shape.name}__{mesh_name}" + (f"__{variant}" if variant else "")
    t0 = time.time()
    pl = plan(arch, in_shape, mesh, overrides)
    t_plan = time.time() - t0
    cfg, shape = pl["cfg"], pl["shape"]
    n_chips = chips(mesh)

    binding = {**partition.logical_binding(mesh), "__uneven__": []}
    t0 = time.time()
    cost = count_step(cfg, shape.kind, shape.global_batch, shape.seq_len, binding=binding)
    t_count = time.time() - t0
    uneven = sorted({f"{s} as {a}" for s, a in binding["__uneven__"]})
    coll = pl["collectives"]
    record = {
        "arch": arch, "shape": in_shape.name, "mesh": mesh_name, "chips": n_chips,
        "lower_s": round(t_plan, 1), "compile_s": None, "count_s": round(t_count, 1),
        "flops_per_device": cost.flops / n_chips,
        "bytes_accessed_per_device": cost.bytes / n_chips,
        "collective_bytes_per_device": float(sum(coll.values())),
        "collectives": {k: int(v) for k, v in coll.items()},
        "raw_cost_analysis": {"flops": None, "bytes_accessed": None,
                              "collective_bytes_body_once": None},
        "memory": {
            "argument_size_bytes": sum(pl["arguments"].values()),
            "output_size_bytes": sum(pl["outputs"].values()),
            "temp_size_bytes": None,
            "generated_code_size_bytes": None,
        },
        "param_count": transformer.param_count(pl["model"]),
        "arguments_per_device": pl["arguments"],
        "ops_counted": cost.ops,
        "counted_on": "meta (torch eager, unfused: bytes are an upper bound)",
        "collective_basis": "forced by the weight specs: the all-gather over data of each "
                            "weight sharded there, per forward and per backward of each "
                            "microbatch; in training the float32 gradient's reduce-scatter, "
                            "per microbatch",
        "uneven_hints": uneven,
        "not_computed": list(NOT_COMPUTED),
    }
    out_dir = out_dir or RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(record, f, indent=1)
    if verbose:
        terms = roofline.roofline_terms(record, roofline.H100)
        print(f"[dryrun] {tag}: counted in {t_count:.1f}s  args "
              f"{record['memory']['argument_size_bytes'] / 1e9:.2f}GB/dev  "
              f"compute {terms['compute_s'] * 1e3:.2f}ms  "
              f"memory {terms['memory_s'] * 1e3:.2f}ms  "
              f"collective {terms['collective_s'] * 1e3:.2f}ms  "
              f"-> {terms['dominant']} (H100 peaks)")
    return record


ALL_ARCHS = (
    "nemotron-4-340b", "phi-3-vision-4.2b", "granite-34b", "smollm-360m",
    "qwen3-4b", "granite-moe-3b-a800m", "musicgen-large", "xlstm-125m",
    "jamba-v0.1-52b", "deepseek-v3-671b",
)
ALL_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if (args.all or not args.arch) else (args.arch,)
    shapes = ALL_SHAPES if (args.all or not args.shape) else (args.shape,)
    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only:
        meshes = [True]
    if args.multi_pod and not args.all:
        meshes = [True]
    combos = [(a, s, m) for a in archs for s in shapes for m in meshes]

    failures = []
    for a, s, m in combos:
        mesh_name = "2x16x16" if m else "16x16"
        out = os.path.join(RESULTS_DIR, f"{a}__{s}__{mesh_name}.json")
        if args.skip_existing and os.path.exists(out):
            print(f"[dryrun] skip existing {a}__{s}__{mesh_name}")
            continue
        try:
            run_one(a, s, m)
        except Exception as e:  # noqa: BLE001 - every combination is tried
            failures.append((a, s, mesh_name, repr(e)))
            print(f"[dryrun] FAIL {a}__{s}__{mesh_name}: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(combos)} dry-run combos counted OK")


if __name__ == "__main__":
    main()
