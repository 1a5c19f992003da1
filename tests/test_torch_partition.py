"""The port's partitioning (``launch/partition.py``, ``models/sharding.py``,
``data/pipeline.shard_batch``, ``comanager/dataplane.bank_shardings``)
against the reference's, on shape-only meshes (no 512-device forcing)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.launch import partition as rpartition
from repro.models import transformer as rtransformer
from repro.optim import optimizers as ropt
from repro_torch.comanager import dataplane
from repro_torch.configs import base
from repro_torch.core import circuits
from repro_torch.data import pipeline
from repro_torch.launch import dryrun, partition, steps
from repro_torch.launch.mesh import (DeviceMesh, batch_axes, data_axis_size, make_host_mesh,
                                     make_mesh, make_production_mesh)
from repro_torch.launch.partition import P, TensorSpec
from repro_torch.models import sharding, transformer

SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}


class FakeMesh:
    """Shape-only stand-in for the reference's Partitioner (as
    tests/test_partition_mesh.py builds it)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def ref_partitioner(shape: dict):
    return rpartition.Partitioner(FakeMesh(shape))


def port_partitioner(shape: dict):
    return partition.Partitioner(make_mesh(tuple(shape.values()), tuple(shape)))


def both(shape: dict, method: str, *args):
    """(reference spec, port spec) of one call, as tuples."""
    ref = tuple(getattr(ref_partitioner(shape), method)(*args))
    port = getattr(port_partitioner(shape), method)(*args)
    assert isinstance(port, P)
    return ref, tuple(port)


# ------------------------------------- tests/test_partition_mesh.py's cases
CASES = [
    # 2-D matrices; non-divisible dims stay unsharded
    (SINGLE, "param_spec", ("lm_head", (1024, 4096)), ("data", "model")),
    (SINGLE, "param_spec", ("lm_head", (1000, 4096)), (None, "model")),
    (SINGLE, "param_spec", ("lm_head", (1024, 100)), ("data", None)),
    # embeddings are vocab-parallel
    (SINGLE, "param_spec", ("embed", (49152, 960)), ("model", "data")),
    # blocks carry the period axis
    (SINGLE, "param_spec", ("blocks/0/mixer/wq", (12, 960, 960)), (None, "data", "model")),
    # experts: E=48 divides 16 (expert parallel), E=40 does not
    (SINGLE, "param_spec", ("blocks/0/ffn/experts/w_in", (12, 48, 1536, 512)),
     (None, "model", "data", None)),
    (SINGLE, "param_spec", ("blocks/0/ffn/experts/w_in", (12, 40, 1536, 512)),
     (None, None, "data", None)),
    # vectors and scalars replicate
    (SINGLE, "param_spec", ("final_norm", (960,)), (None,)),
    (SINGLE, "param_spec", ("opt/step", ()), ()),
    # batches
    (SINGLE, "batch_spec", ((256, 4096),), ("data", None)),
    (MULTI, "batch_spec", ((256, 4096),), (("pod", "data"), None)),
    (MULTI, "batch_spec", ((1, 4096),), (None, None)),
    # caches: batch over data and T over model; batch 1 -> context parallel
    (SINGLE, "cache_spec", ("blocks/0/k", (12, 128, 32768, 8, 64)),
     (None, "data", "model", None, None)),
    (SINGLE, "cache_spec", ("blocks/0/k", (12, 1, 524288, 8, 64)),
     (None, None, ("data", "model"), None, None)),
]


@pytest.mark.parametrize("mesh_shape,method,args,want", CASES,
                         ids=[f"{c[1]}-{c[2][0]}-{i}" for i, c in enumerate(CASES)])
def test_partition_mesh_cases_match_reference(mesh_shape, method, args, want):
    ref, port = both(mesh_shape, method, *args)
    assert ref == port == want


def test_param_spec_always_valid_matches_reference():
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, strategies as st

    @given(rows=st.sampled_from([1, 2, 8, 64, 100, 256, 4096]),
           cols=st.sampled_from([1, 60, 128, 960, 2560, 49152]),
           path=st.sampled_from(["w", "embed", "blocks/0/mixer/wq", "blocks/1/ffn/experts/w_in"]),
           multi=st.booleans())
    def check(rows, cols, path, multi):
        shape = (4, rows, cols) if path.startswith("blocks/") else (rows, cols)
        mesh_shape = MULTI if multi else SINGLE
        ref, port = both(mesh_shape, "param_spec", path, shape)
        assert ref == port
        for dim, ax in zip(shape, port):
            for a in partition.spec_axes(ax):
                assert dim % mesh_shape[a] == 0

    assert hypothesis is not None
    check()


def test_host_mesh_and_axes():
    mesh = make_host_mesh("cpu")
    assert batch_axes(mesh) == ("data",) and data_axis_size(mesh) == 1
    assert batch_axes(make_production_mesh(multi_pod=True)) == ("pod", "data")
    assert data_axis_size(make_production_mesh(multi_pod=True)) == 32


def test_opt_shardings_mirror_params():
    part = port_partitioner(SINGLE)
    params = {"w": TensorSpec((1024, 4096), torch.float32)}
    opt = {"m": {"w": TensorSpec((1024, 4096), torch.float32)},
           "step": TensorSpec((), torch.int32)}
    shard = part.opt_shardings(opt, params)
    assert shard["m"]["w"].spec == part.param_spec("w", (1024, 4096))
    assert shard["step"].spec == P()


def test_logical_binding_matches_reference():
    for shape in (SINGLE, MULTI):
        ref = rpartition.logical_binding(FakeMesh(shape))
        port = partition.logical_binding(make_mesh(tuple(shape.values()), tuple(shape)))
        assert {k: v for k, v in ref.items() if k != "__mesh__"} == \
            {k: v for k, v in port.items() if k != "__mesh__"}


# ------------------------------- every parameter leaf of every architecture
def _ref_paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(rpartition._k(k) for k in path): leaf for path, leaf in flat}


@pytest.fixture(scope="module")
def trees():
    """Per arch: the reference's parameter / optimizer trees from
    ``jax.eval_shape`` and the port's from its ``meta`` model."""
    out = {}

    def get(arch):
        if arch not in out:
            rcfg = rbase.get(arch)
            rparams = jax.eval_shape(rtransformer.Model(rcfg).init_params, jax.random.PRNGKey(0))
            ropt_state = jax.eval_shape(ropt.make(rcfg.optimizer, rcfg.learning_rate).init,
                                        rparams)
            cfg = base.get(arch)
            model = transformer.Model(cfg, device="meta")
            _, optimizer, _ = steps.make_train_step(cfg, global_batch=256, model=model)
            out[arch] = (rparams, ropt_state, dryrun.param_specs(cfg, model),
                         dryrun.opt_specs(cfg, optimizer, model))
        return out[arch]
    return get


def _spec_dict(tree, shardings) -> dict:
    return {path: tuple(sh.spec) for (path, _), (_, sh) in
            zip(partition.tree_leaves_with_path(tree), partition.tree_leaves_with_path(shardings))}


@pytest.mark.parametrize("arch", dryrun.ALL_ARCHS)
def test_param_and_opt_specs_equal_reference_full_width(arch, trees, monkeypatch):
    rparams, ropt_state, params, opt = trees(arch)
    r_flat = _ref_paths(rparams)
    p_flat = dict(partition.tree_leaves_with_path(params))
    assert {k: tuple(v.shape) for k, v in r_flat.items()} == \
        {k: tuple(v.shape) for k, v in p_flat.items()}
    assert {k: str(v.dtype) for k, v in r_flat.items()} == \
        {k: str(v.dtype).removeprefix("torch.") for k, v in p_flat.items()}
    # the reference's NamedShardings over a shape-only mesh: keep their specs
    monkeypatch.setattr(rpartition, "NamedSharding", lambda mesh, spec: spec)
    for shape in (SINGLE, MULTI):
        ref_part, part = ref_partitioner(shape), port_partitioner(shape)
        want = {k: tuple(s) for k, s in _ref_paths(ref_part.param_shardings(rparams)).items()}
        assert _spec_dict(params, part.param_shardings(params)) == want
        want_opt = {k: tuple(s) for k, s in
                    _ref_paths(ref_part.opt_shardings(ropt_state, rparams)).items()}
        assert _spec_dict(opt, part.opt_shardings(opt, params)) == want_opt


@pytest.mark.parametrize("arch", dryrun.ALL_ARCHS)
def test_cache_specs_equal_reference(arch, monkeypatch):
    monkeypatch.setattr(rpartition, "NamedSharding", lambda mesh, spec: spec)
    for shape_name in ("decode_32k", "long_500k"):
        shape = base.INPUT_SHAPES[shape_name]
        rcfg = dryrun.cfg_for_shape(rbase.get(arch), shape)
        rcaches = jax.eval_shape(lambda: rtransformer.Model(rcfg).init_caches(
            shape.global_batch, shape.seq_len))
        caches = dryrun.input_specs(arch, shape_name)["caches"]
        for mesh_shape in (SINGLE, MULTI):
            want = {k: tuple(s) for k, s in
                    _ref_paths(ref_partitioner(mesh_shape).cache_shardings(rcaches)).items()}
            part = port_partitioner(mesh_shape)
            assert _spec_dict(caches, part.cache_shardings(caches)) == want
            for path, leaf in partition.tree_leaves_with_path(caches):
                assert tuple(part.cache_spec(path, leaf.shape)) == want[path]


# ------------------------------------------- placement on a DeviceMesh
@pytest.mark.parametrize("n_shards", [1, 3])
def test_shard_batch_cuts_rows_over_data(n_shards):
    mesh = DeviceMesh((torch.device("cpu"),) * n_shards)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 100, (7, 5), dtype=np.int32),
             "w": rng.standard_normal(7).astype(np.float32)}
    placed = pipeline.shard_batch(batch, mesh)
    per = -(-7 // n_shards)
    for key, arr in batch.items():
        s = placed[key]
        assert isinstance(s, partition.Sharded) and s.size == 7 and s.dim == 0
        assert [p.shape[0] for p in s.pieces] == [per] * n_shards
        padded = torch.cat(s.pieces)
        np.testing.assert_array_equal(padded[:7].numpy(), arr)
        assert not padded[7:].any()                   # zero padding at the end
    # the reference's placement on its one-device host mesh holds the same rows
    from repro.data import pipeline as rpipeline
    from repro.launch.mesh import make_host_mesh as rhost
    ref = rpipeline.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, rhost())
    for key in batch:
        np.testing.assert_array_equal(np.asarray(ref[key]),
                                      torch.cat(placed[key].pieces)[:7].numpy())


@pytest.mark.parametrize("n_shards", [1, 3])
def test_bank_shardings_feed_sharded_executor(n_shards):
    from repro.comanager import dataplane as rdataplane
    mesh = DeviceMesh((torch.device("cpu"),) * n_shards)
    spec = circuits.build_quclassi_circuit(5, 1)
    rng = np.random.default_rng(1)
    c = 10
    theta = torch.from_numpy(rng.uniform(-np.pi, np.pi, (c, spec.n_theta)).astype(np.float32))
    data = torch.from_numpy(rng.uniform(-np.pi, np.pi, (c, spec.n_data)).astype(np.float32))
    t_sh, d_sh = dataplane.bank_shardings(mesh)
    r_sh = rdataplane.bank_shardings(jax.make_mesh((1, 1), ("data", "model")))
    assert tuple(t_sh.spec) == tuple(r_sh[0].spec) == ("data", None)
    placed_t, placed_d = t_sh.place(theta), d_sh.place(data)
    run = dataplane.sharded_executor(spec, mesh)
    got = run(placed_t, placed_d)
    want = dataplane.worker_batched_executor(spec, [i % 2 for i in range(c)], 2)(theta, data)
    assert torch.equal(got, want)
    assert torch.equal(run(theta, data), want)        # placed inside: the same bits


def test_named_sharding_needs_devices_to_place():
    sh = partition.NamedSharding(make_production_mesh(), P("data", None))
    assert sh.shard_shape((256, 960)) == (16, 960)
    assert sh.shard_bytes(TensorSpec((256, 960), torch.bfloat16)) == 16 * 960 * 2
    with pytest.raises(TypeError, match="no devices"):
        sh.place(torch.zeros(4, 4))


# ----------------------------------------------------------- shard_hint
def test_shard_hint_identity_unbound_and_checks_under_binding():
    x = torch.zeros(6, 4, 32)
    assert sharding.shard_hint(x, "batch", None, "model") is x
    mesh = make_production_mesh()
    with sharding.axis_binding(**partition.logical_binding(mesh)):
        y = torch.zeros(32, 4, 64)
        assert sharding.shard_hint(y, "batch", None, "model") is y
        with pytest.raises(ValueError, match="not divisible"):
            sharding.shard_hint(x, "batch", None, None)
        with pytest.raises(ValueError, match="not divisible"):
            sharding.shard_hint(torch.zeros(32, 4, 24), "batch", None, "model")
    uneven = []
    with sharding.axis_binding(**partition.logical_binding(mesh), __uneven__=uneven):
        assert sharding.shard_hint(x, "batch", None, None) is x
    assert uneven == [((6, 4, 32), ("batch", None, None))]


def test_model_runs_unchanged_under_a_binding():
    cfg = base.get("smollm-360m").reduced()
    model = transformer.Model(cfg, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 8),
                                     generator=torch.Generator().manual_seed(0))}
    want, _ = model.prefill(batch)
    mesh = make_mesh((2, 2), ("data", "model"))
    with sharding.axis_binding(**partition.logical_binding(mesh)):
        got, _ = model.prefill(batch)
    assert torch.equal(got, want)
