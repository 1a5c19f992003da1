"""The port's CUDA kernels on a GPU: each against its plain PyTorch version.

Marked ``requires_cuda``: each test skips (inside its fixture, never at
import) on a host without a CUDA device.  This file imports no JAX, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cfg_base
from repro_torch.core import circuits, quclassi, trainer
from repro_torch.data import mnist
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import ops
from repro_torch.kernels import vqc_statevector as K
from repro_torch.models import multimodal, transformer

pytestmark = pytest.mark.requires_cuda
ATOL = 1e-5  # float32: other cos/sin and summation order than the plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _angles(spec, c, device, seed=0):
    rng = np.random.default_rng(seed)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, (c, spec.n_theta)), dtype=torch.float32)
    dt = torch.tensor(rng.uniform(0, np.pi, (c, spec.n_data)), dtype=torch.float32)
    return th.to(device), dt.to(device)


@pytest.mark.parametrize("qc,nl,tied", [(3, 1, False), (5, 2, False), (7, 3, True)])
@pytest.mark.parametrize("c", [1, 33, 300])
def test_fused_kernels_match_plain(cuda, qc, nl, tied, c):
    build = circuits.build_tied_quclassi_circuit if tied else circuits.build_quclassi_circuit
    spec = build(qc, nl)
    th, dt = _angles(spec, c, cuda, seed=c)
    before = dict(K.LAUNCHES)
    p0 = K.vqc_p0(spec, th, dt)
    re, im = K.vqc_state(spec, th, dt)
    assert K.LAUNCHES["fidelity"] == before["fidelity"] + 1
    assert K.LAUNCHES["state"] == before["state"] + 1
    torch.testing.assert_close(p0, K._fused_plain(spec, th, dt, False), rtol=0, atol=ATOL)
    pre, pim = K._fused_plain(spec, th, dt, True)
    torch.testing.assert_close(re, pre, rtol=0, atol=ATOL)
    torch.testing.assert_close(im, pim, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [10, 12, 14])
def test_state_kernel_wide(cuda, n):
    """The state kernel on the fidelity kernel's warp geometry, at widths
    its one-thread predecessor refused (from 10 qubits): a QuClassi
    circuit on n - 1 qubits with one idle least significant qubit."""
    base = circuits.build_quclassi_circuit(n - 1, 1)
    spec = dataclasses.replace(base, n_qubits=n)
    assert K.fused_geometry(n, 33)[0] > 0
    th, dt = _angles(spec, 33, cuda, seed=n)
    before = K.LAUNCHES["state"]
    re, im = K.vqc_state(spec, th, dt)
    assert K.LAUNCHES["state"] == before + 1
    pre, pim = K._fused_plain(spec, th, dt, True)
    torch.testing.assert_close(re, pre, rtol=0, atol=ATOL)
    torch.testing.assert_close(im, pim, rtol=0, atol=ATOL)


@pytest.mark.parametrize("qc,nl", [(3, 1), (5, 2), (7, 3), (11, 1)])
@pytest.mark.parametrize("c", [1, 33, 300, 1061])  # 1061: the last block ragged
def test_fidelity_warp_kernel_matches_plain(cuda, qc, nl, c):
    """The warp-per-circuit fidelity kernel, narrow circuits (idle lanes)
    and 11 qubits (2**10 pairs a gate, beyond the one-thread kernel's
    limit) included."""
    spec = circuits.build_quclassi_circuit(qc, nl)
    warps, smem = K.fused_geometry(qc, c)
    assert warps > 0 and smem <= K.SMEM_BUDGET_BYTES
    if c == 1061:
        assert c % warps
    th, dt = _angles(spec, c, cuda, seed=c + qc)
    before = K.LAUNCHES["fidelity"]
    got = K.vqc_p0(spec, th, dt)
    assert K.LAUNCHES["fidelity"] == before + 1
    want = K._fused_plain(spec, th, dt, False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("qc,nl,tied", [(5, 1, False), (7, 3, False), (7, 3, True)])
@pytest.mark.parametrize("four", [False, True])
def test_shiftbank_kernel_matches_plain(cuda, qc, nl, tied, four):
    build = circuits.build_tied_quclassi_circuit if tied else circuits.build_quclassi_circuit
    spec = build(qc, nl)
    plan = K.build_shift_plan(spec)
    shifts = K.shift_values(four)
    n_groups = 1 + len(shifts) * spec.n_theta
    th, dt = _angles(spec, 77, cuda, seed=qc)
    for groups in (tuple(range(n_groups)), tuple(range(n_groups - 1, 0, -3)), (0,)):
        before = K.LAUNCHES["shiftbank"]
        got = K.vqc_shift_fidelity(spec, th, dt, four_term=four, groups=groups)
        assert K.LAUNCHES["shiftbank"] == before + 1
        want = K._shiftbank_plain(plan, shifts, groups, spec.n_theta, th, dt)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_multibank_lane_identity_on_card(cuda):
    spec = circuits.build_quclassi_circuit(7, 3)
    banks = [_angles(spec, b, cuda, seed=b) for b in (5, 64, 130)]
    outs = ops.vqc_fidelity_shiftgroups_multibank(
        spec, tuple(t for t, _ in banks), tuple(d for _, d in banks), False,
        ((0, 1), tuple(range(29)), (28,)))
    for (t, d), gs, out in zip(banks, ((0, 1), tuple(range(29)), (28,)), outs):
        assert torch.equal(out, ops.vqc_fidelity_shiftgroups(spec, t, d, False, gs))


def _spill_budget(spec, four, groups, n_ckpt):
    """A budget under which the single sweep cannot hold one sample and the
    spill pair must tile: the staged tables and, for one sample, n_ckpt
    checkpoints and 4 live states."""
    plan = K.build_shift_plan(spec)
    n_variants = K._walk_table(spec, four, groups, K.SMEM_BUDGET_BYTES, False).n_variants
    return K.walk_table_bytes(plan, n_variants) + (n_ckpt + 4) * K._state_bytes(plan.m, 1)


@pytest.mark.parametrize("qc,nl,tied,budget_ckpts", [
    (13, 3, False, None),   # m = 6: one tile of 4 samples at 227 KB
    (17, 1, False, None),   # m = 8
    (17, 3, False, None),   # 2 tiles
    (19, 1, False, None),   # m = 9: refused by the one-thread forward kernel
    (7, 3, True, 3),        # forced budget: multi-use replay spans tile
    (5, 3, True, 2),
])
@pytest.mark.parametrize("four", [False, True])
def test_spill_kernels_match_plain(cuda, qc, nl, tied, budget_ckpts, four):
    """The spill pair launched directly (whichever route the request would
    take), against the plain pair over the same tiles."""
    build = circuits.build_tied_quclassi_circuit if tied else circuits.build_quclassi_circuit
    spec = build(qc, nl)
    plan = K.build_shift_plan(spec)
    shifts = K.shift_values(four)
    n_groups = 1 + len(shifts) * spec.n_theta
    th, dt = _angles(spec, 100, cuda, seed=qc + nl)
    for groups in (tuple(range(n_groups)), tuple(range(1, n_groups, 2))):
        budget = (K.SMEM_BUDGET_BYTES if budget_ckpts is None
                  else _spill_budget(spec, four, groups, budget_ckpts))
        tab = K._walk_table(spec, four, groups, budget, True)
        assert tab.tb > 0 and tab.smem_bytes <= K.SMEM_BUDGET_BYTES
        if budget_ckpts is not None:
            info = K.shift_execution_info(spec, 100, four_term=four, groups=groups,
                                          smem_budget=budget)
            assert info["mode"] == "spill" and info["n_tiles"] >= 2
        before = dict(K.LAUNCHES)
        got = K._shift_spilled_cuda(tab, th, dt)
        assert K.LAUNCHES["shift_forward"] == before["shift_forward"] + 1
        assert K.LAUNCHES["shift_tile"] == before["shift_tile"] + 1
        want = K._shift_spilled_plain(plan, shifts, groups, spec.n_theta, tab.tiles, th, dt)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("four", [False, True])
def test_shift_routes_match_plain_at_13q(cuda, four):
    """13q-3l, both workers' groups of 2 and all groups: the single sweep
    (the route the plan takes) and the spill pair, each against its plain
    version; the two routes apply the same gates with the same arithmetic,
    so they agree bit for bit."""
    spec = circuits.build_quclassi_circuit(13, 3)
    plan = K.build_shift_plan(spec)
    shifts = K.shift_values(four)
    n_groups = 1 + len(shifts) * spec.n_theta
    th, dt = _angles(spec, 576, cuda, seed=13)
    for groups in (tuple(range(0, n_groups, 2)), tuple(range(1, n_groups, 2)),
                   tuple(range(n_groups))):
        sweep = K._walk_table(spec, four, groups, K.SMEM_BUDGET_BYTES, False)
        spill = K._walk_table(spec, four, groups, K.SMEM_BUDGET_BYTES, True)
        assert K._shift_route(spec, four, groups, K.SMEM_BUDGET_BYTES) is sweep
        before = dict(K.LAUNCHES)
        got_sweep = K._shiftbank_cuda(sweep, th, dt)
        got_spill = K._shift_spilled_cuda(spill, th, dt)
        assert K.LAUNCHES["shiftbank"] == before["shiftbank"] + 1
        assert K.LAUNCHES["shift_tile"] == before["shift_tile"] + 1
        want = K._shiftbank_plain(plan, shifts, groups, spec.n_theta, th, dt)
        torch.testing.assert_close(got_sweep, want, rtol=0, atol=ATOL)
        torch.testing.assert_close(got_spill, want, rtol=0, atol=ATOL)
        assert torch.equal(got_sweep, got_spill)


@pytest.mark.parametrize("route", ["fused", "spill"])
def test_spilled_multibank_bit_identical_on_card(cuda, route):
    """13q-3l on each route: banks packed into one launch equal per-bank
    launches bit for bit (a sample's result never depends on its warp's
    place in the launch).  The banks ask for different groups, so the
    union launch holds other checkpoints (and, spilled under a forced
    budget, cuts other depth tiles) than some per-bank launches: a
    checkpoint reached through another tile start has the same bits."""
    spec = circuits.build_quclassi_circuit(13, 3)
    n_groups = 1 + 2 * spec.n_theta
    group_sets = (tuple(range(0, n_groups, 2)), tuple(range(1, n_groups, 2)),
                  tuple(range(0, n_groups, 3)))
    sizes = (5, 100, 333)
    union = tuple(sorted(set().union(*group_sets)))
    budget = (K.SMEM_BUDGET_BYTES if route == "fused"
              else _spill_budget(spec, False, union, 8))
    infos = [K.shift_execution_info(spec, b, groups=gs, smem_budget=budget)
             for b, gs in zip(sizes, (*group_sets, union))]
    assert all(i["mode"] == route for i in infos)
    if route == "spill":
        assert any(i["tiles"] != infos[-1]["tiles"] for i in infos[:-1])
    banks = [_angles(spec, b, cuda, seed=b) for b in sizes]
    theta, data, segments = ops._pack_banks(tuple(t for t, _ in banks),
                                            tuple(d for _, d in banks))
    out = K.vqc_shift_fidelity(spec, theta, data, groups=union, smem_budget=budget)
    row = {g: i for i, g in enumerate(union)}
    for (t, d), gs, (off, b) in zip(banks, group_sets, segments):
        per_bank = K.vqc_shift_fidelity(spec, t, d, groups=gs, smem_budget=budget)
        assert torch.equal(out[[row[g] for g in gs], off : off + b], per_bank)


def test_unfit_shapes_raise_instead_of_running(cuda):
    wide = circuits.build_quclassi_circuit(13, 3)  # m = 6
    th, dt = _angles(wide, 8, cuda)
    with pytest.raises(NotImplementedError, match="shared-memory budget"):
        K.vqc_shift_fidelity(wide, th, dt, smem_budget=2 * K._state_bytes(6, 1))
    # rows of 15 or more qubits run on the device-memory route, up to the
    # widest state the card holds; one qubit more raises, naming that width
    limit = K.dmem_max_qubits(cuda)
    widest = dataclasses.replace(circuits.build_quclassi_circuit(5, 1), n_qubits=limit + 1)
    th, dt = _angles(widest, 2, cuda)
    before = dict(K.LAUNCHES)
    with pytest.raises(NotImplementedError, match=f"up to {limit} qubits"):
        K.vqc_p0(widest, th, dt)
    with pytest.raises(NotImplementedError, match=f"up to {limit} qubits"):
        K.vqc_state(widest, th, dt)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("qc,c", [(15, 256), (17, 64)])
def test_device_memory_route_matches_plain(cuda, qc, c):
    """Rows of 15 and 17 qubits (no block holds one state) on the
    device-memory kernels, one launch each, against the plain version."""
    spec = circuits.build_quclassi_circuit(qc, 1)
    assert K.fused_geometry(qc, c) == (0, 0)
    th, dt = _angles(spec, c, cuda, seed=qc)
    before = dict(K.LAUNCHES)
    p0 = K.vqc_p0(spec, th, dt)
    re, im = K.vqc_state(spec, th, dt)
    assert K.LAUNCHES["fidelity_dmem"] == before["fidelity_dmem"] + 1
    assert K.LAUNCHES["state_dmem"] == before["state_dmem"] + 1
    assert K.LAUNCHES["fidelity"] == before["fidelity"]
    torch.testing.assert_close(p0, K._fused_plain(spec, th, dt, False), rtol=0, atol=ATOL)
    pre, pim = K._fused_plain(spec, th, dt, True)
    torch.testing.assert_close(re, pre, rtol=0, atol=ATOL)
    torch.testing.assert_close(im, pim, rtol=0, atol=ATOL)


def test_device_memory_route_chunks_its_workspace(cuda, monkeypatch):
    """A workspace of three 15-qubit states: 8 circuits run in 3 launches
    and give the bits of one launch."""
    spec = circuits.build_quclassi_circuit(15, 1)
    th, dt = _angles(spec, 8, cuda, seed=3)
    whole = K.vqc_p0(spec, th, dt)
    monkeypatch.setattr(K, "DMEM_WORKSPACE_BYTES", 3 * K._state_bytes(15, 1))
    before = K.LAUNCHES["fidelity_dmem"]
    chunked = K.vqc_p0(spec, th, dt)
    assert K.LAUNCHES["fidelity_dmem"] == before + 3
    assert torch.equal(chunked, whole)


def test_async_runtime_matches_sync_on_card(cuda):
    """The Fig-6 client mix through the sync and the async runtime (one
    CUDA stream per slot): bit-identical, and equal to direct launches."""
    from repro_torch.serve import GatewayRuntime

    banks = []
    for qc, nl in ((5, 1), (5, 2), (7, 1), (7, 2)):
        spec = circuits.build_quclassi_circuit(qc, nl)
        banks.append((spec, *_angles(spec, 300, cuda, seed=qc * nl)))
    got = {}
    for mode in ("sync", "async"):
        rt = GatewayRuntime(target=128, deadline=0.05, mode=mode, slots_per_worker=2)
        try:
            got[mode] = [rt.executor(spec, f"c{i}")(th, dt)
                         for i, (spec, th, dt) in enumerate(banks)]
            assert not getattr(rt.dispatcher, "errors", [])
        finally:
            rt.close()
    for (spec, th, dt), fs, fa in zip(banks, got["sync"], got["async"]):
        assert fa.is_cuda and torch.equal(fs, fa)
        assert torch.equal(fs, ops.vqc_fidelity(spec, th, dt))


def test_worker_pool_streams_on_card(cuda):
    """One thread and one CUDA stream per worker: the same bits as the
    sequential per-worker executor, for rows and an implicit bank."""
    from repro_torch.comanager import dataplane
    from repro_torch.core import shift_rule

    spec = circuits.build_quclassi_circuit(7, 2)
    th, dt = _angles(spec, 999, cuda, seed=4)
    rows = dataplane.round_robin_assignment(999, 4)
    pool = dataplane.worker_pool_executor(spec, rows, 4)
    try:
        assert torch.equal(pool(th, dt), dataplane.worker_batched_executor(spec, rows, 4)(th, dt))
    finally:
        pool.close()
    bank = shift_rule.build_shift_bank(th[0], dt[:300])
    groups = dataplane.round_robin_assignment(bank.n_groups, 4)
    pool = dataplane.worker_pool_executor(spec, groups, 4)
    try:
        assert torch.equal(pool(bank), dataplane.worker_batched_executor(spec, groups, 4)(bank))
    finally:
        pool.close()


def test_one_device_mesh_on_card(cuda):
    from repro_torch.comanager import dataplane
    from repro_torch.core import shift_rule
    from repro_torch.launch.mesh import make_data_mesh, make_host_mesh

    mesh = make_data_mesh(1)
    assert mesh.devices == (torch.device("cuda", 0),) and make_host_mesh() == mesh
    spec = circuits.build_quclassi_circuit(5, 1)
    th, dt = _angles(spec, 70, cuda)
    ex = dataplane.sharded_executor(spec, mesh)
    assert torch.equal(ex(th, dt), ops.vqc_fidelity(spec, th, dt))
    bank = shift_rule.build_shift_bank(th[0], dt[:9])
    mat = bank.materialize()
    torch.testing.assert_close(ex(bank), ops.vqc_fidelity(spec, mat.theta, mat.data),
                               rtol=0, atol=ATOL)


def test_training_step_on_card(cuda):
    cfg = quclassi.QuClassiConfig(qc=5, n_layers=1)
    x, y = mnist.make_pair_dataset(1, 5, n_per_class=8, seed=0)
    tr, te = mnist.train_test_split(x, y)
    before = K.LAUNCHES["shiftbank"]
    rep = trainer.train(cfg, tr, te, epochs=1, batch_size=4,
                        executor=ops.shiftbank_executor(cfg.spec), device=cuda)
    assert np.isfinite(rep.epochs[0].loss)
    assert K.LAUNCHES["shiftbank"] > before
    assert all(v.is_cuda for v in rep.params.values())


#: flash attention: float32 (summation order) and bfloat16 (one rounding of
#: the output), the reference's own tolerances
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(bh, s, hd, dtype, device, groups=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((n, s, hd), generator=g) * 0.5 for n in (bh, bh // groups, bh // groups))
    return tuple(t.to(device=device, dtype=dtype) for t in (q, k, v))


@pytest.mark.parametrize("hd", F.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0), (False, 48)])
@pytest.mark.parametrize("s", [128, 100])  # 100: the last tile is part full
def test_flash_kernel_matches_plain(cuda, hd, dtype, causal, window, s):
    q, k, v = _qkv(6, s, hd, dtype, cuda, groups=3, seed=hd + s)
    before = dict(F.LAUNCHES)
    got = F.flash_attention(q, k, v, causal=causal, window=window, groups=3)
    _assert_one_launch(before, dtype)
    assert got.dtype == dtype
    want = F._flash_plain(q, k, v, causal=causal, window=window, groups=3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=FLASH_ATOL[dtype])


def _assert_one_launch(before, dtype):
    """One launch, on the dtype's route (bf16: wgmma, float32: SIMT)."""
    route = F.ROUTES[dtype]
    assert F.LAUNCHES["flash"] == before["flash"] + 1
    assert F.LAUNCHES[route] == before[route] + 1
    assert all(F.LAUNCHES[r] == before[r] for r in F.ROUTES.values() if r != route)


@pytest.mark.parametrize("bh,s,hd,groups,causal,window", [
    (6, 2048, 64, 3, True, 0),      # the ring of K/V stages wraps many times
    (4, 2048, 128, 4, True, 0),
    (3, 2048, 32, 1, False, 0),
    (6, 2048, 64, 3, True, 65),     # windows that cross tile edges
    (4, 2048, 128, 4, True, 48),
    (6, 1, 64, 3, True, 0),         # one row: a box of 128 rows, 127 zero-filled
    (4, 1, 128, 4, False, 0),
    (6, 192, 64, 3, True, 0),       # 1.5 query tiles, 1.5 kv tiles of 128
    (8, 192, 128, 4, True, 48),
    (3, 192, 16, 1, True, 65),
    (6, 100, 64, 3, True, 65),      # ragged tile inside each of 6 heads
    (4, 100, 128, 4, False, 48),
    (2, 100, 32, 1, True, 48),
])
def test_flash_wgmma_pipeline_edges(cuda, bh, s, hd, groups, causal, window):
    q, k, v = _qkv(bh, s, hd, torch.bfloat16, cuda, groups=groups, seed=s + hd + window)
    before = dict(F.LAUNCHES)
    got = F.flash_attention(q, k, v, causal=causal, window=window, groups=groups)
    _assert_one_launch(before, torch.bfloat16)
    want = F._flash_plain(q, k, v, causal=causal, window=window, groups=groups)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=FLASH_ATOL[torch.bfloat16])


def test_flash_wgmma_rejects_unaligned_tensors(cuda):
    """TMA needs 16-byte aligned bases: a view one element into its
    storage raises before any launch."""
    q, k, v = _qkv(2, 64, 64, torch.bfloat16, cuda)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    before = dict(F.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        F.flash_attention(shifted, k, v)
    assert F.LAUNCHES == before


def test_flash_prefill_on_card_matches_naive(cuda):
    cfg = cfg_base.get("smollm-360m").reduced().with_(attention_impl="flash")
    model = transformer.Model(cfg, device=cuda)
    toks = multimodal.text_batch(cfg, 2, 96)
    before = dict(F.LAUNCHES)
    with torch.no_grad():
        flash, _ = model.prefill(toks)
        model.cfg = cfg.with_(attention_impl="naive")
        naive, _ = model.prefill(toks)
    assert F.LAUNCHES["flash"] == before["flash"] + cfg.n_layers
    assert F.LAUNCHES["flash_simt"] == before["flash_simt"] + cfg.n_layers
    torch.testing.assert_close(flash, naive, rtol=0, atol=1e-4)


def test_flash_prefill_on_card_matches_naive_bf16(cuda):
    """The reduced smollm-360m prefill in bf16, the dtype of the full model,
    through the wgmma kernel against the naive path.  The naive path rounds
    scores to bf16 and the flash path does not; on the CPU (plain version)
    the two differ by up to two bf16 steps of the logits after 2 layers.
    atol: four bf16 steps (8 significant bits) at the logits' largest
    magnitude."""
    cfg = cfg_base.get("smollm-360m").reduced().with_(attention_impl="flash", dtype="bfloat16")
    model = transformer.Model(cfg, device=cuda)
    toks = multimodal.text_batch(cfg, 2, 96)
    before = dict(F.LAUNCHES)
    with torch.no_grad():
        flash, _ = model.prefill(toks)
        model.cfg = cfg.with_(attention_impl="naive")
        naive, _ = model.prefill(toks)
    assert F.LAUNCHES["flash_wgmma"] == before["flash_wgmma"] + cfg.n_layers
    assert F.LAUNCHES["flash_simt"] == before["flash_simt"]
    assert flash.dtype == torch.bfloat16 and torch.isfinite(flash.float()).all()
    step = 2.0 ** (torch.floor(torch.log2(naive.float().abs().max())).item() - 7)
    torch.testing.assert_close(flash.float(), naive.float(), rtol=0, atol=4 * step)


# ------------------------------------------------ the public facade on card
def _facade():
    from repro_torch import api

    return api


def test_cluster_submit_drain_on_card(cuda):
    """Two tenants' sessions on one async cluster: every future resolves to
    a direct ``ops.vqc_fidelity`` of the same rows (chip_smoke phase 7a)."""
    api = _facade()
    spec = circuits.build_quclassi_circuit(7, 3)
    th, dt = _angles(spec, 24, cuda, seed=7)
    cfg = api.ClusterConfig(serving=api.ServingConfig(mode="async", slots_per_worker=2))
    with api.QuantumCluster(cfg, device="cuda") as cluster:
        alice = cluster.session("alice", api.TenantPolicy(priority=0, slo_ms=500.0, weight=2.0))
        bob = cluster.session("bob", api.TenantPolicy(priority=1))
        before = K.LAUNCHES["fidelity"]
        futs = []
        for i in range(0, 24, 2):
            futs.append(alice.submit(spec, th[i], dt[i]))
            futs.append(bob.submit(spec, th[i + 1], dt[i + 1]))
        alice.drain()
        got = torch.stack([f.result(timeout=60.0) for f in futs])
        assert K.LAUNCHES["fidelity"] > before
        assert alice.telemetry()["completed"] == bob.telemetry()["completed"] == 12
    torch.testing.assert_close(got, ops.vqc_fidelity(spec, th, dt), rtol=0, atol=ATOL)


def test_cluster_executors_on_card(cuda):
    """A materialized session's executor is the runtime's executor: equal
    bit for bit; the implicit session runs the shiftbank kernel and agrees
    within 1e-5 on fidelities (chip_smoke phase 7b)."""
    api = _facade()
    qcfg = quclassi.QuClassiConfig(qc=5, n_layers=1)
    params = quclassi.init_params(qcfg, torch.Generator().manual_seed(0), device=cuda)
    x, y = mnist.make_pair_dataset(3, 9, n_per_class=2, seed=0)
    x, y = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    with api.QuantumCluster(device="cuda") as cluster:
        mat = cluster.session("m", bank_mode="materialized")
        l_s, g_s, f_s = quclassi.grad_shift(qcfg, params, x, y, executor=mat.executor(qcfg.spec))
        l_r, g_r, _ = quclassi.grad_shift(qcfg, params, x, y,
                                          executor=cluster.runtime.executor(qcfg.spec, "legacy"))
        assert float(l_s) == float(l_r) and torch.equal(g_s["theta"], g_r["theta"])
        before = K.LAUNCHES["shiftbank"]
        imp = cluster.session("i", bank_mode="implicit")
        _, _, f_i = quclassi.grad_shift(qcfg, params, x, y, executor=imp.executor(qcfg.spec))
        assert K.LAUNCHES["shiftbank"] > before
    torch.testing.assert_close(f_i, f_s, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["batched", "pooled", "multibank", "sharded", "mesh_spill"])
def test_cluster_backends_on_card(cuda, kind):
    """``cluster.backend(kind)``: the worker backends equal the direct
    implicit route bit for bit; the one-device CUDA mesh backends agree
    with the materialized rows within 1e-5 (chip_smoke phase 7d)."""
    from repro_torch.core import shift_rule

    api = _facade()
    spec = circuits.build_quclassi_circuit(7, 3)
    th, dt = _angles(spec, 16, cuda, seed=11)
    bank = shift_rule.build_shift_bank(th[0], dt)
    cluster = api.QuantumCluster(device="cuda")
    be = cluster.backend(kind, spec)
    try:
        got = be.run_bank(bank)
    finally:
        be.close()
    assert got.device.type == "cuda"
    if kind in ("batched", "pooled", "multibank"):
        direct = ops.vqc_fidelity_shiftgroups(spec, bank.theta, bank.data, False).reshape(-1)
        assert torch.equal(got, direct)
    else:
        rows = bank.materialize()
        torch.testing.assert_close(got, ops.vqc_fidelity(spec, rows.theta, rows.data),
                                   rtol=0, atol=ATOL)
