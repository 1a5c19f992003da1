"""Port parity for the core modules: gates, dense simulator, fidelity/BCE,
encoding, segmentation, shift-rule gradient assembly, QuClassi gradients,
optimizers and the data pipeline.

Inputs are made from a seed with numpy and go through both packages.
Fidelities and states agree to 1e-5 (float32 rounding).  Gradients go
through BCE's chain factor c = (f - y) / (f (1 - f)) (``fidelity.py``),
which multiplies fidelity noise: the gradient tolerances here are scaled by
it, atol = 1e-5 * (c_max + c_max**2) with c_max the largest |c| of the
reference's own fidelities (first-order error of c * dF + dF * dc/df).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import quclassi_paper as jconfigs
from repro.core import circuits as jcircuits
from repro.core import encoding as jenc
from repro.core import fidelity as jfid
from repro.core import gates as jgates
from repro.core import quclassi as jq
from repro.core import segmentation as jseg
from repro.core import shift_rule as jsr
from repro.core import sim as jsim
from repro.data import mnist as jmnist
from repro.data import pipeline as jpipe
from repro.optim import optimizers as jopt
from repro_torch.api import capabilities as tcap
from repro_torch.configs import quclassi_paper as tconfigs
from repro_torch.core import circuits as tcircuits
from repro_torch.core import encoding as tenc
from repro_torch.core import fidelity as tfid
from repro_torch.core import gates as tgates
from repro_torch.core import quclassi as tq
from repro_torch.core import segmentation as tseg
from repro_torch.core import shift_rule as tsr
from repro_torch.core import sim as tsim
from repro_torch.data import mnist as tmnist
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import optimizers as topt

ATOL = 1e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(jgates.GATES))
def test_gate_matrices_match_reference(name):
    jctor, k, takes = jgates.GATES[name]
    tctor, tk, ttakes = tgates.GATES[name]
    assert (k, takes) == (tk, ttakes)
    angles = np.array([-2.3, 0.0, 0.7, 3.1], np.float32) if takes else [None]
    for a in angles:
        jm = jctor(jnp.float32(a)) if takes else jctor()
        tm = tctor(torch.tensor(a)) if takes else tctor()
        _close(tm[0], jm[0], 1e-6)
        _close(tm[1], jm[1], 1e-6)
    if takes:  # batched angles -> one matrix per angle, batch axes leading
        tb = tctor(torch.from_numpy(angles))
        for i, a in enumerate(angles):
            _close(tb[0][i], jctor(jnp.float32(a))[0], 1e-6)


def test_run_circuit_and_marginal_match_reference():
    rng = np.random.default_rng(0)
    js = jcircuits.build_quclassi_circuit(5, 3)
    ts = tcircuits.build_quclassi_circuit(5, 3)
    theta = rng.uniform(-3, 3, ts.n_theta).astype(np.float32)
    data = rng.uniform(0, 3, ts.n_data).astype(np.float32)
    jst = jsim.run_circuit(js, jnp.asarray(theta), jnp.asarray(data))
    tst = tsim.run_circuit(ts, torch.from_numpy(theta), torch.from_numpy(data))
    _close(tst[0], jst[0])
    _close(tst[1], jst[1])
    for q in range(5):
        _close(tsim.marginal_p0(tst, q, 5), jsim.marginal_p0(jst, q, 5))
    _close(tsim.state_norm(tst), 1.0)


def test_apply_gate_arbitrary_qubits_matches_reference():
    rng = np.random.default_rng(1)
    re = rng.normal(size=(3, 16)).astype(np.float32)
    im = rng.normal(size=(3, 16)).astype(np.float32)
    for gate, qubits in (("ryy", (3, 1)), ("cswap", (2, 0, 3)), ("crz", (0, 2))):
        ju = jgates.GATES[gate][0](*([jnp.float32(0.9)] if gate != "cswap" else []))
        tu = tgates.GATES[gate][0](*([torch.tensor(0.9)] if gate != "cswap" else []))
        jo = jsim.apply_gate((jnp.asarray(re), jnp.asarray(im)), ju, qubits, 4)
        to = tsim.apply_gate((torch.from_numpy(re), torch.from_numpy(im)), tu, qubits, 4)
        _close(to[0], jo[0])
        _close(to[1], jo[1])


def test_bce_and_chain_match_reference():
    f = np.array([0.0, 1e-9, 0.2, 0.5, 0.93, 1.0], np.float32)
    y = np.array([1, 0, 1, 0, 1, 0], np.float32)
    _close(tfid.bce_loss(torch.from_numpy(f), torch.from_numpy(y)),
           jfid.bce_loss(jnp.asarray(f), jnp.asarray(y)), 1e-4)
    np.testing.assert_allclose(
        _np(tfid.bce_grad_wrt_fidelity(torch.from_numpy(f), torch.from_numpy(y))),
        np.asarray(jfid.bce_grad_wrt_fidelity(jnp.asarray(f), jnp.asarray(y))), rtol=1e-6)


def test_encodings_match_reference():
    rng = np.random.default_rng(2)
    for p, n in ((6, 6), (16, 6), (4, 6)):
        patch = rng.uniform(0, 1, (3, 2, p)).astype(np.float32)
        _close(tenc.rotation_angles(torch.from_numpy(patch), n),
               jenc.rotation_angles(jnp.asarray(patch), n), 1e-6)
    vals = rng.normal(size=(4, 8)).astype(np.float32)
    vals[1] = 0.0  # the all-zero patch falls back to |0...0>
    tre, tim = tenc.amplitude_encoding(torch.from_numpy(vals))
    jre, jim = jenc.amplitude_encoding(jnp.asarray(vals))
    _close(tre, jre, 1e-6)
    _close(tim, jim, 0)
    with pytest.raises(ValueError):
        tenc.amplitude_encoding(torch.zeros(3))
    a = torch.tensor([0.5, 1.5])
    _close(tenc.angles_to_unit_interval(a), jenc.angles_to_unit_interval(jnp.asarray(a.numpy())))


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_segmentation_matches_reference(hw):
    cfg_j, cfg_t = jseg.SegmentationConfig(), tseg.SegmentationConfig()
    img = np.random.default_rng(3).uniform(0, 1, (2,) + hw).astype(np.float32)
    _close(tseg.segment(torch.from_numpy(img), cfg_t), jseg.segment(jnp.asarray(img), cfg_j), 0)
    assert tseg.n_patches(*hw, cfg_t) == jseg.n_patches(*hw, cfg_j)
    assert np.array_equal(tseg.reassemble_coverage(*hw, cfg_t),
                          jseg.reassemble_coverage(*hw, cfg_j))
    assert tseg.subtasks_per_image(*hw, cfg_t) == jseg.subtasks_per_image(*hw, cfg_j)


@pytest.mark.parametrize("qc,nl,four", [(5, 1, False), (5, 3, True), (7, 3, True)])
def test_assemble_gradient_matches_reference(qc, nl, four):
    js = jcircuits.build_quclassi_circuit(qc, nl)
    ts = tcircuits.build_quclassi_circuit(qc, nl)
    rng = np.random.default_rng(qc + nl)
    b = 5
    theta = rng.uniform(0, np.pi, ts.n_theta).astype(np.float32)
    data = rng.uniform(0, np.pi, (b, ts.n_data)).astype(np.float32)
    labels = rng.integers(0, 2, b).astype(np.float32)
    n = (1 + (4 if four else 2) * ts.n_theta) * b
    fids = rng.uniform(0.05, 0.95, n).astype(np.float32)
    jbank = jsr.build_bank(jnp.asarray(theta), jnp.asarray(data), four)
    tbank = tsr.build_bank(torch.from_numpy(theta), torch.from_numpy(data), four)
    _close(tbank.theta, jbank.theta, 0)
    jl, jg, jf = jsr.assemble_gradient(js, jbank, jnp.asarray(fids), jnp.asarray(labels))
    tl, tg, tf = tsr.assemble_gradient(ts, tbank, torch.from_numpy(fids),
                                       torch.from_numpy(labels))
    _close(tl, jl, 1e-6)
    _close(tg, jg, 1e-5)
    _close(tf, jf, 0)
    assert tsr.group_descriptors(ts.n_theta, four) == jsr.group_descriptors(js.n_theta, four)
    assert tsr.controlled_param_indices(ts) == jsr.controlled_param_indices(js)


@pytest.mark.parametrize("nl", [1, 2])
def test_shift_rule_equals_autodiff_on_exact_layers(nl):
    ts = tcircuits.build_quclassi_circuit(5, nl)
    rng = np.random.default_rng(nl)
    theta = torch.tensor(rng.uniform(0, np.pi, ts.n_theta), dtype=torch.float32)
    data = torch.tensor(rng.uniform(0, np.pi, (6, ts.n_data)), dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 2, 6), dtype=torch.float32)
    l1, g1, f1 = tsr.parameter_shift_grad(ts, theta, data, labels)
    l2, g2, f2 = tsr.autodiff_grad(ts, theta, data, labels)
    _close(f1, f2)
    _close(l1, l2)
    chain = tfid.bce_grad_wrt_fidelity(f2, labels).abs().max().item()
    _close(g1, g2, ATOL * (chain + chain**2))


def _quclassi_setup(qc, nl, seed=0):
    jcfg, tcfg = jq.QuClassiConfig(qc=qc, n_layers=nl), tq.QuClassiConfig(qc=qc, n_layers=nl)
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = tq.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    x, y = jmnist.make_pair_dataset(3, 8, 3, seed=seed)
    return jcfg, tcfg, jparams, tparams, x, y


def _grad_tol(jf, y):
    f = np.clip(np.asarray(jf), 1e-7, 1 - 1e-7)
    onehot = np.eye(f.shape[1])[y]
    c = np.abs((f - onehot) / (f * (1 - f))).max()
    return ATOL * (c + c**2)


@pytest.mark.parametrize("qc,nl", [(5, 2)])
def test_quclassi_gradients_match_reference(qc, nl):
    jcfg, tcfg, jparams, tparams, x, y = _quclassi_setup(qc, nl)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jf = jq.class_fidelities(jcfg, jparams, jx)
    _close(tq.class_fidelities(tcfg, tparams, tx), jf)
    tol = _grad_tol(jf, y)
    for jfn, tfn in ((jq.grad_autodiff, tq.grad_autodiff), (jq.grad_shift, tq.grad_shift)):
        jl, jg, _ = jfn(jcfg, jparams, jx, jy)
        tl, tg, _ = tfn(tcfg, tparams, tx, ty)
        _close(tl, jl)
        assert set(tg) == set(jg)
        for k in jg:
            _close(tg[k], jg[k], tol)
    assert tq.total_bank_circuits(tcfg, 4) == jq.total_bank_circuits(jcfg, 4)
    _close(tq.accuracy(tcfg, tparams, tx, ty), jq.accuracy(jcfg, jparams, jx, jy), 0)


def _clamped_batch(qc, nl):
    """Two images whose class-0 score puts image 0 under the loss's eps:
    its patches encode x0 = pi / 2 (z = 0) and x_j ~ 0 (z = -40), against a
    class-0 register whose qubit 0 is 6.3e-5 off orthogonal to that angle
    (F ~ 1e-9; the dense simulator reads 0).  Image 1 scores in range."""
    cfg = tq.QuClassiConfig(qc=qc, n_layers=nl)
    params = tq.init_params(cfg, torch.Generator().manual_seed(1))
    params["theta"][0] = 0.0
    params["theta"][0, :2] = torch.tensor([np.pi / 2 - 6.3e-5, np.pi / 2])
    params["w"] = torch.zeros_like(params["w"])
    params["w"][:, 0] = 1.0
    params["b"] = torch.full_like(params["b"], -40.0)
    params["b"][0] = 0.0
    x = np.zeros((2, 8, 8), np.float32)
    x[1] = np.random.default_rng(0).uniform(0, 1, (8, 8))
    return cfg, params, x, np.zeros(2, np.int64)


@pytest.mark.parametrize("batch", ["digits", "clamped"])
@pytest.mark.parametrize("qc,nl", [(5, 1), (5, 2), (5, 3), (7, 1), (7, 2), (7, 3)])
def test_dense_register_route_matches_autograd_and_reference(qc, nl, batch):
    """``grad_shift``'s dense gradient on the register route (the plain
    version on the CPU) against autograd through the dense simulator and
    against the reference's ``jax.grad``, at the chain-scaled tolerance
    (its c over the scores the loss's clamp leaves inside [eps, 1 - eps]).
    The clamped batch holds an image scored under eps: its weight is
    zero, as autograd's is, where the unmasked BCE weight would move the
    gradient by far more than the tolerance."""
    from repro_torch.kernels import dense_grad

    if batch == "digits":
        _, tcfg, _, tparams, x, y = _quclassi_setup(qc, nl)
    else:
        tcfg, tparams, x, y = _clamped_batch(qc, nl)
    plan = dense_grad.route_plan(tcfg.qc, tcfg.n_layers, tcfg.n_classes, tcfg.patch_dim)
    assert plan is not None and plan.m == (qc - 1) // 2
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    _, got, f = tq.grad_shift(tcfg, tparams, tx, ty)
    _, auto, _ = tq.grad_autodiff(tcfg, tparams, tx, ty)
    jcfg = jq.QuClassiConfig(qc=qc, n_layers=nl)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in tparams.items()}
    _, ref, jf = jq.grad_shift(jcfg, jparams, jnp.asarray(x), jnp.asarray(y))
    fn = np.asarray(jf)
    inside = (fn >= tfid._EPS) & (fn <= 1 - tfid._EPS)
    fc = np.clip(fn, tfid._EPS, 1 - tfid._EPS)
    c = np.abs((fc - np.eye(2)[y]) / (fc * (1 - fc)))[inside].max()
    tol = ATOL * (c + c**2)
    for k in ("w", "b"):
        _close(got[k], auto[k], tol)
        _close(got[k], ref[k], tol)
    if batch == "clamped":
        assert f[0, 0] < tfid._EPS and not inside[0, 0] and inside[1:].all()
        onehot = torch.nn.functional.one_hot(ty, 2).to(torch.float32)
        unmasked = tfid.bce_grad_wrt_fidelity(f, onehot) / (f.numel() * tcfg.n_patches)
        angles, patches = tq.encode_images(tcfg, tparams, tx)
        partials = dense_grad.register_partials(plan, tparams["theta"], angles, patches,
                                                unmasked, tcfg.n_patches)
        _, db = dense_grad.reduce_partials(partials, tcfg.patch_dim, tcfg.n_angles)
        assert (db - auto["b"]).abs().max() > 100 * tol


@pytest.mark.parametrize("qc,route", [(5, "register"), (7, "register"), (25, "register"),
                                      (27, "simulator"), (33, "simulator")])
def test_dense_gradient_route_follows_the_register_width(qc, route):
    """The register route up to m = 12 (psi of 2**12 amplitudes a class in a
    block's shared memory); from m = 13 the dense simulator's autograd."""
    from repro_torch.kernels import dense_grad

    cfg = tq.QuClassiConfig(qc=qc, n_layers=3)
    plan = dense_grad.route_plan(cfg.qc, cfg.n_layers, cfg.n_classes, cfg.patch_dim)
    assert ("simulator" if plan is None else "register") == route


@pytest.mark.parametrize("where", ["theta", "score"])
def test_dense_register_route_carries_nan_as_autograd_does(where):
    """A NaN stays visible in w and b on the register route, as autograd
    through the dense simulator shows it: a NaN theta (every fidelity
    NaN) and a NaN class score (its chain weight NaN) are neither masked
    as F > 1 nor as outside the loss's [eps, 1 - eps]."""
    from repro_torch.kernels import dense_grad

    _, tcfg, _, tparams, x, y = _quclassi_setup(5, 1)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    onehot = torch.nn.functional.one_hot(ty.long(), 2).to(torch.float32)
    plan = dense_grad.route_plan(tcfg.qc, tcfg.n_layers, tcfg.n_classes, tcfg.patch_dim)
    angles, patches = tq.encode_images(tcfg, tparams, tx)
    if where == "theta":
        tparams = dict(tparams, theta=tparams["theta"].clone())
        tparams["theta"][0, 0] = float("nan")
        _, auto, _ = tq.grad_autodiff(tcfg, tparams, tx, ty)
        assert torch.isnan(auto["b"]).all()
    f = tq.class_fidelities(tcfg, tparams, tx)
    if where == "score":
        f[0, 1] = float("nan")
    weights = tq.dense_chain_weights(f, onehot, tcfg.n_patches)
    nan = torch.isnan(weights)
    assert nan[:, 0].all() if where == "theta" else nan[0, 1] and nan.sum() == 1
    gw, gb = dense_grad.reduce_partials(dense_grad.register_partials(
        plan, tparams["theta"], angles, patches, weights, tcfg.n_patches),
        tcfg.patch_dim, tcfg.n_angles)
    assert torch.isnan(gb).all() and torch.isnan(gw).any()


def test_default_init_is_seeded():
    cfg = tq.QuClassiConfig(qc=7, n_layers=3)
    a = tq.init_params(cfg, torch.Generator().manual_seed(3))
    b = tq.init_params(cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["theta"].shape == (2, 14) and a["w"].shape == (16, 6) and a["b"].shape == (6,)
    assert 0.0 <= a["theta"].min() and a["theta"].max() <= np.pi


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_optimizers_match_reference(name):
    rng = np.random.default_rng(4)
    params = {"theta": rng.normal(size=(2, 3)).astype(np.float32),
              "w": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    jo, to = jopt.make(name, 1e-2), topt.make(name, 1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    for k in params:
        _close(tp[k], jp[k], 1e-6)
    jc, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads[0].items()}, 0.5)
    tc, tn = topt.clip_by_global_norm({k: torch.from_numpy(v) for k, v in grads[0].items()}, 0.5)
    _close(tn, jn, 1e-5)
    for k in params:
        _close(tc[k], jc[k], 1e-6)


def test_data_pipeline_and_configs_match_reference():
    jx, jy = jmnist.make_pair_dataset(1, 5, 20, seed=1)
    tx, ty = tmnist.make_pair_dataset(1, 5, 20, seed=1)
    assert np.array_equal(jx, tx) and np.array_equal(jy, ty)
    assert np.array_equal(jpipe.clean(jx), tpipe.clean(tx))
    for (a, b), (c, d) in zip(jpipe.batches(jx, jy, 8, seed=5), tpipe.batches(tx, ty, 8, seed=5)):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    for name, jc in jconfigs.QUCLASSI_CONFIGS.items():
        tc = tconfigs.get_quclassi(name)
        assert (tc.qc, tc.n_layers, tc.n_classes, tc.image_size, tc.use_dense) == (
            jc.qc, jc.n_layers, jc.n_classes, jc.image_size, jc.use_dense)
        assert (tc.n_theta, tc.n_angles, tc.patch_dim, tc.n_patches) == (
            jc.n_theta, jc.n_angles, jc.patch_dim, jc.n_patches)


def test_capabilities_declare_and_shim():
    fn = tcap.declare(lambda *a: None, shiftbank=True)
    assert tcap.capabilities_of(fn).shiftbank and not tcap.capabilities_of(fn).multibank

    def legacy(*a):
        return None

    legacy.accepts_bankset = True
    assert tcap.capabilities_of(legacy).multibank
