"""The dense layer's gradient on the wide route (registers of m = 13-16
qubits, ``kernels/dense_grad.py``) on the CPU, where it takes the plain
version, through ``grad_shift`` with implicit banks on the data plane.

Held against the benchmark's plain reference, ``dqbench/ref_quclassi.py``
(float64 plain PyTorch, loaded by path; it takes the dense gradient by
autograd on the two 2**m-amplitude registers).  The JAX package cannot
serve here: at these widths it takes the gradient through its dense
simulator, 2**qc amplitudes a sample.

Tolerance.  The program's float32 class scores, chain weights and dF/dx
each carry a relative error of about 1e-6 here (sums of 2**13-2**16
products).  The loss's chain weight g(f) = (f - y) / (f (1 - f)) carries
the score's relative error times |d ln g / d ln f| = max(1, f / (1 - f)),
which stays 1 for the scores far below 1 - eps that these widths give.
So w and b are held to RTOL of the largest element, times that factor.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import obs
from repro_torch.comanager import dataplane as dp
from repro_torch.core import fidelity as tfid
from repro_torch.core import quclassi as q
from repro_torch.data import mnist
from repro_torch.kernels import dense_grad

REF = Path(__file__).resolve().parents[1] / "dqbench" / "ref_quclassi.py"
RTOL = 1e-4
WORKERS = 2


def _reference():
    name = "dqbench_ref_quclassi"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, REF)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def _setup(qc, nl, n_images, seed=0, near=False):
    """QuClassi ``qc``-``nl`` with the dense layer, seeded parameters and
    ``n_images`` digits.  ``near``: theta in [0, 0.5] and b = -1.2 (angles
    about 0.7), so that with one layer the class scores (0.02-0.03 at m =
    13-16) stay inside the loss's [eps, 1 - eps]; a seeded theta scores
    them under eps there, where every chain weight is zero."""
    cfg = q.QuClassiConfig(qc=qc, n_layers=nl)
    g = torch.Generator().manual_seed(seed)
    params = q.init_params(cfg, g)
    if near:
        params["theta"] = torch.rand(params["theta"].shape, generator=g) * 0.5
        params["w"] = params["w"] * 0.5
        params["b"] = torch.full_like(params["b"], -1.2)
    x, y = mnist.make_pair_dataset(1, 5, n_per_class=1, seed=seed)
    return cfg, params, torch.as_tensor(x[:n_images]), torch.as_tensor(y[:n_images])


def _grad(cfg, params, images, labels):
    run = dp.worker_batched_executor(
        cfg.spec, dp.round_robin_assignment(1 + 2 * cfg.n_theta, WORKERS), WORKERS)
    return q.grad_shift(cfg, params, images, labels, executor=run, implicit=True)


def _assert_matches_reference(cfg, params, images, labels, grads, fids):
    ref = _reference()
    model = ref.Model(qc=cfg.qc, n_layers=cfg.n_layers, n_classes=cfg.n_classes,
                      filter_width=cfg.seg.filter_width, stride=cfg.seg.stride,
                      image_size=cfg.image_size, use_dense=True)
    _, want = ref.gradient(model, params, images, labels, ref.Precision(torch.float64))
    f = fids.double()
    assert ((f >= tfid._EPS) & (f <= 1 - tfid._EPS)).all(), f
    kappa = max(1.0, float((f / (1 - f)).max()))
    for k in ("w", "b"):
        tol = RTOL * kappa * float(want[k].abs().max())
        torch.testing.assert_close(grads[k].double(), want[k], rtol=0, atol=tol)


@pytest.mark.parametrize("qc,nl,n_images,near", [(27, 3, 2, False), (33, 1, 1, True)])
def test_wide_route_matches_the_plain_reference(qc, nl, n_images, near):
    """27q-3l (m = 13) on two images and 33q-1l (m = 16) on one: the wide
    route's w and b against the reference's float64 autograd."""
    cfg, params, images, labels = _setup(qc, nl, n_images, near=near)
    plan = dense_grad.route_plan(cfg.qc, cfg.n_layers, cfg.n_classes, cfg.patch_dim)
    assert plan.wide and plan.m == (qc - 1) // 2
    _, grads, fids = _grad(cfg, params, images, labels)
    _assert_matches_reference(cfg, params, images, labels, grads, fids)


@pytest.mark.parametrize("qc,nl", [(5, 1), (7, 3)])
def test_wide_route_forced_gives_the_register_routes_w_and_b(qc, nl, monkeypatch):
    """The wide plan forced onto m = 2 and 3: ``grad_shift`` records the
    "wide" route and gives the register route's w and b (the same plain
    version on the CPU; the card's test holds the two kernels together)."""
    cfg, params, images, labels = _setup(qc, nl, 2)
    plan = dense_grad.route_plan(cfg.qc, cfg.n_layers, cfg.n_classes, cfg.patch_dim)
    assert not plan.wide
    _, want, _ = _grad(cfg, params, images, labels)
    monkeypatch.setattr(dense_grad, "route_plan",
                        lambda *a: dataclasses.replace(plan, wide=True))
    rec = obs.TraceRecorder()
    prev = obs.set_recorder(rec)
    try:
        _, got, _ = _grad(cfg, params, images, labels)
    finally:
        obs.set_recorder(prev)
    (dense,) = [s for s in rec.buffer.records(obs.HostSpan) if s.name == "grad_shift.dense"]
    assert dense.args == {"route": "wide"}
    for k in ("w", "b"):
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=1e-6 * float(want[k].abs().max()))


def test_27q_step_with_the_dense_layer_never_runs_the_simulator(monkeypatch):
    """One whole ``grad_shift`` step of 27q-1l with the dense layer, the
    dense simulator's two entry points made to raise: every gradient is
    finite and w and b match the reference."""
    def refuse(*a, **k):
        raise AssertionError("the 2**27-amplitude simulator was called")

    monkeypatch.setattr(q, "_dense_grad_simulator", refuse)
    monkeypatch.setattr(q, "class_fidelities", refuse)
    cfg, params, images, labels = _setup(27, 1, 2, near=True)
    loss, grads, fids = _grad(cfg, params, images, labels)
    assert set(grads) == {"theta", "w", "b"}
    assert grads["w"].shape == (cfg.patch_dim, cfg.n_angles) and grads["b"].shape == (26,)
    assert torch.isfinite(loss) and all(torch.isfinite(v).all() for v in grads.values())
    _assert_matches_reference(cfg, params, images, labels, grads, fids)
